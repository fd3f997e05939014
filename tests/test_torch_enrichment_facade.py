"""The enrichment facade of the port against the JAX facade: the binary
(hypergeometric) ``run_pipeline``, the stages ``define_neighborhoods`` and
``compute_pvalues``, ``background='network'``, the dense euclidean metric
and FDR, on the same network and attributes carried across with
``from_numpy_state``.

Tolerances: neighborhoods, ``nes_binary`` and the enriched counts exactly
equal; permutation counts exactly equal where both sides get the same
permutations (integer-valued attributes: exact f32 sums; the JAX facade
takes no indices, so its side is composed from its own neighborhoods and
scores); hypergeometric p-values within 1e-6 of scipy, and of JAX's within
1e-9 where they are finalized in f64 (the staged path), within 1e-9 plus 4
f32 ulps of the stored log-survival where the fused path stores it in f32
(``tests/test_torch_hypergeom.py`` says why 4); NES within 4 f32 ulps.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial import cKDTree
from scipy.stats import hypergeom as scipy_hypergeom

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu.ops import fdr as jfdr
from safepy_tpu.ops import permutation as jperm
from safepy_tpu_torch.state import ENRICHMENT_SETTINGS, from_numpy_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_NODES, N_ATTRS = 320, 48
F32_ULP = 2.0 ** -23


def _graph(n=N_NODES, k=8, seed=3):
    """kNN geometric graph with the node attributes the JAX loaders expect,
    and its coordinates."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from({(min(i, int(j)), max(i, int(j)))
                      for i in range(n) for j in nn[i, 1:]})
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    return g, coords


@pytest.fixture(scope="module")
def net():
    return _graph()


def _go_matrix(coords, a=N_ATTRS, seed=5, nan_share=0.1):
    """Binary terms of members drawn near random centres (as
    examples/example_2_go_annotations.py:17-24 draws them), so that domains
    of enrichment exist; unannotated rows NaN."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        out[:, j] = (near & (rng.random(n) < 0.6)) | (rng.random(n) < 0.03)
    out[rng.random(n) < nan_share] = np.nan
    return out


def _integers(n, seed=4, a=2, nan_share=0.3):
    """Integer-valued quantitative attributes: f32 sums exact."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, (n, a)).astype(float)
    vals[rng.random(n) < nan_share] = np.nan
    return vals


def _frame(vals):
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(len(vals))])


def _jax(net, vals, **settings):
    g, _ = net
    jsf = JaxSAFE(verbose=False)
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=_frame(vals))
    return jsf


def _port(jsf, **settings):
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius,
        random_seed=jsf.random_seed, device="cpu",
        **{k: getattr(jsf, k) for k in ENRICHMENT_SETTINGS})
    for k, v in settings.items():
        setattr(psf, k, v)
    return psf


def _census(nbr, n2a):
    """(k, K, n) of every cell, the reference's census (safe.py:556-596)."""
    finite = np.isfinite(n2a)
    nbr = np.asarray(nbr, np.float64)
    k = nbr @ np.where(finite, n2a, 0.0)
    n = nbr @ finite.any(axis=1).astype(float)
    return k, np.nansum(n2a, axis=0)[None, :], n[:, None], int(
        finite.any(axis=1).sum())


def _assert_binary_equal(psf, jsf, fused, scipy_check=True):
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    np.testing.assert_array_equal(
        psf.attributes["num_neighborhoods_enriched"],
        jsf.attributes["num_neighborhoods_enriched"])
    p, pj = psf.pvalues_pos, jsf.pvalues_pos
    tol = 1e-9 + (4 * F32_ULP * pj * np.abs(np.log(np.maximum(pj, 1e-300)))
                  if fused else 0.0)
    assert np.all(np.abs(p - pj) <= tol)
    nes, nj = psf.nes, jsf.nes
    np.testing.assert_array_equal(np.isinf(nes), np.isinf(nj))
    fin = np.isfinite(nj)
    assert np.all(np.abs(nes[fin] - nj[fin])
                  <= 4 * F32_ULP * np.abs(nj[fin]) + 1e-12)
    if scipy_check:
        k, K, n, M = _census(jsf.neighborhoods, jsf.node2attribute)
        assert np.max(np.abs(p - scipy_hypergeom.sf(k - 1, M, K, n))) <= 1e-6


@pytest.mark.parametrize("engine,fdr,mode", [
    ("auto", False, "auto"), ("loop", False, "auto"), ("auto", True, "auto"),
    ("loop", True, "auto"), ("auto", False, "full"), ("loop", True, "full")])
def test_binary_run_pipeline_matches_jax(net, engine, fdr, mode):
    """'auto' takes the class table at this size, 'loop' the f64 tail loop;
    FDR adjusts the log-survival on the device; over the banded window
    ('auto') and the dense FW ('full')."""
    vals = _go_matrix(net[1])
    jsf = _jax(net, vals, hypergeom_engine=engine, apsp_mode=mode)
    jsf.run_pipeline(multiple_testing=fdr)
    psf = _port(jsf, apsp_mode=mode)
    psf.run_pipeline()
    want = "table-dense-fused" if engine == "auto" else "loop-dense-fused"
    assert jsf._hypergeom_engine_used == psf._hypergeom_engine_used == want
    assert psf.apsp_engine_used == ("banded-window" if mode == "auto"
                                    else "dense")
    _assert_binary_equal(psf, jsf, fused=True, scipy_check=not fdr)
    if fdr:  # the fused FDR is the log-space BH of the unadjusted run's
        raw = _port(jsf, apsp_mode=mode, multiple_testing=False)
        raw.run_pipeline()
        adj, nbin, counts = jfdr.fdr_bh_logsf_np(
            raw._logsf_dev.numpy(), np.log(0.05))
        np.testing.assert_array_equal(psf.nes_binary, nbin)
        np.testing.assert_array_equal(
            psf.attributes["num_neighborhoods_enriched"], counts)


@pytest.mark.parametrize("fdr", [False, True])
def test_staged_binary_matches_jax_and_the_fused_run(net, fdr):
    """define_neighborhoods + compute_pvalues: the host-finalized tail loop
    bounded by the largest neighborhood, linear FDR; the same
    neighborhoods and indicator as the port's fused run."""
    vals = _go_matrix(net[1], seed=6)
    jsf = _jax(net, vals, multiple_testing=fdr)
    jsf.define_neighborhoods()
    jsf.compute_pvalues()
    psf = _port(jsf)
    psf.define_neighborhoods()
    psf.compute_pvalues()
    assert psf._hypergeom_engine_used == "loop-dense-staged"
    _assert_binary_equal(psf, jsf, fused=False, scipy_check=not fdr)
    fused = _port(jsf)
    fused.run_pipeline()
    np.testing.assert_array_equal(fused.neighborhoods, psf.neighborhoods)
    if not fdr:
        np.testing.assert_array_equal(fused.nes_binary, psf.nes_binary)
        assert np.max(np.abs(fused.pvalues_pos - psf.pvalues_pos)) <= 1e-6


def _jax_counts(jsf, perm_idx):
    """The JAX side of a null with injected permutations: its
    prepare_valid + permutation_scores on its own neighborhoods and
    observed scores (tests/test_torch_pipeline.py:136)."""
    n2a = jsf.node2attribute
    valid_rows = np.flatnonzero(np.isfinite(n2a).any(axis=1))
    nv, v, m = jperm.prepare_valid(jnp.asarray(jsf.neighborhoods, jnp.float32),
                                   jnp.asarray(n2a, jnp.float32), valid_rows)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))
    return (scores <= jsf.ns[None]).sum(0), (scores >= jsf.ns[None]).sum(0)


def _perm_idx(vals, count=40, seed=9):
    v = int(np.isfinite(vals).any(axis=1).sum())
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(v) for _ in range(count)])


@pytest.mark.parametrize("mode", ["auto", "band"])
def test_staged_quantitative_matches_jax(net, mode):
    """The permutation null of the stages, over the banded window and over
    band storage (``_randomization_bandstore``), with injected
    permutations."""
    vals = _integers(N_NODES)
    jsf = _jax(net, vals, apsp_mode=mode, random_seed=3)
    jsf.define_neighborhoods()
    jsf.compute_pvalues(num_permutations=50)
    psf = _port(jsf, apsp_mode=mode)
    psf.define_neighborhoods()
    assert psf.apsp_engine_used == ("band-storage" if mode == "band"
                                    else "banded-window")
    perm_idx = _perm_idx(vals)
    psf.compute_pvalues(perm_idx=perm_idx)
    assert psf.num_permutations == len(perm_idx)
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(psf.ns, jsf.ns)
    cn, cp = _jax_counts(jsf, perm_idx)
    np.testing.assert_array_equal(psf.counts_neg, cn)
    np.testing.assert_array_equal(psf.counts_pos, cp)
    # the finalization is JAX's on the same counts
    jsf.num_permutations = len(perm_idx)
    jsf._finalize_randomization(cn, cp, jsf.ns)
    np.testing.assert_array_equal(psf.pvalues_pos, jsf.pvalues_pos)
    np.testing.assert_array_equal(psf.nes, jsf.nes)


@pytest.mark.parametrize("attrs", ["quantitative", "binary"])
def test_quantitative_fdr_and_binary_background_network(net, attrs):
    """background='network' takes the stages (NaN -> 0 first) in both
    packages; FDR on the permutation null is JAX's ``fdr_bh``."""
    if attrs == "binary":
        vals = _go_matrix(net[1], seed=7, nan_share=0.4)
        jsf = _jax(net, vals)
        jsf.run_pipeline(background="network")
        psf = _port(jsf)
        psf.run_pipeline()
        assert psf._hypergeom_engine_used == "loop-dense-staged"
        assert not np.isnan(psf.node2attribute).any()
        _assert_binary_equal(psf, jsf, fused=False)
        return
    vals = _integers(N_NODES, seed=8)
    jsf = _jax(net, vals, random_seed=3)
    jsf.run_pipeline(background="network", multiple_testing=True,
                     num_permutations=50)
    psf = _port(jsf)
    perm_idx = _perm_idx(np.where(np.isnan(vals), 0.0, vals))
    psf.run_pipeline(perm_idx=perm_idx)
    np.testing.assert_array_equal(psf.node2attribute, jsf.node2attribute)
    np.testing.assert_array_equal(psf.ns, jsf.ns)
    cn, cp = _jax_counts(jsf, perm_idx)
    np.testing.assert_array_equal(psf.counts_neg, cn)
    np.testing.assert_array_equal(psf.counts_pos, cp)
    jsf.num_permutations = len(perm_idx)
    jsf._finalize_randomization(cn, cp, jsf.ns)
    assert np.max(np.abs(psf.pvalues_pos - jsf.pvalues_pos)) <= 1e-12
    assert np.max(np.abs(psf.pvalues_neg - jsf.pvalues_neg)) <= 1e-12
    jsf._update_binary_enrichment()
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)


@pytest.mark.parametrize("attrs", ["quantitative", "binary"])
def test_dense_euclidean_metric_matches_jax(net, attrs):
    """The euclidean metric: the dense distance matrix, strict radius;
    identical neighborhoods."""
    if attrs == "binary":
        vals = _go_matrix(net[1], seed=10)
        jsf = _jax(net, vals, node_distance_metric="euclidean")
        jsf.run_pipeline()
        psf = _port(jsf)
        psf.run_pipeline()
        assert psf.apsp_engine_used == "euclidean"
        _assert_binary_equal(psf, jsf, fused=False)
    else:
        vals = _integers(N_NODES, seed=11)
        jsf = _jax(net, vals, node_distance_metric="euclidean", random_seed=1)
        jsf.run_pipeline(num_permutations=50)
        psf = _port(jsf)
        perm_idx = _perm_idx(vals)
        psf.run_pipeline(perm_idx=perm_idx)
        np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
        np.testing.assert_array_equal(psf.ns, jsf.ns)
        cn, cp = _jax_counts(jsf, perm_idx)
        np.testing.assert_array_equal(psf.counts_neg, cn)
        np.testing.assert_array_equal(psf.counts_pos, cp)
    # |x|^2 + |y|^2 - 2 x.y rounds in f32 at the scale of |x|^2 <= 2 and
    # cancels near 0: squared distances agree to a few f32 ulps of that
    # scale, the distances themselves less so
    np.testing.assert_allclose(psf.node_distances ** 2,
                               jsf.node_distances ** 2, rtol=1e-6, atol=1e-6)


def test_caller_set_neighborhoods_upload(net):
    """An indicator set by the caller is what compute_pvalues tests."""
    vals = _go_matrix(net[1], seed=12)
    jsf = _jax(net, vals)
    jsf.define_neighborhoods()
    nbr = jsf.neighborhoods.copy()
    nbr[:, ::3] = 0
    np.fill_diagonal(nbr, 1)
    jsf.neighborhoods = nbr
    jsf.compute_pvalues()
    psf = _port(jsf)
    psf.neighborhoods = nbr
    assert psf._neighborhoods_dev is None
    psf.compute_pvalues()
    assert psf._neighborhoods_dev.dtype == torch.float32
    _assert_binary_equal(psf, jsf, fused=False)


def test_from_numpy_state_carries_the_enrichment_settings(net):
    settings = dict(enrichment_type="hypergeometric", enrichment_threshold=0.01,
                    hypergeom_engine="loop", logsf_store="device",
                    multiple_testing=True,
                    background="network", attribute_sign="highest",
                    node_distance_metric="shortpath")
    jsf = _jax(net, _go_matrix(net[1]), **settings)
    psf = _port(jsf)
    assert {k: getattr(psf, k) for k in ENRICHMENT_SETTINGS} == settings
    with pytest.raises(TypeError, match="unknown settings"):
        from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                         neighborhood_radius=0.1, random_seed=0,
                         device="cpu", band_split_min_bytes=1)


@pytest.fixture(scope="module")
def world1_mesh(tmp_path_factory):
    """One-rank gloo meshes in this process: {"data": 1} and {"data": 1,
    "attr": 1}."""
    import torch.distributed as dist
    from safepy_tpu_torch.parallel import make_mesh

    rdv = tmp_path_factory.mktemp("world1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        yield {"data": make_mesh({"data": 1}, device_type="cpu"),
               "data_attr": make_mesh({"data": 1, "attr": 1},
                                      device_type="cpu")}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case,item", [
    ("binary over band storage", "A7 remainder"),
    ("staged binary over band storage", "A7 remainder"),
    ("euclidean band form", "A7 remainder"),
    ("staged euclidean band form", "A7 remainder"),
    ("binary on a mesh", "A10 remainder"),
    ("euclidean on a mesh", "A10 remainder"),
    ("define_neighborhoods on a mesh", "A10 remainder"),
    ("compute_pvalues on a mesh", "A10 remainder")])
def test_unported_cases_raise_before_anything_is_computed(net, case, item,
                                                         request):
    """Each refusal names its ROADMAP item and leaves no result behind;
    nothing quietly takes another path. Binary enrichment over band
    storage, fused and staged (with ``background='network'``), was refused
    until the band GO engines were ported, and the euclidean band form,
    fused and staged, until it was; the mesh cases until the dense engines
    on a mesh were: those cases now run and equal the JAX package's runs
    (tests/test_torch_band_go.py holds every band GO engine,
    tests/test_torch_euclid_band.py the euclidean band,
    tests/test_torch_mesh_dense.py the meshes of several ranks). The mesh
    cases run on a one-rank gloo mesh in this process: the dense FW
    row-sharded (``data``) and the census sharded (``attr``) over one
    rank, the stages and the fused binary run against JAX's unsharded
    runs, the euclidean run against the port's own run without a mesh
    with the same permutations (integer values: exact sums)."""
    binary = "binary" in case or "compute_pvalues" in case
    vals = _go_matrix(net[1]) if binary else _integers(N_NODES)
    jsf = _jax(net, vals)
    psf = _port(jsf, apsp_mode="band" if "band" in case else "auto",
                node_distance_metric=("euclidean" if "euclidean" in case
                                      else "shortpath_weighted_layout"))
    if case.endswith("binary over band storage"):
        jsf.apsp_mode = "band"
        if case.startswith("staged"):
            for sf in (jsf, psf):
                sf.define_neighborhoods()  # band storage
                sf.background = "network"
                sf.compute_pvalues()
        else:
            jsf.run_pipeline()
            psf.run_pipeline()
        assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used
        assert psf.apsp_engine_used == "band-storage"
        _assert_binary_equal(psf, jsf, fused=True)
        return
    if case.endswith("euclidean band form"):
        jsf.apsp_mode, jsf.node_distance_metric = "band", "euclidean"
        jsf.random_seed = 3
        perm_idx = _perm_idx(vals)
        if case.startswith("staged"):
            jsf.define_neighborhoods()
            jsf.compute_pvalues(num_permutations=len(perm_idx))
            psf.define_neighborhoods()
            psf.compute_pvalues(perm_idx=perm_idx)
        else:
            jsf.run_pipeline(num_permutations=len(perm_idx))
            psf.run_pipeline(perm_idx=perm_idx)
        assert psf.apsp_engine_used == "band-storage"
        np.testing.assert_array_equal(psf._neighborhoods_dev.data.numpy(),
                                      np.asarray(jsf._neighborhoods_dev.data))
        np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
        np.testing.assert_array_equal(psf.node_distances, jsf.node_distances)
        np.testing.assert_array_equal(psf.ns, jsf.ns)
        cn, cp = _jax_counts(jsf, perm_idx)
        np.testing.assert_array_equal(psf.counts_neg, cn)
        np.testing.assert_array_equal(psf.counts_pos, cp)
        return
    if "mesh" in case:
        mesh = request.getfixturevalue("world1_mesh")
        if case == "binary on a mesh":
            psf.mesh = mesh["data"]
            jsf.run_pipeline()
            psf.run_pipeline()
            assert psf.apsp_engine_used == "dense-sharded"
            assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used
            _assert_binary_equal(psf, jsf, fused=True)
        elif case == "euclidean on a mesh":
            psf.random_seed = 3
            ref = _port(jsf, node_distance_metric="euclidean",
                        random_seed=3)
            psf.mesh = mesh["data"]
            perm_idx = _perm_idx(vals)
            psf.run_pipeline(perm_idx=perm_idx)
            ref.run_pipeline(perm_idx=perm_idx)
            jsf.node_distance_metric = "euclidean"
            jsf.define_neighborhoods()
            np.testing.assert_array_equal(psf.neighborhoods,
                                          jsf.neighborhoods)
            for name in ("ns", "counts_neg", "counts_pos", "nes"):
                np.testing.assert_array_equal(getattr(psf, name),
                                              getattr(ref, name))
        elif case == "define_neighborhoods on a mesh":
            psf.mesh = mesh["data"]
            psf.define_neighborhoods()
            jsf.define_neighborhoods()
            assert psf.apsp_engine_used == "dense-sharded"
            np.testing.assert_array_equal(psf.neighborhoods,
                                          jsf.neighborhoods)
        else:
            psf.mesh = mesh["data_attr"]
            for sf in (psf, jsf):
                sf.define_neighborhoods()
                sf.compute_pvalues()
            assert psf._hypergeom_engine_used == "loop-dense-attr-sharded"
            np.testing.assert_array_equal(psf.neighborhoods,
                                          jsf.neighborhoods)
            np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
            # the sharded engine finalizes on the device in f32, the staged
            # single-device one on the host in f64 (as JAX's
            # tests/test_facade_mesh.py:123-132 holds them)
            assert np.nanmax(np.abs(psf.pvalues_pos - jsf.pvalues_pos)) \
                <= 1e-6
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        psf.run_pipeline()
    assert psf._neighborhoods_dev is None and psf.nes is None
