"""The slice end to end: JAX ``SAFE.run_pipeline`` against the port's, on the
same geometric network and attribute, carried across with ``from_numpy_state``.

Tolerances: neighborhoods identical; distances within 1e-6 relative inside
the radius (inf in the same places); observed scores within 1e-5; null counts
exactly equal when both get the same permutations (integer-valued attribute,
exact f32 sums); with each package's own RNG, p-values within the binomial
tolerance of tests/test_reference_parity.py:193.
"""


import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial import cKDTree

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu.ops import permutation as jperm
from safepy_tpu_torch import SAFE
from safepy_tpu_torch.io.graph_arrays import edge_lengths, graph_to_arrays
from safepy_tpu_torch.state import from_numpy_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_NODES, N_PERM, SEED = 420, 1000, 7


def _network(n=N_NODES, k=8, seed=3):
    """kNN geometric graph with the node attributes the JAX loaders expect."""
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
    return g


def _attribute(n=N_NODES, seed=4):
    """Integer-valued quantitative attribute with 30% NaN: f32 sums exact."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, (n, 1)).astype(float)
    vals[rng.random(n) < 0.3, 0] = np.nan
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                        columns=["q"])


def _jax_run(mode):
    sf = JaxSAFE(verbose=False)
    sf.apsp_mode = mode
    sf.random_seed = SEED
    sf.load_network(network_file=_network(), node_key_attribute="key")
    sf.load_attributes(attribute_file=_attribute())
    sf.run_pipeline(num_permutations=N_PERM)
    return sf


def _port(jsf, mode):
    sf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                          neighborhood_radius=jsf.neighborhood_radius,
                          random_seed=jsf.random_seed, device="cpu")
    sf.apsp_mode = mode
    return sf


@pytest.fixture(scope="module", params=["auto", "full"])
def runs(request):
    mode = request.param
    jsf = _jax_run(mode)
    psf = _port(jsf, mode)
    psf.run_pipeline(num_permutations=N_PERM)
    return mode, jsf, psf


def test_engine_taken(runs):
    mode, jsf, psf = runs
    if mode == "auto":
        plans = [p for p in jsf._banded_cache.values() if p is not None]
        assert len(plans) == 1, "the JAX facade did not take the banded plan"
        assert psf.apsp_engine_used == "banded-window"
        assert psf.window_used == plans[0][2]
        assert psf.window_used < N_NODES
    else:
        assert psf.apsp_engine_used == "dense" and psf.window_used is None


def test_neighborhoods_and_distances(runs):
    mode, jsf, psf = runs
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    jd, pd_ = jsf.node_distances, psf.node_distances
    np.testing.assert_array_equal(np.isinf(pd_), np.isinf(jd))
    inside = jsf.neighborhoods.astype(bool)
    np.testing.assert_allclose(pd_[inside], jd[inside], rtol=1e-6)
    if mode == "full":  # the dense distances hold beyond the radius too
        fin = np.isfinite(jd)
        np.testing.assert_allclose(pd_[fin], jd[fin], rtol=1e-6)


def test_scores_and_binomial_pvalues(runs):
    _, jsf, psf = runs
    np.testing.assert_array_equal(np.isnan(psf.ns), np.isnan(jsf.ns))
    assert np.nanmax(np.abs(psf.ns - jsf.ns)) <= 1e-5
    np.testing.assert_array_equal(np.isnan(psf.pvalues_pos),
                                  np.isnan(jsf.pvalues_pos))
    for ours, theirs in ((psf.pvalues_pos, jsf.pvalues_pos),
                         (psf.pvalues_neg, jsf.pvalues_neg)):
        pooled = (np.nan_to_num(ours) + np.nan_to_num(theirs)) / 2
        # independent Binomial(P, p)/P draws: 6 sigma of the difference plus
        # discretization slack
        tol = 6 * np.sqrt(pooled * (1 - pooled) * 2 / N_PERM) + 3 / N_PERM
        assert np.all(np.abs(np.nan_to_num(ours) - np.nan_to_num(theirs))
                      <= tol)
    assert psf.nes.shape == jsf.nes.shape
    assert psf.nes_binary.shape == jsf.nes_binary.shape
    assert psf.attributes["num_neighborhoods_enriched"].shape == (1,)


def test_counts_exact_with_injected_permutations(runs):
    """The JAX facade takes no indices, so its side is composed from
    prepare_valid + permutation_scores + counting on its own run's
    neighborhoods and observed scores."""
    mode, jsf, _ = runs
    n2a = jsf.node2attribute
    valid_rows = np.flatnonzero(np.isfinite(n2a).any(axis=1))
    rng = np.random.default_rng(9)
    perm_idx = np.stack([rng.permutation(len(valid_rows)) for _ in range(200)])
    nv, v, m = jperm.prepare_valid(jnp.asarray(jsf.neighborhoods, jnp.float32),
                                   jnp.asarray(n2a, jnp.float32), valid_rows)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))
    psf = _port(jsf, mode)
    psf.run_pipeline(perm_idx=perm_idx)
    assert psf.num_permutations == 200
    np.testing.assert_array_equal(psf.counts_neg,
                                  (scores <= jsf.ns[None]).sum(0))
    np.testing.assert_array_equal(psf.counts_pos,
                                  (scores >= jsf.ns[None]).sum(0))


def test_graph_inputs_match_the_jax_loaders():
    g = _network(n=60, seed=5)
    coords, edges, lengths, weights = graph_to_arrays(g)
    jsf = JaxSAFE(verbose=False)
    jsf.load_network(network_file=g, node_key_attribute="key")
    for ours, theirs in zip((coords, edges, lengths, weights),
                            jsf._graph_to_arrays_cached()):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(edge_lengths(coords, edges, weights),
                                  lengths)
    # a DataFrame is aligned to the node keys like the JAX loader aligns it
    df = _attribute(n=60).iloc[::-1]
    jsf.load_attributes(attribute_file=df)
    psf = SAFE(device="cpu", verbose=False)
    psf.load_network(network_file=g, node_key_attribute="key")
    psf.load_attributes(attribute_file=df)
    np.testing.assert_array_equal(psf.node2attribute, jsf.node2attribute)


def _small_port_session(vals=None, **settings):
    """(JAX session, port session) on a 60-node network; the JAX session
    holds the graph and attributes but has run nothing."""
    jsf = JaxSAFE(verbose=False)
    for k, v in settings.items():
        setattr(jsf, k, v)
    g = _network(n=60, seed=6)
    jsf.load_network(network_file=g, node_key_attribute="key")
    if vals is None:
        vals = np.random.default_rng(0).normal(size=(60, 1))
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(60)]))
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=0.1, random_seed=1,
                           device="cpu")
    for k, v in settings.items():
        setattr(psf, k, v)
    return jsf, psf


def _assert_hypergeom_matches_jax(jsf, psf):
    """Binary results: the engine, the indicator and the enriched counts
    exactly; p-values within 1e-9 plus 4 f32 ulps of their stored
    log-survival (tests/test_torch_hypergeom.py)."""
    assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    np.testing.assert_array_equal(
        psf.attributes["num_neighborhoods_enriched"],
        jsf.attributes["num_neighborhoods_enriched"])
    pj = jsf.pvalues_pos
    assert np.all(np.abs(psf.pvalues_pos - pj)
                  <= 1e-9 + 2.0 ** -21 * pj
                  * np.abs(np.log(np.maximum(pj, 1e-300))))


def _assert_matches_jax_run(jsf, psf, perm_idx):
    """The port's run with injected permutations against the JAX facade's
    run: neighborhoods, scores and composed counts (as in
    test_counts_exact_with_injected_permutations), and JAX's finalization
    of those counts; for binary attributes the hypergeometric results."""
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    if psf._hypergeom_engine_used is not None:
        _assert_hypergeom_matches_jax(jsf, psf)
        return
    np.testing.assert_array_equal(psf.ns, jsf.ns)
    n2a = jsf.node2attribute
    valid_rows = np.flatnonzero(np.isfinite(n2a).any(axis=1))
    nv, v, m = jperm.prepare_valid(jnp.asarray(jsf.neighborhoods, jnp.float32),
                                   jnp.asarray(n2a, jnp.float32), valid_rows)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))
    cn, cp = (scores <= jsf.ns[None]).sum(0), (scores >= jsf.ns[None]).sum(0)
    np.testing.assert_array_equal(psf.counts_neg, cn)
    np.testing.assert_array_equal(psf.counts_pos, cp)
    jsf.num_permutations = len(perm_idx)
    jsf._finalize_randomization(cn, cp, jsf.ns)
    assert np.max(np.abs(psf.pvalues_pos - jsf.pvalues_pos)) <= 1e-12
    assert np.max(np.abs(psf.pvalues_neg - jsf.pvalues_neg)) <= 1e-12


@pytest.mark.parametrize("setting,value,item", [
    ("multiple_testing", True, "A4"), ("background", "network", "A4"),
    ("node_distance_metric", "euclidean", "A4"),
    ("band_relax", "bf", "A7"), ("band_indicator_bits", True, "A7"),
    ("mesh", {"data": 1}, "A10"),
    ("enrichment_type", "hypergeometric", "A5")])
def test_unported_paths_raise(setting, value, item, tmp_path):
    """The options of the JAX facade by the ROADMAP item that brings them,
    each refused until this port had it, now run and are held against the
    JAX facade: FDR, background='network', the euclidean metric and the
    hypergeometric test (A4, A5); the sparse Bellman-Ford relax and the
    bit-packed indicator over band storage (A7); and a bit-packed band on a
    'data' mesh (A10): the port on a one-rank gloo mesh in this process,
    JAX's sharded band engine on a one-device mesh."""
    rng = np.random.default_rng(0)
    vals = rng.integers(-3, 4, (60, 1)).astype(float)  # exact f32 sums
    vals[rng.random(60) < 0.2] = np.nan
    if item == "A5":
        vals = (np.nan_to_num(vals) > 0).astype(float)
    band = {"apsp_mode": "band"} if item in ("A7", "A10") else {}
    if setting == "mesh":
        import jax
        from jax.sharding import Mesh

        jsf, psf = _small_port_session(vals, band_indicator_bits=True,
                                       **band)
        jsf.mesh = Mesh(np.array(jax.devices()[:1]), tuple(value))
    else:
        jsf, psf = _small_port_session(vals, **{setting: value}, **band)
    jsf.random_seed = 1
    jsf.run_pipeline(num_permutations=20)
    perm_idx = np.stack([np.random.default_rng(s).permutation(
        int(np.isfinite(jsf.node2attribute).any(axis=1).sum()))
        for s in range(20)])
    if setting == "mesh":
        import torch.distributed as dist
        from safepy_tpu_torch.parallel import make_mesh

        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
            world_size=1)
        try:
            psf.mesh = make_mesh(value, device_type="cpu")
            psf.run_pipeline(perm_idx=perm_idx)
        finally:
            dist.destroy_process_group()
        assert psf._neighborhoods_dev.data.dtype == torch.uint8
        np.testing.assert_array_equal(psf._neighborhoods_dev.data.numpy(),
                                      np.asarray(jsf._neighborhoods_dev.data))
    else:
        psf.run_pipeline(perm_idx=perm_idx)
        assert getattr(psf, setting) == value
    assert psf._band_relax_used == jsf._band_relax_used
    _assert_matches_jax_run(jsf, psf, perm_idx)


def test_binary_attributes_raise_and_quantitative_runs():
    """A session reloaded with binary attributes takes the hypergeometric
    test ('auto'), as the JAX facade does, where it was refused before."""
    jsf, sf = _small_port_session()
    sf.run_pipeline(num_permutations=20)
    assert sf.apsp_engine_used in ("banded-window", "dense")
    assert np.isfinite(sf.ns).all() and sf.nes.shape == (60, 1)
    binary = (np.arange(60) % 2).astype(float)
    sf.load_attributes(attribute_file=binary)
    sf.run_pipeline(num_permutations=20)
    jsf.load_attributes(attribute_file=pd.DataFrame(
        binary, index=[f"g{i}" for i in range(60)]))
    jsf.run_pipeline()
    _assert_hypergeom_matches_jax(jsf, sf)
