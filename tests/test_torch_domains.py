"""The domain stage of the port against the JAX package: the device ops
(intersections, condensed jaccard, node-to-domain aggregates, the CSC view),
``define_top_attributes``, ``define_domains`` engine for engine,
``trim_domains``, and the facade end to end on a binary and a quantitative
run carried across with ``from_numpy_state``.

Tolerances: none. Everything is held exactly equal: the condensed jaccard
bitwise to scipy's ``pdist`` and to JAX's, the counts, domain ids, labels
and ``primary_nes``. The fused binary NES of the two packages agree within
4 f32 ulps only (``tests/test_torch_enrichment_facade.py``), so a facade
comparison hands JAX's NES to the port session through the ``nes`` setter;
the port's own device NES is held against JAX's ``define_domains`` run on
that same NES.
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp
from scipy.spatial import cKDTree
from scipy.spatial.distance import pdist

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu import domains as jdomains
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu.ops import domains_device as jdd
from safepy_tpu.ops import permutation as jperm
from safepy_tpu_torch import SAFE
from safepy_tpu_torch import domains as pdomains
from safepy_tpu_torch.ops import domains_device as pdd
from safepy_tpu_torch.state import (DOMAIN_SETTINGS, ENRICHMENT_SETTINGS,
                                    from_numpy_state)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the test runner's parallel workers, torch's per-process
    intra-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ENGINES = ("scipy", "gemm", "auto")
WORDS = ("regulation", "of", "transport", "cell", "cycle", "protein", "the",
         "DNA", "repair", "to", "metabolic", "process", "via", "signaling")


def _names(a, seed=0):
    """GO-like term names, stopwords included, for the labels."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(2, 5))) + f" {j}"
            for j in range(a)]


def _random_binary(rng, n, a, density=0.15):
    return (rng.random((n, a)) < density).astype(np.int8)


# ------------------------------------------------------------ device ops

@pytest.mark.parametrize("n,a,density", [(64, 12, 0.3), (257, 33, 0.05),
                                         (100, 20, 0.6)])
def test_jaccard_condensed_bitwise_equal_to_pdist_and_jax(n, a, density):
    rng = np.random.default_rng(7)
    b = _random_binary(rng, n, a, density)
    b[:, 3] = 0                # an empty column: union-0 pairs give 0
    b[:, 5] = b[:, 6]          # identical columns: distance 0
    inter = pdd.enrichment_intersections(torch.as_tensor(b))
    assert inter.dtype == np.int32
    np.testing.assert_array_equal(inter, jdd.enrichment_intersections(b))
    ours = pdd.jaccard_condensed_from_counts(inter)
    np.testing.assert_array_equal(
        ours, pdist(b.T.astype(np.float64), metric="jaccard"))
    np.testing.assert_array_equal(ours, jdd.jaccard_condensed_from_counts(
        jdd.enrichment_intersections(b)))


def test_intersections_exact_past_half_precision_and_from_numpy():
    """Counts above 2,048 (where bf16 and fp16 outputs would round) equal
    the host f64 product; numpy goes to the given device."""
    rng = np.random.default_rng(3)
    b = _random_binary(rng, 3000, 9, 0.9)
    want = b.T.astype(np.float64) @ b.astype(np.float64)
    assert want.max() > 2048
    got = pdd.enrichment_intersections(b.astype(np.float64), device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pdd.enrichment_intersections(torch.as_tensor(b)), want)


@pytest.mark.parametrize("nes_dtype", [np.float32, np.float64])
def test_domain_aggregates_match_jax(nes_dtype):
    """NaN NES, an unused domain id, and an f64 NES, which both packages
    round to f32 on the way to the device."""
    rng = np.random.default_rng(11)
    n, a = 200, 40
    nes_binary = _random_binary(rng, n, a, 0.2)
    nes = rng.normal(size=(n, a)).astype(nes_dtype)
    nes[rng.random((n, a)) < 0.3] = np.nan
    nes[:, 7] = np.nan                     # a domain of one all-NaN column
    dom_raw = rng.integers(0, 6, size=a)
    dom_raw[dom_raw == 4] = 5              # id 4 unused: an empty domain
    dom_raw[7] = 6
    ndom = 7
    counts, max_nes = pdd.domain_aggregates(nes_binary, nes, dom_raw, ndom,
                                            device="cpu")
    jcounts, jmax = jdd.domain_aggregates(nes_binary, nes, dom_raw, ndom)
    assert counts.dtype == np.int64 and max_nes.dtype == np.float64
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(max_nes, jmax)
    assert np.isneginf(max_nes[:, 4]).all() and np.isneginf(max_nes[:, 6]).all()
    # the device tensors give the same
    t_counts, t_max = pdd.domain_aggregates(
        torch.as_tensor(nes_binary), torch.as_tensor(nes.astype(np.float32)),
        dom_raw, ndom)
    np.testing.assert_array_equal(t_counts, jcounts)
    np.testing.assert_array_equal(t_max, jmax)


def test_indicator_csc_matches_dense():
    rng = np.random.default_rng(5)
    b = _random_binary(rng, 73, 11, 0.2)
    b[:, 4] = 0
    csc = pdd.indicator_csc(torch.as_tensor(b), b.sum(axis=0))
    assert sp.isspmatrix_csc(csc) and csc.dtype == np.int8
    np.testing.assert_array_equal(csc.toarray(), b)
    np.testing.assert_array_equal(
        csc.toarray(), jdd.indicator_csc(jnp.asarray(b), b.sum(axis=0))
        .toarray())
    empty = pdd.indicator_csc(torch.zeros((5, 3), dtype=torch.int8),
                              np.zeros(3))
    assert empty.nnz == 0 and empty.shape == (5, 3)
    with pytest.raises(AssertionError, match="counts are stale"):
        pdd.indicator_csc(torch.as_tensor(b), b.sum(axis=0) + 1)


@pytest.mark.parametrize("case", ["sparse_large", "dense_large",
                                  "sparse_small", "setter"])
def test_facade_takes_the_csc_view_by_jax_rule(case):
    """More than 3e7 cells, under a quarter of them nonzero, from a device
    indicator: the CSC view; otherwise the int8 download or the host
    matrix set through the setter."""
    n, a = (4000, 7600) if case != "sparse_small" else (400, 760)
    b = torch.zeros((n, a), dtype=torch.int8)
    if case == "dense_large":
        b[:, ::3] = 1
    else:
        b[::100] = 1
        b[:, 5] = 0
    sf = SAFE(device="cpu", verbose=False)
    sf.attributes = {"id": np.arange(a), "name": _names(a)}
    counts = b.sum(dim=0, dtype=torch.int32)
    sf._nes_binary_pending = (b, counts)  # as a device run hands it over
    if case == "setter":
        host = b.numpy().astype(float)
        sf._update_binary_enrichment()
        sf.nes_binary = host
        assert sf._nes_binary_for_top() is host
        return
    view = sf._nes_binary_for_top()
    np.testing.assert_array_equal(sf.attributes["num_neighborhoods_enriched"],
                                  counts.numpy())
    if case == "sparse_large":
        assert sp.isspmatrix_csc(view) and sf._nes_binary_for_top() is view
        assert (view != sp.csc_matrix(b.numpy())).nnz == 0
    else:
        assert isinstance(view, np.ndarray) and view.dtype == np.int8
        np.testing.assert_array_equal(view, b.numpy())


# ------------------------------------------------------- the stage functions

def _geometric(n=120, seed=4):
    g = nx.random_geometric_graph(n, 0.2, seed=seed)
    return g, np.array(list(g.edges()), np.int64).reshape(-1, 2)


@pytest.mark.parametrize("form", ["dense", "csc"])
def test_define_top_attributes_matches_jax(form):
    rng = np.random.default_rng(9)
    n, a = 120, 30
    g, edges = _geometric(n)
    nes_binary = _random_binary(rng, n, a, 0.15).astype(np.float64)
    nes_binary[:, 2] = 0
    for j, src in ((3, 0), (4, 7), (5, 50)):   # connected balls: top
        ball = list(nx.single_source_shortest_path_length(g, src, cutoff=2))
        nes_binary[:, j] = 0
        nes_binary[ball, j] = 1
    nes_binary[:, 6] = nes_binary[:, 3] + nes_binary[:, 5] > 0
    counts = nes_binary.sum(axis=0)
    given = (sp.csc_matrix(nes_binary, dtype=np.int8) if form == "csc"
             else nes_binary)
    jattrs = pd.DataFrame({"id": np.arange(a), "name": _names(a)})
    jattrs["num_neighborhoods_enriched"] = counts
    jattrs = jdomains.define_top_attributes(jattrs, given, g, min_size=3,
                                            verbose=False)
    pattrs = {"id": np.arange(a), "name": _names(a),
              "num_neighborhoods_enriched": counts}
    pattrs = pdomains.define_top_attributes(pattrs, given, edges, n,
                                            min_size=3, verbose=False)
    assert 0 < pattrs["top"].sum() < a
    for col in ("top", "num_connected_components",
                "num_large_connected_components"):
        np.testing.assert_array_equal(pattrs[col], jattrs[col].to_numpy())
    for got, want in zip(pattrs["size_connected_components"],
                         jattrs["size_connected_components"]):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    # the size rule alone for another unimodality metric
    other = pdomains.define_top_attributes(
        {"num_neighborhoods_enriched": counts}, given, edges, n,
        unimodality_metric="none", min_size=3, verbose=False)
    np.testing.assert_array_equal(other["top"], counts >= 3)


def _domain_inputs(rng, n=300, a=140, nan_frac=0.2, all_top=False):
    nes_binary = _random_binary(rng, n, a, 0.12).astype(np.float64)
    nes = rng.normal(2.0, 1.0, size=(n, a))
    nes[rng.random((n, a)) < nan_frac] = np.nan
    top = np.ones(a, bool) if all_top else rng.random(a) < 0.8
    top[:2] = True
    return top, nes, nes_binary


def _jax_attrs(top, names):
    df = pd.DataFrame({"id": np.arange(len(top)), "name": names})
    df["top"] = top
    return df


def _assert_n2d_equal(pn, jn):
    """A port NodeDomains equal to a JAX node2domain DataFrame: its count
    columns (ids and values), primary domain and primary NES."""
    cols = [c for c in jn.columns if c not in ("primary_domain",
                                               "primary_nes")]
    assert list(pn.domains) == cols
    np.testing.assert_array_equal(pn.counts, jn[cols].to_numpy(np.float64))
    for c in cols:
        np.testing.assert_array_equal(pn[c], jn[c].to_numpy(np.float64))
    np.testing.assert_array_equal(pn["primary_domain"],
                                  jn["primary_domain"].to_numpy())
    np.testing.assert_array_equal(pn["primary_nes"],
                                  jn["primary_nes"].to_numpy())
    assert pn.primary_nes.dtype == jn["primary_nes"].dtype == np.float64


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", ["mixed", "all_top"])
def test_define_domains_matches_jax_engine(engine, shape):
    """Each engine against the same JAX engine on the same host inputs
    (f64 NES with NaN). 'mixed': ~112 top of 140, so 'auto' takes the GEMM;
    'all_top': 60 all top, no domain 0, so 'auto' takes scipy."""
    rng = np.random.default_rng(7)
    top, nes, nes_binary = _domain_inputs(
        rng, a=140 if shape == "mixed" else 60, all_top=shape == "all_top")
    names = _names(len(top))
    ja, jn = jdomains.define_domains(_jax_attrs(top, names), nes, nes_binary,
                                     cluster_engine=engine, verbose=False)
    pa, pn = pdomains.define_domains({"name": names, "top": top}, nes,
                                     nes_binary, cluster_engine=engine,
                                     verbose=False, device="cpu")
    np.testing.assert_array_equal(pa["domain"], ja["domain"].to_numpy())
    assert (0 in pn.domains) == (shape == "mixed")
    _assert_n2d_equal(pn, jn)


def test_define_domains_device_copies_and_intersections_match_jax():
    """The GEMM engine on device copies (int8 indicator, f32 NES) and on
    precomputed intersections: JAX's engine on its own device copies."""
    rng = np.random.default_rng(8)
    top, nes, nes_binary = _domain_inputs(rng, a=100)
    nes32 = nes.astype(np.float32)
    b8 = nes_binary.astype(np.int8)
    names = _names(len(top))
    ja, jn = jdomains.define_domains(
        _jax_attrs(top, names), None, None, cluster_engine="gemm",
        nes_binary_dev=jnp.asarray(b8), nes_dev=jnp.asarray(nes32),
        verbose=False)
    inter = pdd.enrichment_intersections(torch.as_tensor(b8))
    for kw in ({}, {"intersections": inter}):
        pa, pn = pdomains.define_domains(
            {"name": names, "top": top}, None, None, cluster_engine="gemm",
            nes_binary_dev=torch.as_tensor(b8),
            nes_dev=torch.as_tensor(nes32), verbose=False, **kw)
        np.testing.assert_array_equal(pa["domain"], ja["domain"].to_numpy())
        _assert_n2d_equal(pn, jn)


def test_define_domains_refusals():
    rng = np.random.default_rng(2)
    top, nes, nes_binary = _domain_inputs(rng, a=30)
    with pytest.raises(ValueError, match="jaccard"):
        pdomains.define_domains({"top": top}, nes, nes_binary,
                                cluster_engine="gemm",
                                distance_metric="euclidean", verbose=False)
    with pytest.raises(ValueError, match="at least 2 top"):
        pdomains.define_domains({"top": np.eye(30, dtype=bool)[0]}, nes,
                                nes_binary, verbose=False)


def _trim_fixture():
    """tests/test_domains_trim.py:22-40: 6 attributes over 3 domains;
    domain 2 is primary for one node and goes at min_size=2."""
    names = ["alpha one", "alpha two", "beta odd", "gamma one", "gamma two",
             "unclustered"]
    domain = [1, 1, 2, 3, 3, 0]
    top = [True, True, True, True, True, False]
    counts = np.array([[0, 2, 0, 0], [0, 2, 1, 0], [0, 0, 2, 0],
                       [0, 0, 0, 3], [0, 0, 0, 3]], np.float64)
    primary = np.array([1, 1, 2, 3, 3])
    primary_nes = np.array([2.0, 2.5, 1.4, 3.0, 3.1])
    jattrs = pd.DataFrame({"id": np.arange(6), "name": names,
                           "domain": domain, "top": top})
    jn = pd.DataFrame({d: counts[:, d] for d in range(4)})
    jn["primary_domain"] = primary
    jn["primary_nes"] = primary_nes
    pattrs = {"id": np.arange(6), "name": names, "domain": np.array(domain),
              "top": np.array(top)}
    pn = pdomains.NodeDomains(np.arange(4), counts.copy(), primary.copy(),
                              primary_nes.copy())
    return (jattrs, jn), (pattrs, pn)


def test_trim_middle_domain_renumbers_everything():
    """The JAX mid-trim fixture through the port's trim_domains: the
    trimmed domain's counts fold into 0, the survivors take new ids."""
    _, (pattrs, pn) = _trim_fixture()
    pattrs, pn, domains = pdomains.trim_domains(pattrs, pn, min_size=2,
                                                verbose=False)
    assert list(pattrs["domain"]) == [1, 1, 0, 2, 2, 0]
    assert list(pn.primary_domain) == [1, 1, 0, 2, 2]
    assert list(domains["id"]) == [0, 1, 2]
    assert domains["label"] == ["beta, odd, unclustered", "alpha, one, two",
                                "gamma, one, two"]
    assert list(pn.domains) == [0, 1, 2]
    assert list(pn[0]) == [0, 1, 2, 0, 0]
    assert list(pn[2]) == [0, 0, 0, 3, 3]
    assert list(pn.primary_nes) == [2.0, 2.5, 0.0, 3.0, 3.1]


@pytest.mark.parametrize("min_size", [1, 2, 3])
def test_trim_fixture_matches_jax(min_size):
    """min_size 3 also trims domain 0 itself (one node), which zeroes
    those nodes' primary NES in both packages."""
    (jattrs, jn), (pattrs, pn) = _trim_fixture()
    ja, jn, jd = jdomains.trim_domains(jattrs, jn, min_size=min_size,
                                       verbose=False)
    pa, pn, pd_ = pdomains.trim_domains(pattrs, pn, min_size=min_size,
                                        verbose=False)
    np.testing.assert_array_equal(pa["domain"], ja["domain"].to_numpy())
    _assert_n2d_equal(pn, jn)
    assert list(pd_["id"]) == list(jd["id"])
    assert pd_["label"] == list(jd["label"])


@pytest.mark.parametrize("min_size", [2, 10, 40])
@pytest.mark.parametrize("shape", ["mixed", "all_top"])
def test_trim_matches_jax_after_define_domains(min_size, shape):
    rng = np.random.default_rng(12)
    top, nes, nes_binary = _domain_inputs(
        rng, a=120 if shape == "mixed" else 50, all_top=shape == "all_top")
    names = _names(len(top))
    ja, jn = jdomains.define_domains(_jax_attrs(top, names), nes, nes_binary,
                                     verbose=False)
    pa, pn = pdomains.define_domains({"name": names, "top": top}, nes,
                                     nes_binary, verbose=False, device="cpu")
    ja, jn, jd = jdomains.trim_domains(ja, jn, min_size=min_size,
                                       verbose=False)
    pa, pn, pd_ = pdomains.trim_domains(pa, pn, min_size=min_size,
                                        verbose=False)
    np.testing.assert_array_equal(pa["domain"], ja["domain"].to_numpy())
    _assert_n2d_equal(pn, jn)
    assert list(pd_["id"]) == list(jd["id"])
    assert pd_["label"] == list(jd["label"])


# ------------------------------------------------------------ the facade

N_NODES = 320


def _graph(n=N_NODES, k=8, seed=3):
    """kNN geometric graph with the node attributes the JAX loaders expect
    (tests/test_torch_enrichment_facade.py:48)."""
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


def _go_matrix(coords, a, seed=5, nan_share=0.1):
    """Binary terms of members near random centres, unannotated rows NaN
    (tests/test_torch_enrichment_facade.py:70)."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        out[:, j] = (near & (rng.random(n) < 0.6)) | (rng.random(n) < 0.03)
    out[rng.random(n) < nan_share] = np.nan
    return out


def _regional_integers(coords, a, seed=4, nan_share=0.2):
    """Integer-valued quantitative attributes (exact f32 sums), raised in a
    random disc each, so that regions of enrichment exist."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    vals = rng.integers(-1, 2, (n, a)).astype(float)
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.7, 0.7, 2), axis=1)
                < rng.uniform(0.25, 0.5))
        vals[near, j] += 3
    vals[rng.random(n) < nan_share] = np.nan
    return vals


@pytest.fixture(scope="module")
def net():
    return _graph()


def _pair(net, vals, **settings):
    """A JAX session on a DataFrame of named terms and the port session
    carried across with from_numpy_state."""
    g, _ = net
    jsf = JaxSAFE(verbose=False)
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(len(vals))],
        columns=_names(vals.shape[1])))
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius,
        random_seed=jsf.random_seed, device="cpu",
        attribute_names=jsf.attributes["name"],
        **{k: getattr(jsf, k) for k in ENRICHMENT_SETTINGS + DOMAIN_SETTINGS})
    return jsf, psf


@pytest.fixture(scope="module")
def binary_pair(net):
    """160 GO-like terms: 107 are top, so 'auto' takes the GEMM."""
    jsf, psf = _pair(net, _go_matrix(net[1], 160))
    jsf.run_pipeline()
    psf.run_pipeline()
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    return jsf, psf


@pytest.fixture(scope="module")
def quantitative_pair(net):
    """24 regional integer attributes, enriched on the high side (23 are
    top; both sides would scatter the low one); the port takes explicit
    permutations and JAX's null is composed from the same ones
    (tests/test_torch_enrichment_facade.py:197), so both finalize the same
    counts and their NES are equal."""
    vals = _regional_integers(net[1], 24)
    jsf, psf = _pair(net, vals, random_seed=3, attribute_sign="highest")
    jsf.define_neighborhoods()
    jsf.compute_pvalues(num_permutations=50)
    valid = np.flatnonzero(np.isfinite(vals).any(axis=1))
    rng = np.random.default_rng(9)
    perm_idx = np.stack([rng.permutation(len(valid)) for _ in range(40)])
    n2a = jsf.node2attribute
    nv, v, m = jperm.prepare_valid(
        jnp.asarray(jsf.neighborhoods, jnp.float32),
        jnp.asarray(n2a, jnp.float32), valid)
    scores = np.asarray(jperm.permutation_scores(
        nv, v, m, jnp.asarray(perm_idx), "sum"))
    jsf.num_permutations = len(perm_idx)
    jsf._finalize_randomization((scores <= jsf.ns[None]).sum(0),
                                (scores >= jsf.ns[None]).sum(0), jsf.ns)
    jsf._update_binary_enrichment()
    psf.define_neighborhoods()
    psf.compute_pvalues(perm_idx=perm_idx)
    np.testing.assert_array_equal(psf.nes, jsf.nes)
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    return jsf, psf


def _stage(sf, engine):
    sf.cluster_engine = engine
    sf.define_top_attributes()
    sf.define_domains(attribute_distance_threshold=0.75)


def _assert_stage_equal(psf, jsf, trimmed):
    for col in ("top", "num_connected_components",
                "num_large_connected_components", "domain"):
        np.testing.assert_array_equal(psf.attributes[col],
                                      jsf.attributes[col].to_numpy())
    _assert_n2d_equal(psf.node2domain, jsf.node2domain)
    if trimmed:
        assert list(psf.domains["id"]) == list(jsf.domains["id"])
        assert psf.domains["label"] == list(jsf.domains["label"])


def _run_facades(jsf, psf, engine):
    for sf in (jsf, psf):
        _stage(sf, engine)
    _assert_stage_equal(psf, jsf, trimmed=False)
    for sf in (jsf, psf):   # re-cluster at another threshold, then trim
        sf.define_domains(attribute_distance_threshold=0.6)
    _assert_stage_equal(psf, jsf, trimmed=False)
    for sf in (jsf, psf):
        sf.trim_domains()
    _assert_stage_equal(psf, jsf, trimmed=True)


@pytest.mark.parametrize("engine", ENGINES)
def test_binary_facade_matches_jax(binary_pair, engine):
    """The fused binary run: the port's own device NES against JAX's
    define_domains on that NES, then JAX's NES through the setter against
    the JAX facade; before and after trimming and at threshold 0.6."""
    jsf, psf = binary_pair
    port = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=None,
        device="cpu", attribute_names=jsf.attributes["name"])
    port.run_pipeline()
    assert port._nes_dev is not None and port._nes_binary_dev is not None
    _stage(port, engine)
    assert int(port.attributes["top"].sum()) == 107
    assert (port._domains_inter_cache is not None) == (engine != "scipy")
    jattrs = pd.DataFrame({"id": np.arange(len(port.attributes["top"])),
                           "name": port.attributes["name"],
                           "top": port.attributes["top"]})
    ja, jn = jdomains.define_domains(jattrs, port.nes, port.nes_binary,
                                     cluster_engine=engine, verbose=False)
    np.testing.assert_array_equal(port.attributes["domain"],
                                  ja["domain"].to_numpy())
    _assert_n2d_equal(port.node2domain, jn)

    psf.nes = jsf.nes
    _run_facades(jsf, psf, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_quantitative_facade_matches_jax(quantitative_pair, engine):
    """The permutation null's host f64 NES: the GEMM engine rounds it to
    f32 on the device in both packages, the scipy engine keeps f64."""
    jsf, psf = quantitative_pair
    _run_facades(jsf, psf, engine)
    assert int(psf.attributes["top"].sum()) == 23


def test_reclustering_reuses_the_intersections(binary_pair, monkeypatch):
    """One intersection GEMM for any number of re-clusterings; a new
    indicator (the setter, a new run) drops it."""
    jsf, _ = binary_pair
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=None,
        device="cpu", attribute_names=jsf.attributes["name"])
    psf.run_pipeline()
    calls = []
    real = pdd.enrichment_intersections
    monkeypatch.setattr(pdd, "enrichment_intersections",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    psf.define_top_attributes()
    psf.define_domains()
    cache = psf._domains_inter_cache
    psf.define_domains(attribute_distance_threshold=0.6)
    psf.define_domains(attribute_distance_threshold=0.5)
    assert len(calls) == 1 and psf._domains_inter_cache is cache
    psf.run_pipeline()
    assert psf._domains_inter_cache is None
    psf.define_domains()
    assert len(calls) == 2
    psf.nes_binary = psf.nes_binary.copy()
    assert psf._domains_inter_cache is None


def test_from_numpy_state_carries_names_and_domain_settings(net):
    settings = dict(attribute_enrichment_min_size=4,
                    attribute_unimodality_metric="connectivity",
                    attribute_distance_metric="jaccard",
                    attribute_distance_threshold=0.6, cluster_engine="gemm")
    jsf, psf = _pair(net, _go_matrix(net[1], 6), **settings)
    assert {k: getattr(psf, k) for k in DOMAIN_SETTINGS} == settings
    assert psf.attributes["name"] == list(jsf.attributes["name"])
    with pytest.raises(ValueError, match="attribute names"):
        from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                         neighborhood_radius=0.1, random_seed=0,
                         device="cpu", attribute_names=["one"])


@pytest.mark.parametrize("setting,value", [
    ("attribute_enrichment_min_size", 1),
    ("attribute_enrichment_min_size", 2.5),
    ("attribute_distance_threshold", 1.5),
    ("attribute_distance_threshold", 1),
    ("cluster_engine", "pdist")])
def test_domain_settings_are_checked(setting, value):
    sf = SAFE(device="cpu", verbose=False)
    setattr(sf, setting, value)
    with pytest.raises(ValueError, match=setting):
        sf._validate()


def _dry_run_network(n=200, seed=0):
    """The network of the JAX package's dry run (``__graft_entry__.py:
    97-110``) at 200 nodes: uniform in the unit square, edges under 0.18,
    and six binary attributes, each 80% of the nodes in a disc."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (n, 2))
    g = nx.Graph()
    for i in range(n):
        g.add_node(i, x=float(coords[i, 0]), y=float(coords[i, 1]),
                   label=f"g{i}", key=f"g{i}")
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    g.add_edges_from(zip(*np.nonzero(np.triu(d < 0.18, 1))))
    calculate_edge_lengths(g, verbose=False)
    binary = np.zeros((n, 6))
    for j, centre in enumerate(rng.uniform(0.2, 0.8, (6, 2))):
        disc = np.linalg.norm(coords - centre, axis=1) < 0.25
        binary[disc, j] = rng.random(int(disc.sum())) < 0.8
    return g, pd.DataFrame(binary, index=[f"g{i}" for i in range(n)],
                           columns=[f"b{j}" for j in range(6)])


def test_stage_order_and_unknown_arguments():
    """The stages refuse to run out of order; a keyword argument a stage
    does not read is ignored, as in JAX: the domain calls of the JAX
    package's dry run (``__graft_entry__.py:151-157``, one device) give
    the same domains in both packages."""
    sf = SAFE(device="cpu", verbose=False)
    with pytest.raises(RuntimeError, match="compute_pvalues"):
        sf.define_top_attributes()
    sf.attributes = {"num_neighborhoods_enriched": np.zeros(3)}
    with pytest.raises(RuntimeError, match="define_top_attributes first"):
        sf.define_domains(attribute_distance_metric="cosine")
    with pytest.raises(RuntimeError, match="define_domains first"):
        sf.trim_domains(attribute_enrichment_min_size=2)

    g, attrs = _dry_run_network()
    jsf = JaxSAFE(verbose=False)
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=attrs)
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=jsf.neighborhood_radius,
                           random_seed=None, device="cpu",
                           attribute_names=jsf.attributes["name"])
    for sf in (jsf, psf):
        sf.define_neighborhoods(not_a_setting=1)
        sf.compute_pvalues(not_a_setting=1)
        sf.define_top_attributes(attribute_enrichment_min_size=2)
        sf.define_domains(attribute_distance_threshold=0.9,
                          attribute_enrichment_min_size=2)
        sf.trim_domains(attribute_enrichment_min_size=2)
    assert int(psf.attributes["top"].sum()) >= 2
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    _assert_stage_equal(psf, jsf, trimmed=True)
