"""The sparse Bellman-Ford band relax of the port (``apsp_band_bf``,
``band_bf_slots``, ``bf_max_iters`` in safepy_tpu_torch/ops/
apsp_bandstore.py, and ``band_relax='bf'`` in the facade) against the JAX
package's (safepy_tpu/ops/apsp_bandstore.py:481-635, safe.py:827-893), on
the same seeded numpy inputs, as tests/test_apsp_bandstore.py:223-320 and
tests/test_bandstore_facade.py:500-537 hold JAX's against its FW.

Tolerances: slots, the relaxed band, ``converged``, ``iters`` and the
facade's ``_band_relax_used`` exactly JAX's (min is exact, each candidate
is one f32 add, and the stripes run in JAX's order); indicators bitwise
the FW's; facade results, BF against FW, bitwise.
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
from safepy_tpu.ops import apsp_bandstore as jbs
from safepy_tpu.ops.apsp_banded import banded_order, graph_banded_order
from safepy_tpu.ops.neighborhoods import inclusive_radius
from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.state import (BAND_SETTINGS, ENRICHMENT_SETTINGS,
                                    from_numpy_state)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geometric(n, k, seed, long_edges=0):
    """kNN geometric graph (tests/test_apsp_bandstore.py:16): coords,
    edges, Euclidean lengths; optional random long edges exercise the
    out-of-band drop."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    pairs = {(min(i, int(j)), max(i, int(j)))
             for i in range(n) for j in nn[i, 1:]}
    for _ in range(long_edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    edges = np.array(sorted(pairs))
    w = np.hypot(*(coords[edges[:, 0]] - coords[edges[:, 1]]).T)
    return coords, edges, w.astype(np.float32)


def _setup(n, k, seed, block, long_edges=0):
    """Both packages' initial band and slots on one network (radius 0.1 of
    the x-extent), in the banded order."""
    coords, edges, w = _geometric(n, k, seed, long_edges)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return _both(n, rank[edges], w, band, block, inclusive_radius(nr))


def _both(n, pe, w, band, block, r):
    s0 = jbs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                  jnp.asarray(pe[:, 1], jnp.int32),
                                  jnp.asarray(w, jnp.float32), n=n, band=band,
                                  block=block)
    slots = bs.band_bf_slots(pe[:, 0], pe[:, 1], w, n=n, band=band,
                             block=block)
    want = jbs.band_bf_slots(pe[:, 0], pe[:, 1], w, n=n, band=band,
                             block=block)
    for got, exp in zip(slots[:3], want[:3]):
        np.testing.assert_array_equal(got, exp)
    assert slots[3] == want[3]
    return dict(s0=np.asarray(s0), slots=slots, bt=band // block + 1,
                band=band, r=r, block=block)


def _bf_both(c, max_iters, stripe=1024, clamp=None):
    clamp = np.float32(c["r"] if clamp is None else clamp)
    got = bs.apsp_band_bf(torch.as_tensor(c["s0"].copy()), *c["slots"][:3],
                          clamp, bt=c["bt"], block=c["block"],
                          max_iters=max_iters, stripe=stripe)
    want = jbs.apsp_band_bf(jnp.asarray(c["s0"]),
                            *map(jnp.asarray, c["slots"][:3]), clamp,
                            bt=c["bt"], block=c["block"],
                            max_iters=max_iters, stripe=stripe)
    return got, want


def _fw(c):
    return bs.apsp_band_fw(torch.as_tensor(c["s0"].copy()), bt=c["bt"],
                           block=c["block"])


@pytest.mark.parametrize("seed,long_edges,stripe,block",
                         [(0, 0, 1024, 64), (1, 5, 192, 64), (2, 0, 64, 64),
                          (3, 0, 1024, 128)])
def test_band_bf_matches_jax_and_fw(seed, long_edges, stripe, block):
    """The band, the flag and the rounds are JAX's bitwise; the indicator
    is the FW's; beyond-radius entries finish +inf (JAX's contract,
    tests/test_apsp_bandstore.py:223)."""
    c = _setup(420, 6, seed, block, long_edges)
    (s, conv, iters), (js, jconv, jiters) = _bf_both(c, 64, stripe)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (conv, iters) == (bool(jconv), int(jiters))
    assert conv and iters < 64
    fw = _fw(c)
    assert torch.equal(bs.band_threshold(s, c["r"]),
                       bs.band_threshold(fw, c["r"]))
    inside = (fw <= float(c["r"])) & torch.isfinite(fw)
    torch.testing.assert_close(s[inside], fw[inside], rtol=1e-6, atol=1e-7)
    assert torch.isinf(s[~inside]).all()


def test_band_bf_hop_metric_matches_jax():
    """Hop counts (tests/test_apsp_bandstore.py:258): BF converges in
    radius + 1 rounds and equals JAX's and the FW's indicator."""
    n, block = 300, 64
    coords, edges, _ = _geometric(n, 5, 4)
    w = np.ones(len(edges), np.float32)
    r = 2.0
    order, band = graph_banded_order(n, edges, w, r * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    clamp = np.float32(r * (1 + 1e-6))
    c = _both(n, rank[edges], w, band, block, clamp)
    (s, conv, iters), (js, _, jiters) = _bf_both(c, 32)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert conv and iters == int(jiters) <= int(r) + 1
    assert torch.equal(bs.band_threshold(s, clamp),
                       bs.band_threshold(_fw(c), clamp))


def test_band_bf_unconverged_and_fw_finisher():
    """One round is not enough: converged False, the partial band JAX's;
    the FW from that state reaches the FW's fixpoint
    (tests/test_apsp_bandstore.py:285)."""
    c = _setup(420, 6, 3, 64)
    (s, conv, iters), (js, jconv, jiters) = _bf_both(c, 1)
    assert (conv, iters) == (bool(jconv), int(jiters)) == (False, 1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    finished = bs.apsp_band_fw(s, bt=c["bt"], block=c["block"])
    assert torch.equal(bs.band_threshold(finished, c["r"]),
                       bs.band_threshold(_fw(c), c["r"]))


def test_bf_slots_refuse_an_int8_overflow():
    """A band whose block offsets overflow int8 takes no slots (FW)."""
    pe = np.array([[0, 1]])
    w = np.ones(1, np.float32)
    for band in (100, 126 * 128, 127 * 128):
        got = bs.band_bf_slots(pe[:, 0], pe[:, 1], w, n=300, band=band)
        want = jbs.band_bf_slots(pe[:, 0], pe[:, 1], w, n=300, band=band)
        assert (got is None) == (want is None)
    assert got is None


@pytest.mark.parametrize("n,band,S", [(1000, 100, 12), (100_000, 2000, 16),
                                      (49_920, 1535, 18), (300, 60, 4)])
def test_bf_max_iters_matches_jax(n, band, S):
    assert bs.bf_max_iters(n, band, S) == jbs.bf_max_iters(n, band, S)
    assert 16 <= bs.bf_max_iters(n, band, S) <= 512


# ------------------------------------------------------------------- facade

def _graph(n=500, k=6, seed=2):
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
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


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _values(n, binary, seed=11):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.random((n, 5)) < 0.1).astype(float)
    vals = rng.integers(-8, 9, (n, 2)) / 4  # dyadic: exact f32 sums
    vals[rng.random(n) < 0.25] = np.nan
    return vals


def _runs(graph, vals, relax, staged=False, **settings):
    """(JAX session, port session) run with ``band_relax=relax``; the port
    draws fixed permutations."""
    n = len(vals)
    jsf = JaxSAFE(verbose=False)
    jsf.random_seed = 7
    jsf.apsp_mode = "band"
    jsf.band_relax = relax
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=graph, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(n)]))
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=7,
        device="cpu", **{k: getattr(jsf, k)
                         for k in ENRICHMENT_SETTINGS + BAND_SETTINGS})
    v = int(np.isfinite(vals).any(axis=1).sum())
    perm_idx = np.stack([np.random.default_rng(s).permutation(v)
                         for s in range(20)])
    if staged:
        jsf.define_neighborhoods()
        psf.define_neighborhoods()
        jsf.compute_pvalues(num_permutations=20)
        psf.compute_pvalues(perm_idx=perm_idx)
    else:
        jsf.run_pipeline(num_permutations=20)
        psf.run_pipeline(perm_idx=perm_idx)
    return jsf, psf


@pytest.mark.parametrize("attrs,engine,staged", [
    ("quantitative", "auto", False), ("binary", "auto", False),
    ("binary", "loop", False), ("binary", "auto", True)])
def test_facade_band_relax_bf_matches_fw_and_jax(graph, attrs, engine,
                                                 staged):
    """tests/test_bandstore_facade.py:500 on both packages, through each
    place the facade dispatches the relax: the fused quantitative pipeline,
    the class table's front, the fused tail loop (``loop-band``), and the
    stages. ``_band_relax_used`` is JAX's; BF's results are bitwise the
    FW run's."""
    vals = _values(500, attrs == "binary")
    kw = dict(hypergeom_engine=engine, staged=staged)
    jbf, pbf = _runs(graph, vals, "bf", **kw)
    _, pfw = _runs(graph, vals, "fw", **kw)
    assert pbf._band_relax_used == jbf._band_relax_used == "bf"
    assert pfw._band_relax_used == "fw"
    np.testing.assert_array_equal(pbf._neighborhoods_dev.data.numpy(),
                                  np.asarray(jbf._neighborhoods_dev.data))
    np.testing.assert_array_equal(pbf.neighborhoods, pfw.neighborhoods)
    np.testing.assert_array_equal(pbf.node_distances, jbf.node_distances)
    if attrs == "binary":
        assert pbf._hypergeom_engine_used == jbf._hypergeom_engine_used
        np.testing.assert_array_equal(pbf.nes_binary, pfw.nes_binary)
        np.testing.assert_array_equal(pbf.nes_binary, jbf.nes_binary)
        np.testing.assert_array_equal(pbf.pvalues_pos, pfw.pvalues_pos)
    else:
        np.testing.assert_array_equal(pbf.ns, pfw.ns)
        np.testing.assert_array_equal(pbf.ns, jbf.ns)
        np.testing.assert_array_equal(pbf.counts_neg, pfw.counts_neg)
        np.testing.assert_array_equal(pbf.counts_pos, pfw.counts_pos)


@pytest.mark.parametrize("attrs,engine,staged", [
    ("quantitative", "auto", False), ("binary", "loop", False),
    ("binary", "auto", True)])
def test_unconverged_bf_falls_back_to_fw(graph, monkeypatch, attrs, engine,
                                         staged):
    """A budget of one round (tests/test_bandstore_facade.py:524, both
    packages' ``bf_max_iters`` replaced): the facade runs the FW again,
    records ``"bf->fw"`` as JAX does, and gives the FW run's results."""
    monkeypatch.setattr(jbs, "bf_max_iters", lambda *a, **k: 1)
    monkeypatch.setattr(bs, "bf_max_iters", lambda *a, **k: 1)
    vals = _values(500, attrs == "binary", seed=13)
    kw = dict(hypergeom_engine=engine, staged=staged)
    jfb, pfb = _runs(graph, vals, "bf", **kw)
    _, pfw = _runs(graph, vals, "fw", **kw)
    assert pfb._band_relax_used == jfb._band_relax_used == "bf->fw"
    assert torch.equal(pfb._neighborhoods_dev.data,
                       pfw._neighborhoods_dev.data)
    np.testing.assert_array_equal(pfb.neighborhoods, jfb.neighborhoods)
    if attrs == "binary":
        np.testing.assert_array_equal(pfb.nes_binary, pfw.nes_binary)
        np.testing.assert_array_equal(pfb.nes_binary, jfb.nes_binary)
    else:
        np.testing.assert_array_equal(pfb.counts_neg, pfw.counts_neg)
        np.testing.assert_array_equal(pfb.ns, jfb.ns)
