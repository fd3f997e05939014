"""The band-storage slice end to end: the port's band front and null tail,
as its facade composes them, and its facade against the JAX package's, and
against the port's other engines.

Tolerances: neighborhoods identical; distances within 1e-6 relative inside
the radius; observed scores within 1e-5; null counts exactly equal when
both sides get the same permutations (dyadic attribute values, exact f32
sums in any order); with each package's own RNG, p-values within the
binomial tolerance of tests/test_reference_parity.py:193.
"""


import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path
from scipy.spatial import cKDTree

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu.ops import apsp_banded as jab
from safepy_tpu.ops import apsp_bandstore as jbs
from safepy_tpu.ops import enrich_band as jeb
from safepy_tpu.ops.neighborhoods import inclusive_radius
from safepy_tpu_torch import SAFE
from safepy_tpu_torch import pipeline as pipe
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import apsp_banded as ab
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


N_NODES, N_PERM, SEED = 420, 500, 7


def _arrays(n, k=7, seed=3):
    """(coords, edges, lengths, weights) of a kNN geometric graph."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def _dyadic(n, seed, a_dim=1, nan_share=0.3):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-12, 13, (n, a_dim)) / 4
    vals[rng.random(n) < nan_share] = np.nan
    return vals


def _perm_idx(vals, count, seed):
    v = int(np.isfinite(vals).any(axis=1).sum())
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(v) for _ in range(count)])


def _session(net, vals, mode, **settings):
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = mode
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=vals)
    return sf


def test_fused_band_pipeline_matches_jax_pieces():
    """The port's band front (``band_neighborhoods``) followed by its null
    tail (``_band_perm_tail``), as a band-storage ``run_pipeline`` runs
    them, with an injected perm_idx (original valid order) against the JAX
    band pieces fed the same permutations, mapped into the banded frame
    here with numpy."""
    n, block, P = 500, 64, 40
    coords, edges, lengths, _ = _arrays(n, seed=11)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    r = inclusive_radius(nr)
    order, band = jab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    vals = _dyadic(n, 12, a_dim=2)
    vals_perm = vals[order].astype(np.float32)
    valid_perm = np.isfinite(vals_perm).any(axis=1)
    perm_idx = _perm_idx(vals, P, 13)
    bt = band // block + 1
    starts, w_c = bs.compaction_plan(valid_perm, n=n, bt=bt, block=block)

    dist_band, s_ind, mean, std, converged = pipe.band_neighborhoods(
        torch.as_tensor(pe[:, 0]), torch.as_tensor(pe[:, 1]),
        torch.as_tensor(lengths.astype(np.float32)), r, n=n, band=band,
        block=block)
    assert converged
    obs, counts_neg, counts_pos = pipe._band_perm_tail(
        s_ind, torch.as_tensor(vals_perm),
        torch.as_tensor(vals_perm[valid_perm]), torch.as_tensor(valid_perm),
        torch.as_tensor(starts), torch.as_tensor(rank), None, bt=bt,
        block=block, score_type="sum", num_permutations=P, batch_size=16,
        w_c=w_c, precision="highest", perm_idx=perm_idx)

    s = jbs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                 jnp.asarray(pe[:, 1], jnp.int32),
                                 jnp.asarray(lengths, jnp.float32), n=n,
                                 band=band, block=block)
    s = jbs.apsp_band_fw(s, bt=bt, block=block)
    j_ind = jbs.band_threshold(s, r)
    np.testing.assert_array_equal(s_ind.numpy(), np.asarray(j_ind))
    inside = np.asarray(j_ind) > 0
    np.testing.assert_allclose(dist_band.numpy()[inside],
                               np.asarray(s)[inside], rtol=1e-6)
    assert np.isinf(dist_band.numpy()[~inside]).all()
    _, jmean, jstd = jbs.band_row_stats(j_ind, n=n, bt=bt, block=block)
    np.testing.assert_allclose([float(mean), float(std)],
                               [float(jmean), float(jstd)], rtol=1e-6)

    j_obs = jeb.band_score(j_ind, vals_perm, bt=bt, block=block)
    np.testing.assert_allclose(obs.numpy(), np.asarray(j_obs)[rank],
                               rtol=1e-5, atol=1e-5)
    compact, j_starts, _ = jbs.compact_band_columns(j_ind, valid_perm, bt=bt,
                                                    block=block)
    # permuted position t of a valid row is original valid row sigma[t]
    valid_orig = valid_perm[rank]
    sigma = (np.cumsum(valid_orig) - 1)[order[valid_perm]]
    sigma_inv = np.argsort(sigma)
    q = sigma_inv[perm_idx[:, sigma]]
    vv = np.nan_to_num(vals_perm[valid_perm])
    xb = np.zeros((P, len(vv) + w_c, 2), np.float32)
    xb[:, :len(vv)] = vv[q]
    want = jbs.band_count_batch(compact, jnp.asarray(xb), j_starts, j_obs,
                                jnp.ones(P, bool), bt=bt, block=block)
    np.testing.assert_array_equal(counts_neg.numpy(), np.asarray(want[0])[rank])
    np.testing.assert_array_equal(counts_pos.numpy(), np.asarray(want[1])[rank])


def _graph(n=N_NODES, k=7, seed=3):
    """The graph of _arrays with the node attributes the JAX loaders need."""
    coords, edges, _, _ = _arrays(n, k, seed)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(map(tuple, edges))
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    return g


@pytest.fixture(scope="module",
                params=[("band", 16384), ("auto", 300)],
                ids=["forced-band", "auto-above-min-nodes"])
def facade_runs(request):
    """JAX and port facades on one network and normal attribute. At 420
    nodes the band never beats half the dense bytes, so 'auto' above a
    lowered band_storage_min_nodes must fall back to the banded window."""
    mode, min_nodes = request.param
    vals = np.random.default_rng(4).normal(size=(N_NODES, 1))
    vals[np.random.default_rng(5).random(N_NODES) < 0.3] = np.nan
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode = mode
    jsf.band_storage_min_nodes = min_nodes
    jsf.random_seed = SEED
    jsf.load_network(network_file=_graph(), node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(N_NODES)], columns=["q"]))
    jsf.run_pipeline(num_permutations=N_PERM)
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=jsf.neighborhood_radius,
                           random_seed=SEED, device="cpu")
    psf.apsp_mode = mode
    psf.band_storage_min_nodes = min_nodes
    psf.run_pipeline(num_permutations=N_PERM)
    return mode, jsf, psf


def test_facade_engine_choice_matches_jax(facade_runs):
    mode, jsf, psf = facade_runs
    j_band = [p for p in jsf._bandstore_cache.values() if p is not None]
    if mode == "band":
        assert len(j_band) == 1 and psf.apsp_engine_used == "band-storage"
        assert isinstance(psf._neighborhoods_dev, bs.BandedMatrix)
    else:
        assert not j_band and list(jsf._bandstore_cache.values()) == [None]
        assert psf.apsp_engine_used == "banded-window"
        assert [p is not None for p in jsf._banded_cache.values()] == [True]


def test_facade_results_match_jax(facade_runs):
    _, jsf, psf = facade_runs
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    inside = jsf.neighborhoods.astype(bool)
    np.testing.assert_allclose(psf.node_distances[inside],
                               jsf.node_distances[inside], rtol=1e-6)
    assert (psf.neighborhoods_sparse() != jsf.neighborhoods_sparse()).nnz == 0
    np.testing.assert_array_equal(np.isnan(psf.ns), np.isnan(jsf.ns))
    np.testing.assert_allclose(psf.ns, jsf.ns, rtol=1e-5, atol=1e-5)
    for ours, theirs in ((psf.pvalues_pos, jsf.pvalues_pos),
                         (psf.pvalues_neg, jsf.pvalues_neg)):
        ours, theirs = np.nan_to_num(ours), np.nan_to_num(theirs)
        pooled = (ours + theirs) / 2
        tol = 6 * np.sqrt(pooled * (1 - pooled) * 2 / N_PERM) + 3 / N_PERM
        assert np.all(np.abs(ours - theirs) <= tol)
    assert psf.nes_binary.shape == jsf.nes_binary.shape


def test_band_engine_matches_banded_window_engine():
    """One perm_idx, or one seed, through both engines of the port:
    identical neighborhoods and counts; keep_node_distances=False drops the
    band distances."""
    net = _arrays(N_NODES, seed=21)
    vals = _dyadic(N_NODES, 22)
    perm_idx = _perm_idx(vals, 64, 23)
    runs = {}
    for mode in ("auto", "band"):
        sf = _session(net, vals, mode, keep_node_distances=False)
        sf.run_pipeline(perm_idx=perm_idx)
        runs[mode] = sf
    window, band = runs["auto"], runs["band"]
    assert (window.apsp_engine_used, band.apsp_engine_used) == (
        "banded-window", "band-storage")
    np.testing.assert_array_equal(band.neighborhoods, window.neighborhoods)
    np.testing.assert_array_equal(band.ns, window.ns)
    np.testing.assert_array_equal(band.counts_neg, window.counts_neg)
    np.testing.assert_array_equal(band.counts_pos, window.counts_pos)
    assert band.node_distances is None and window.node_distances is not None
    for sf in runs.values():  # the same seed draws the same permutations
        sf.random_seed = 5
        sf.run_pipeline(num_permutations=100)
    np.testing.assert_array_equal(band.counts_neg, window.counts_neg)
    np.testing.assert_array_equal(band.counts_pos, window.counts_pos)


def test_zscore_band_run_matches_dense_run():
    net = _arrays(300, seed=31)
    vals = _dyadic(300, 32, a_dim=2, nan_share=0.2)
    perm_idx = _perm_idx(vals, 30, 33)
    runs = [_session(net, vals, mode) for mode in ("band", "full")]
    for sf in runs:
        sf.run_pipeline(perm_idx=perm_idx, neighborhood_score_type="z-score")
    band, dense = runs
    np.testing.assert_array_equal(np.isnan(band.ns), np.isnan(dense.ns))
    np.testing.assert_allclose(band.ns, dense.ns, rtol=1e-5, atol=1e-5)
    fin = np.isfinite(dense.ns)
    assert fin.mean() > 0.5
    np.testing.assert_array_equal(band.counts_neg[fin], dense.counts_neg[fin])


def test_graph_banded_order_and_shortpath_band_run():
    n = 300
    coords, edges, _, weights = _arrays(n, k=5, seed=41)
    for radius in (2.0, 3.5):
        got = ab.graph_banded_order(n, edges, weights, radius)
        want = jab.graph_banded_order(n, edges, weights, radius)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[1] < n
    vals = np.random.default_rng(42).normal(size=(n, 1))
    sf = _session((coords, edges, None, weights), vals, "band",
                  node_distance_metric="shortpath", neighborhood_radius=2)
    sf.run_pipeline(num_permutations=20)
    assert sf.apsp_engine_used == "band-storage"
    a = coo_matrix((weights, tuple(edges.T)), shape=(n, n))
    hops = shortest_path(a.maximum(a.T), method="D", directed=False)
    np.testing.assert_array_equal(sf.neighborhoods.astype(bool), hops <= 2)


def _small_band_session(**settings):
    return _session(_arrays(200, seed=51),
                    np.random.default_rng(52).normal(size=(200, 1)), "band",
                    **settings)


@pytest.mark.parametrize("setting,value,item", [
    ("mesh", {"data": 1}, "A10")])
def test_still_refused_band_options_raise(setting, value, item, tmp_path):
    """A bit-packed indicator band on a 'data' mesh was refused, naming
    ROADMAP ``item``, until the rest of the row-sharded band engine was
    ported. Now, on a one-rank 'data' mesh (gloo in this process), a packed
    band session runs the sharded engine and gives the single-device
    packed run's band bytes, scores and counts with the same
    permutations."""
    import torch.distributed as dist
    from safepy_tpu_torch.parallel import make_mesh

    perm_idx = np.stack([np.random.default_rng(60 + i).permutation(200)
                         for i in range(20)])
    single = _small_band_session(band_indicator_bits=True)
    single.run_pipeline(perm_idx=perm_idx)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1)
    try:
        sf = _small_band_session(band_indicator_bits=True, **{
            setting: make_mesh(value, device_type="cpu")})
        sf.run_pipeline(perm_idx=perm_idx)
    finally:
        dist.destroy_process_group()
    assert item == "A10" and sf.apsp_engine_used == "band-storage"
    assert sf._neighborhoods_dev.data.dtype == torch.uint8
    np.testing.assert_array_equal(sf._neighborhoods_dev.data.numpy(),
                                  single._neighborhoods_dev.data.numpy())
    for name in ("ns", "counts_neg", "counts_pos"):
        np.testing.assert_array_equal(getattr(sf, name),
                                      getattr(single, name))


@pytest.mark.parametrize("setting,value", [
    ("band_relax", "bf"), ("band_indicator_bits", True),
    ("band_bits_min_bytes", 1), ("node_distance_metric", "euclidean")])
def test_formerly_refused_band_options_match_jax(setting, value):
    """The A7 remainder (the sparse Bellman-Ford relax, the bit-packed
    indicator, forced or past band_bits_min_bytes, and the euclidean band
    form), refused until it was ported, runs over band storage and equals
    the JAX package's run with the same settings, carried across by
    from_numpy_state: the band and the relax that made it bitwise, the
    distances (bitwise where both relax alike), the scores, and the counts
    of the same permutations."""
    n = 200
    vals = _dyadic(n, 52, a_dim=2)
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode = "band"
    jsf.random_seed = SEED
    setattr(jsf, setting, value)
    jsf.load_network(network_file=_graph(n, seed=51), node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(n)]))
    jsf.run_pipeline(num_permutations=20)
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=None,
        device="cpu", **{k: getattr(jsf, k)
                         for k in ENRICHMENT_SETTINGS + BAND_SETTINGS})
    perm_idx = _perm_idx(vals, 32, 53)
    psf.run_pipeline(perm_idx=perm_idx)

    assert psf.apsp_engine_used == "band-storage"
    assert psf._band_relax_used == jsf._band_relax_used
    pb, jb = psf._neighborhoods_dev, jsf._neighborhoods_dev
    np.testing.assert_array_equal(pb.rank, jb.rank)
    np.testing.assert_array_equal(pb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    if setting in ("band_relax", "node_distance_metric"):
        np.testing.assert_array_equal(psf.node_distances, jsf.node_distances)
    else:  # the symmetric FW mirrors tiles: last-bit differences inside
        inside = jsf.neighborhoods.astype(bool)
        np.testing.assert_allclose(psf.node_distances[inside],
                                   jsf.node_distances[inside], rtol=1e-6)
    np.testing.assert_array_equal(psf.ns, jsf.ns)
    valid = np.flatnonzero(np.isfinite(vals).any(axis=1))
    nv = jsf.neighborhoods[:, valid].astype(np.float32)
    scores = np.einsum("nv,cva->cna", nv,
                       np.nan_to_num(vals[valid])[perm_idx].astype(np.float32))
    np.testing.assert_array_equal(psf.counts_neg,
                                  (scores <= jsf.ns[None]).sum(0))
    np.testing.assert_array_equal(psf.counts_pos,
                                  (scores >= jsf.ns[None]).sum(0))


def test_band_binary_attributes_raise_and_quantitative_runs():
    """Both kinds of attribute run over band storage. The binary one (the
    band GO engines, refused until they were ported) takes the class table
    and equals the JAX package's run on the same network (the indicator,
    the neighborhoods and the counts exactly; tests/test_torch_band_go.py
    holds every engine)."""
    sf = _small_band_session()
    sf.run_pipeline(num_permutations=20)
    assert sf.apsp_engine_used == "band-storage"
    assert np.isfinite(sf.ns).all() and sf.nes.shape == (200, 1)
    assert sf.node_distances_sparse().nnz == sf.neighborhoods.sum()
    binary = (np.arange(200) % 2).astype(float)
    sf.load_attributes(attribute_file=binary)
    sf.run_pipeline(num_permutations=20)
    assert sf._hypergeom_engine_used == "table-band"
    assert sf.nes_binary.shape == (200, 1)

    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode = "band"
    jsf.load_network(network_file=_graph(200, seed=51),
                     node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        binary[:, None], index=[f"g{i}" for i in range(200)], columns=["b"]))
    jsf.run_pipeline()
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=jsf.neighborhood_radius,
                           random_seed=None, device="cpu")
    psf.apsp_mode = "band"
    psf.run_pipeline()
    assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    np.testing.assert_array_equal(
        psf.attributes["num_neighborhoods_enriched"],
        jsf.attributes["num_neighborhoods_enriched"].to_numpy())
