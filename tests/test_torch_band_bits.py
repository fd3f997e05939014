"""The bit-packed indicator band of the port (safepy_tpu_torch/ops/
apsp_bandstore.py, uint8, 8 cells a byte, LSB-first) against the JAX
package's (safepy_tpu/ops/apsp_bandstore.py:102-151), on the same seeded
numpy inputs, as tests/test_band_bits.py holds JAX's against its own int8
band.

Tolerances: packed bytes, indicators, compactions, counts and per-row sizes
bitwise (their f32 mean and std within 1e-6: another summation order);
banded products of a packed band bitwise the int8 band's (the same f32
operands in the same order); facade runs, packed against plain, in
either package, bitwise; against the JAX facade, scores exact on dyadic
values and counts exact with the same permutations.
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


@pytest.fixture(scope="module")
def band_setup():
    """tests/test_band_bits.py:19's band: 700 points, band 60, radius 0.08,
    built by both packages, plain and packed."""
    rng = np.random.default_rng(3)
    n, band = 700, 60
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rank = np.argsort(np.argsort(coords[:, 0]))
    cp = coords[np.argsort(rank)]
    r = np.float32(0.08)
    out = dict(n=n, band=band, rank=rank, rng=rng, bt=band // 128 + 1)
    for packed in (False, True):
        tag = "packed" if packed else "plain"
        out[tag] = bs.euclidean_band_indicator(torch.as_tensor(cp), r, n=n,
                                               band=band, packed=packed)
        out["j_" + tag] = np.asarray(jbs.euclidean_band_indicator(
            jnp.asarray(cp), r, n=n, band=band, packed=packed))
    out["dist"] = bs.euclidean_band_distances(torch.as_tensor(cp), n=n,
                                              band=band)
    return out


def test_pack_roundtrip_matches_jax(band_setup):
    plain, packed = band_setup["plain"], band_setup["packed"]
    assert packed.dtype == torch.uint8 and plain.dtype == torch.int8
    assert bs.is_packed_bits(packed) and not bs.is_packed_bits(plain)
    assert packed.shape == (plain.shape[0], plain.shape[1] // 8)
    np.testing.assert_array_equal(packed.numpy(), band_setup["j_packed"])
    np.testing.assert_array_equal(plain.numpy(), band_setup["j_plain"])
    assert torch.equal(bs.unpack_band_bits(packed), plain)
    np.testing.assert_array_equal(bs.unpack_band_bits_host(packed),
                                  plain.numpy())
    assert torch.equal(bs.pack_band_bits(plain), packed)
    np.testing.assert_array_equal(
        bs.pack_band_bits(plain).numpy(),
        np.asarray(jbs.pack_band_bits(jnp.asarray(plain.numpy()))))


@pytest.mark.parametrize("chunk_blocks", [256, 3])
def test_band_threshold_packed_matches_jax(band_setup, chunk_blocks):
    """The packed threshold of a distance band, in row chunks that do and
    do not divide the band, equals JAX's bytes and packs the int8 one."""
    s = band_setup["dist"]
    r = np.float32(0.08)
    got = bs.band_threshold(s, r, packed=True, chunk_blocks=chunk_blocks)
    want = jbs.band_threshold(jnp.asarray(s.numpy()), r, packed=True,
                              chunk_blocks=chunk_blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, bs.pack_band_bits(bs.band_threshold(s, r)))


def test_row_stats_match_jax(band_setup):
    n, bt = band_setup["n"], band_setup["bt"]
    want = jbs.band_row_stats(jnp.asarray(band_setup["j_packed"]), n=n, bt=bt)
    for tag in ("plain", "packed"):
        sizes, mean, std = bs.band_row_stats(band_setup[tag], n=n, bt=bt)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want[0]))
        # f32 means of the same sizes, summed in another order
        np.testing.assert_allclose([float(mean), float(std)],
                                   [float(want[1]), float(want[2])],
                                   rtol=1e-6)


def test_band_matmul_packed_matches_plain(band_setup):
    bt = band_setup["bt"]
    x = torch.as_tensor(band_setup["rng"].normal(size=(768, 3)),
                        dtype=torch.float32)
    got = bs.band_matmul(band_setup["packed"], x, bt=bt)
    assert torch.equal(got, bs.band_matmul(band_setup["plain"], x, bt=bt))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbs.band_matmul(
            jnp.asarray(band_setup["j_packed"]), jnp.asarray(x.numpy()),
            bt=bt)), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def compactions(band_setup):
    n, bt, rng = band_setup["n"], band_setup["bt"], band_setup["rng"]
    valid = rng.random(n) < 0.66
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt)
    return dict(valid=valid, starts=starts, w_c=w_c, **{
        tag: bs.apply_compaction(band_setup[tag], valid, w_c, bt=bt)
        for tag in ("plain", "packed")})


def test_compaction_packed_in_packed_out(band_setup, compactions):
    """Packed in, packed out, group by group: JAX's bytes, and the int8
    compaction packed; the batched product against it equals the int8
    compaction's."""
    bt, c = band_setup["bt"], compactions
    assert c["packed"].dtype == torch.uint8
    want = jbs.apply_compaction(jnp.asarray(band_setup["j_packed"]),
                                jnp.asarray(c["valid"]), c["w_c"], bt=bt)
    np.testing.assert_array_equal(c["packed"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(bs.unpack_band_bits_host(c["packed"]),
                                  c["plain"].numpy())
    xb = torch.as_tensor(band_setup["rng"].normal(
        size=(2, int(c["valid"].sum()) + c["w_c"], 2)), dtype=torch.float32)
    assert torch.equal(
        bs.band_matmul_batch(c["packed"], xb, c["starts"], bt=bt),
        bs.band_matmul_batch(c["plain"], xb, c["starts"], bt=bt))


def test_band_count_batch_packed_matches_jax(band_setup, compactions):
    """tests/test_band_bits.py:88: the fused counter over the packed
    compaction equals JAX's and the int8 compaction's."""
    bt, c, rng = band_setup["bt"], compactions, band_setup["rng"]
    V = int(c["valid"].sum())
    xb = rng.normal(size=(5, V + c["w_c"], 2)).astype(np.float32)
    npad = band_setup["plain"].shape[0] - 2 * bt * 128
    obs = rng.normal(size=(npad, 2)).astype(np.float32)
    live = np.array([True, True, True, False, False])
    j_packed = jbs.apply_compaction(jnp.asarray(band_setup["j_packed"]),
                                    jnp.asarray(c["valid"]), c["w_c"], bt=bt)
    want = jbs.band_count_batch(j_packed, jnp.asarray(xb),
                                jnp.asarray(c["starts"], jnp.int32),
                                jnp.asarray(obs), jnp.asarray(live), bt=bt)
    for tag in ("plain", "packed"):
        cn, cp = bs.band_count_batch(c[tag], torch.as_tensor(xb),
                                     c["starts"], torch.as_tensor(obs),
                                     torch.as_tensor(live), bt=bt)
        np.testing.assert_array_equal(cn.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(cp.numpy(), np.asarray(want[1]))


def test_banded_matrix_accessors_read_packed(band_setup):
    n, band, rank = band_setup["n"], band_setup["band"], band_setup["rank"]
    b1 = bs.BandedMatrix(band_setup["plain"], rank, n, band, fill=0.0)
    b2 = bs.BandedMatrix(band_setup["packed"], rank, n, band, fill=0.0)
    jb = jbs.BandedMatrix(band_setup["j_packed"], rank, n, band, fill=0.0)
    np.testing.assert_array_equal(b2.to_dense(), b1.to_dense())
    np.testing.assert_array_equal(b2.to_dense(), jb.to_dense())
    assert (b1.to_sparse() != b2.to_sparse()).nnz == 0
    assert (jb.to_sparse() != b2.to_sparse()).nnz == 0
    np.testing.assert_array_equal(
        bs.unpack_band(band_setup["packed"], n, band, fill=0),
        jbs.unpack_band(band_setup["j_packed"], n, band, fill=0))


# ------------------------------------------------------------------ facades

def _scatter(n, seed):
    """A scatter input: points and no edges, as the JAX loaders take it."""
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        g.nodes[i].update(label=f"c{i}", key=f"c{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    return g


def _knn(n, seed, k=7):
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from({(min(i, int(j)), max(i, int(j)))
                      for i in range(n) for j in nn[i, 1:]})
    for i in range(n):
        g.nodes[i].update(label=f"c{i}", key=f"c{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    return g


def _values(n, seed, binary):
    rng = np.random.default_rng(seed)
    if binary:
        return (rng.random((n, 3)) < 0.12).astype(float)
    vals = rng.integers(-8, 9, (n, 2)) / 4  # dyadic: exact f32 sums
    vals[rng.random((n, 2)) < 0.3] = np.nan
    return vals


def _runs(graph, vals, bits, *, staged=False, **settings):
    """(JAX session, port session) with ``band_indicator_bits=bits`` and
    the same settings, run fused, or staged by define_neighborhoods +
    compute_pvalues; the port takes fixed permutations."""
    n = len(vals)
    jsf = JaxSAFE(verbose=False)
    jsf.random_seed = 23
    jsf.apsp_mode = "band"
    jsf.band_indicator_bits = bits
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=graph, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"c{i}" for i in range(n)]))
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=23,
        device="cpu", **{k: getattr(jsf, k)
                         for k in ENRICHMENT_SETTINGS + BAND_SETTINGS})
    v = int(np.isfinite(vals).any(axis=1).sum())
    perm_idx = np.stack([np.random.default_rng(s).permutation(v)
                         for s in range(24)])
    if staged:
        jsf.define_neighborhoods()
        jsf.compute_pvalues(num_permutations=24)
        psf.define_neighborhoods()
        psf.compute_pvalues(perm_idx=perm_idx)
    else:
        jsf.run_pipeline(num_permutations=24)
        psf.run_pipeline(perm_idx=perm_idx)
    return jsf, psf


@pytest.mark.parametrize("case", [
    "euclid fused", "euclid staged binary", "graph fused", "graph table"])
def test_facade_packed_matches_plain_and_jax(case):
    """tests/test_band_bits.py:157, :174, :252 and :269 on both packages:
    the euclidean band without kept distances (fused quantitative, and
    staged with binary terms), the graph band's quantitative pipeline and
    its class-table engine. The stored band is packed, its bytes JAX's;
    the packed run equals the int8 run bitwise, and both equal JAX's."""
    euclid = case.startswith("euclid")
    binary = "binary" in case or "table" in case
    n = 500
    graph = _scatter(n, 11) if euclid else _knn(n, 29)
    vals = _values(n, 7, binary)
    settings = (dict(node_distance_metric="euclidean",
                     keep_node_distances=False, neighborhood_radius=0.12)
                if euclid else {})
    staged = "staged" in case
    runs = {bits: _runs(graph, vals, bits, staged=staged, **settings)
            for bits in (False, True)}
    (jp, pp), (jk, pk) = runs[False], runs[True]
    assert pk._neighborhoods_dev.data.dtype == torch.uint8
    assert pp._neighborhoods_dev.data.dtype == torch.int8
    np.testing.assert_array_equal(pk._neighborhoods_dev.data.numpy(),
                                  np.asarray(jk._neighborhoods_dev.data))
    np.testing.assert_array_equal(pk.neighborhoods_sparse().toarray(),
                                  pp.neighborhoods_sparse().toarray())
    np.testing.assert_array_equal(pk.neighborhoods, jk.neighborhoods)
    if binary:
        assert pk._hypergeom_engine_used == pp._hypergeom_engine_used
        assert pk._hypergeom_engine_used == jk._hypergeom_engine_used
        np.testing.assert_array_equal(pk.nes_binary, pp.nes_binary)
        np.testing.assert_array_equal(pk.nes_binary, jk.nes_binary)
        np.testing.assert_array_equal(pk.pvalues_pos, pp.pvalues_pos)
        np.testing.assert_array_equal(np.asarray(jk.nes), np.asarray(jp.nes))
    else:
        np.testing.assert_array_equal(pk.ns, pp.ns)
        np.testing.assert_array_equal(pk.ns, jk.ns)
        np.testing.assert_array_equal(pk.counts_neg, pp.counts_neg)
        np.testing.assert_array_equal(pk.counts_pos, pp.counts_pos)
        np.testing.assert_array_equal(jk.ns, jp.ns)
