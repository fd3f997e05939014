"""The port's band storage (safepy_tpu_torch/ops/apsp_bandstore.py) against
the JAX package's (safepy_tpu/ops/apsp_bandstore.py), on the same seeded
numpy inputs.

On the CPU the kernel wrappers run their plain torch versions; the JAX skew
kernels run in Pallas interpret mode, as tests/test_apsp_bandstore.py runs
them. Storage, initialization, the skew kernels, the FW and the compaction
are compared bitwise (each min-plus candidate is one f32 rounding and min is
exact); banded scores within 1e-5 (the matmul sums associate differently);
the fused counts exactly, on dyadic values whose f32 sums are exact in any
order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path
from scipy.spatial import cKDTree

from safepy_tpu.ops import apsp_bandstore as jbs
from safepy_tpu.ops.apsp_banded import banded_order
from safepy_tpu.ops.neighborhoods import inclusive_radius
from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.ops import apsp_cuda as K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _inf_laced(rng, shape, inf_share=0.3):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    x[rng.random(shape) < inf_share] = np.inf
    return x


def _geometric(n, k, seed, radius_frac=0.1, long_edges=0):
    """kNN geometric graph in banded order: (edges, lengths, nr, rank,
    band); optional random long edges exercise the out-of-band drop."""
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
    nr = radius_frac * (coords[:, 0].max() - coords[:, 0].min())
    order, band = banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return edges, w, nr, rank, band


def _init_both(n, edges, w, rank, band, block):
    pe = rank[edges]
    want = jbs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                    jnp.asarray(pe[:, 1], jnp.int32),
                                    jnp.asarray(w, jnp.float32),
                                    n=n, band=band, block=block)
    got = bs.band_init_from_edges(_t(pe[:, 0]), _t(pe[:, 1]),
                                  _t(w.astype(np.float32)), n=n, band=band,
                                  block=block)
    return got, want


@pytest.mark.parametrize("n,band,block", [(150, 40, 64), (300, 70, 32),
                                          (97, 200, 32)])
def test_storage_geometry_matches_jax(n, band, block):
    assert bs.band_params(n, band, block) == jbs.band_params(n, band, block)
    assert bs.band_nbytes(n, band, block, 1) == jbs.band_nbytes(n, band,
                                                                block, 1)
    rng = np.random.default_rng(n)
    dense = _inf_laced(rng, (n, n))
    s = bs.pack_band(dense, band, block)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jbs.pack_band(dense, band, block)))
    for fill in (np.inf, 0.0):
        np.testing.assert_array_equal(
            bs.unpack_band(s, n, band, block, fill=fill),
            jbs.unpack_band(np.asarray(s), n, band, block, fill=fill))


@pytest.mark.parametrize("seed,long_edges", [(0, 0), (3, 25)])
def test_band_init_and_banded_matrix_match_jax(seed, long_edges):
    n, block = 300, 32
    edges, w, nr, rank, band = _geometric(n, 6, seed, long_edges=long_edges)
    got, want = _init_both(n, edges, w, rank, band, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for data, fill in ((got, np.inf), (bs.band_threshold(got, 0.05), 0.0)):
        ours = bs.BandedMatrix(data, rank, n, band, block, fill=fill)
        theirs = jbs.BandedMatrix(np.asarray(data), rank, n, band, block,
                                  fill=fill)
        np.testing.assert_array_equal(ours.to_dense(), theirs.to_dense())
        a, b = ours.to_sparse(), theirs.to_sparse()
        assert (a != b).nnz == 0 and a.nnz == b.nnz > n // 2
        assert ours.to_host().data.device.type == "cpu"
    big = bs.BandedMatrix(got, rank, 30_000, band)
    with pytest.raises(MemoryError, match="disabled at band-storage scale"):
        big.to_dense()


def _skew_case(bt, block, seed):
    rng = np.random.default_rng(seed)
    w = (2 * bt + 1) * block
    win = _inf_laced(rng, (w, w))
    win = np.minimum(win, win.T)
    p = _inf_laced(rng, (block, w))
    p_ext = np.pad(p, ((0, 0), (bt * block, bt * block)),
                   constant_values=np.inf)
    return win, p, p_ext


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bt", [1, 3])
def test_skew_kernels_match_pallas(symmetric, bt):
    """The plain versions against the Pallas kernels on +inf-laced windows:
    Q is the window's own pivot column, snapshotted as the facade does."""
    block = 32
    win, p, p_ext = _skew_case(bt, block, 10 * bt + symmetric)
    fn = jbs._relax_skew_sym_pallas if symmetric else jbs._relax_skew_pallas
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(win), jnp.asarray(p_ext), bt=bt,
                             block=block))
    got = _t(win.copy())
    q = bs.skew_pivot_column(got, bt, block)
    (K.relax_skew_sym if symmetric else K.relax_skew)(got, q, _t(p), bt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, win)  # the relax changed something


def _relax_by_tiles(win, q, p, bt, tiles):
    """What the CUDA skew kernels do with their tile list, one CTA a row:
    tile (o, j) becomes min(C, Q_o (x) P_{o + j - bt}) and, where mo >= 0,
    its transpose goes into tile (mo, mj). Every listed tile is read before
    any is written, as the kernels' no-overlap argument requires."""
    block = q.shape[1]

    def tile(x, r, c):
        return x[r * block:(r + 1) * block, c * block:(c + 1) * block]

    rows = tiles.tolist()
    relaxed = [K.relax_panel_plain(tile(win, o, j),
                                   q[o * block:(o + 1) * block],
                                   p[:, (o + j - bt) * block:
                                     (o + j - bt + 1) * block])
               for o, j, _, _ in rows]
    for (o, j, mo, mj), r in zip(rows, relaxed):
        tile(win, o, j).copy_(r)
        if mo >= 0:
            tile(win, mo, mj).copy_(r.T)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bt", [0, 1, 2, 3])
def test_skew_tile_list_gives_the_plain_versions(symmetric, bt):
    """The skew kernels' tile list, applied tile by tile, is bitwise the
    plain version (the masks of relax_skew_sym_plain / relax_skew_plain)."""
    block = 16
    win, p, _ = _skew_case(bt, block, 40 + 2 * bt + symmetric)
    tiles = K.skew_tiles(bt, symmetric)
    got, want = _t(win.copy()), _t(win.copy())
    q = bs.skew_pivot_column(got, bt, block).clone()
    _relax_by_tiles(got, q, _t(p), bt, tiles)
    (K.relax_skew_sym_plain if symmetric else K.relax_skew_plain)(
        want, q, _t(p), bt)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bt", [0, 1, 2, 12])
def test_skew_tile_list_is_live_tiles_only(bt):
    """One row a live tile: no tile twice, every relaxed tile's P tile in
    the pivot-row slab, no mirror among the relaxed tiles (the in-place
    safety argument), and 247 / 469 tiles at the band slice's bt 12."""
    nt = 2 * bt + 1
    sym, full = K.skew_tiles(bt, True), K.skew_tiles(bt, False)
    assert sym.dtype == full.dtype == torch.int32
    assert len(sym) == (bt + 1) * nt - bt * (bt + 1) // 2
    assert len(full) == sum(abs(o + j - 2 * bt) <= bt
                            for o in range(nt) for j in range(nt))
    if bt == 12:
        assert (len(sym), len(full)) == (247, 469)
    for tiles in (sym, full):
        o, j = tiles[:, 0], tiles[:, 1]
        assert len({(a, b) for a, b in zip(o.tolist(), j.tolist())}) == len(
            tiles)
        assert ((o + j - bt >= 0) & (o + j - bt < nt)).all()
    assert (full[:, 2:] == -1).all()
    mirrors = {tuple(m) for m in sym[:, 2:].tolist() if m[0] >= 0}
    assert len(mirrors) == len(sym) - nt
    assert not mirrors & {tuple(t) for t in sym[:, :2].tolist()}


def test_skew_wrappers_check_inputs_and_count_no_cpu_launches():
    bt, block = 1, 32
    win, p, _ = _skew_case(bt, block, 0)
    win = _t(win)
    q = bs.skew_pivot_column(win, bt, block)
    K.reset_launches()
    K.relax_skew_sym(win, q, _t(p), bt)
    K.relax_skew(win, q, _t(p), bt)
    assert set(K.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="bad skewed window"):
        K.relax_skew_sym(win, q, _t(p), 2)
    with pytest.raises(ValueError, match="bad skewed window"):
        K.relax_skew(win[:64, :64], q, _t(p), bt)
    with pytest.raises(ValueError, match="no min-plus kernel"):
        K.relax_skew(win.to("meta"), q.to("meta"), _t(p).to("meta"), bt)


@pytest.mark.parametrize("n,block,seed,radius_frac", [(384, 64, 1, 0.1),
                                                      (420, 32, 2, 0.18)])
def test_band_fw_symmetric_matches_pallas(n, block, seed, radius_frac):
    edges, w, nr, rank, band = _geometric(n, 6, seed, radius_frac)
    got, s0 = _init_both(n, edges, w, rank, band, block)
    bt = band // block + 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jbs.apsp_band_fw(s0, bt=bt, block=block,
                                           use_pallas=True, symmetric=True))
    out = bs.apsp_band_fw(got, bt=bt, block=block, symmetric=True)
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def _oracle(n, edges, w):
    a = coo_matrix((w, tuple(edges.T)), shape=(n, n))
    return shortest_path(a.maximum(a.T), method="D", directed=False)


@pytest.mark.parametrize("seed,long_edges", [(0, 0), (3, 25)])
def test_band_fw_classic_matches_jnp_and_dijkstra(seed, long_edges):
    """symmetric=False bitwise against the JAX jnp FW; both forms give the
    scipy Dijkstra indicator, and the population stats of its row sizes."""
    n, block = 600, 64
    edges, w, nr, rank, band = _geometric(n, 7, seed, long_edges=long_edges)
    got, s0 = _init_both(n, edges, w, rank, band, block)
    bt = band // block + 1
    want = np.asarray(jbs.apsp_band_fw(s0, bt=bt, block=block,
                                       use_pallas=False))
    sym = got.clone()
    bs.apsp_band_fw(got, bt=bt, block=block, symmetric=False)
    np.testing.assert_array_equal(got.numpy(), want)

    r = inclusive_radius(nr)
    ref = _oracle(n, edges, w) <= float(r)
    bs.apsp_band_fw(sym, bt=bt, block=block)
    for s in (got, sym):
        s_ind = bs.band_threshold(s, r)
        dense = bs.unpack_band(s_ind, n, band, block, fill=0)
        np.testing.assert_array_equal(dense[rank][:, rank].astype(bool), ref)
    sizes, mean, std = bs.band_row_stats(s_ind, n=n, bt=bt, block=block)
    jsizes, jmean, jstd = jbs.band_row_stats(jnp.asarray(s_ind.numpy()),
                                             n=n, bt=bt, block=block)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    np.testing.assert_allclose([float(mean), float(std)],
                               [float(jmean), float(jstd)], rtol=1e-6)
    np.testing.assert_allclose(float(std), ref.sum(1).std(), rtol=1e-6)


def _thresholded(n, block, seed):
    edges, w, nr, rank, band = _geometric(n, 6, seed)
    s, _ = _init_both(n, edges, w, rank, band, block)
    bt = band // block + 1
    bs.apsp_band_fw(s, bt=bt, block=block)
    return bs.band_threshold(s, inclusive_radius(nr)), bt


def test_band_matmul_and_batch_match_jax():
    n, block, a_dim, c_dim = 500, 64, 3, 4
    s_ind, bt = _thresholded(n, block, 4)
    rng = np.random.default_rng(0)
    npad = -(-n // block) * block
    x = np.zeros((npad, a_dim), np.float32)
    x[:n] = rng.normal(size=(n, a_dim))
    j_ind = jnp.asarray(s_ind.numpy())
    np.testing.assert_allclose(
        bs.band_matmul(s_ind, _t(x), bt=bt, block=block).numpy(),
        np.asarray(jbs.band_matmul(j_ind, jnp.asarray(x), bt=bt, block=block)),
        rtol=1e-5, atol=1e-5)

    valid = rng.random(n) < 0.7
    compact, starts, w_c = bs.compact_band_columns(s_ind, valid, bt=bt,
                                                   block=block)
    v = int(valid.sum())
    xb = np.zeros((c_dim, v + w_c, a_dim), np.float32)
    xb[:, :v] = rng.normal(size=(c_dim, v, a_dim))
    got = bs.band_matmul_batch(compact, _t(xb), starts, bt=bt, block=block)
    want = jbs.band_matmul_batch(jnp.asarray(compact.numpy()), jnp.asarray(xb),
                                 jnp.asarray(starts.numpy(), jnp.int32),
                                 bt=bt, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed,valid_share", [(5, 0.7), (6, 1.0)])
def test_compaction_matches_jax(seed, valid_share):
    n, block = 500, 64
    s_ind, bt = _thresholded(n, block, seed)
    valid = np.random.default_rng(seed).random(n) < valid_share
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt, block=block)
    jstarts, jw_c = jbs.compaction_plan(valid, n=n, bt=bt, block=block)
    np.testing.assert_array_equal(starts, jstarts)
    assert w_c == jw_c
    got = bs.apply_compaction(s_ind, valid, w_c, bt=bt, block=block)
    want = jbs.apply_compaction(jnp.asarray(s_ind.numpy()), valid, w_c, bt=bt,
                                block=block)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_count_batch_exact_against_jax():
    """Same permuted operands (vals[perm_idx], padded), same obs, same live
    mask: exact counts, ties included (dyadic values, exact sums)."""
    n, block, a_dim, c_dim = 500, 64, 2, 12
    s_ind, bt = _thresholded(n, block, 7)
    rng = np.random.default_rng(3)
    valid = rng.random(n) < 0.75
    compact, starts, w_c = bs.compact_band_columns(s_ind, valid, bt=bt,
                                                   block=block)
    v = int(valid.sum())
    vals = (rng.integers(-8, 9, (v, a_dim)) / 4).astype(np.float32)
    perm_idx = np.stack([rng.permutation(v) for _ in range(c_dim)])
    xb = np.zeros((c_dim, v + w_c, a_dim), np.float32)
    xb[:, :v] = vals[perm_idx]
    npad = -(-n // block) * block
    obs = (rng.integers(-8, 9, (npad, a_dim)) / 4).astype(np.float32)
    live = np.arange(c_dim) < c_dim - 3  # a last, partial chunk
    got = bs.band_count_batch(compact, _t(xb), starts, _t(obs), _t(live),
                              bt=bt, block=block)
    want = jbs.band_count_batch(jnp.asarray(compact.numpy()), jnp.asarray(xb),
                                jnp.asarray(starts.numpy(), jnp.int32),
                                jnp.asarray(obs), jnp.asarray(live), bt=bt,
                                block=block)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0
    all_live = bs.band_count_batch(compact, _t(xb), starts, _t(obs), bt=bt,
                                   block=block)
    assert (all_live[0] >= got[0]).all() and (all_live[1] >= got[1]).all()


@pytest.mark.parametrize("block,k", [(32, 32), (64, 64)])
def test_out_forms_equal_the_allocating_forms(block, k):
    """close_diag and relax_panel into a reused buffer, as a band round
    calls them, give what their allocating forms give, and refuse a buffer
    of another shape or one that is an operand."""
    rng = np.random.default_rng(block)
    tile = _t(_inf_laced(rng, (block, block)))
    tile.diagonal().zero_()
    out = torch.full((block, block), -1.0)
    assert K.close_diag(tile, out=out) is out
    assert torch.equal(out, K.close_diag(tile))
    row = _t(_inf_laced(rng, (k, 3 * block)))
    diag = K.close_diag(row[:, block:block + k].contiguous())
    out = torch.full((k, 3 * block), -1.0)
    assert K.relax_panel(row, diag, row, out=out) is out
    assert torch.equal(out, K.relax_panel(row, diag, row))
    with pytest.raises(ValueError, match="out must be"):
        K.relax_panel(row, diag, row, out=torch.empty((k, block)))
    with pytest.raises(ValueError, match="apart from its operands"):
        K.relax_panel(row, diag, row, out=row)
    with pytest.raises(ValueError, match="out must be"):
        K.close_diag(tile, out=torch.empty((block, block), dtype=torch.float64))


@pytest.mark.parametrize("bt,extra", [(0, 0), (1, 0), (3, 0), (2, 40)],
                         ids=["bt0", "bt1", "bt3", "bt2-wider-band"])
def test_pivot_column_view_gives_the_gathered_tiles(bt, extra):
    """skew_pivot_column's strided view, into a new tensor or a reused
    buffer, holds tiles (o, 2 bt - o) of the window, as the advanced-index
    gather of the same tiles does; also for a window that is a view at
    column 8 of a wider band."""
    block = 16
    nt = 2 * bt + 1
    w = nt * block
    rng = np.random.default_rng(bt)
    band = _t(_inf_laced(rng, (w + 2 * block, w + extra)))
    c0 = 8 if extra else 0
    win = band[block:block + w, c0:c0 + w]
    o = torch.arange(nt)
    want = win.reshape(nt, block, nt, block)[o, :, 2 * bt - o, :].reshape(
        w, block)
    assert torch.equal(bs.skew_pivot_column(win, bt, block), want)
    out = torch.full((w, block), -1.0)
    assert bs.skew_pivot_column(win, bt, block, out=out) is out
    assert torch.equal(out, want)


def test_cpu_band_fw_runs_eagerly_and_counts():
    """A CPU band never reaches the CUDA graph path: every call runs the
    rounds on the host, counts as eager and leaves no graph entry; the
    workspace a call reuses changes no bit of the rounds' result."""
    n, block = 384, 64
    edges, w, nr, rank, band = _geometric(n, 6, 9)
    s, _ = _init_both(n, edges, w, rank, band, block)
    bt = band // block + 1
    nb = s.shape[0] // block - 2 * bt
    want = s.clone()
    for kb in range(nb):  # a fresh workspace every round
        bs.band_fw_round(want, kb, bt=bt, block=block)
    before = dict(bs.FW_GRAPHS)
    for _ in range(3):
        got = s.clone()
        bs.apsp_band_fw(got, bt=bt, block=block)
        assert torch.equal(got, want)
    assert bs.FW_GRAPHS["eager"] == before["eager"] + 3
    assert bs.FW_GRAPHS["captures"] == before["captures"]
    assert bs.FW_GRAPHS["replays"] == before["replays"]
    assert not any(key[0].type == "cpu" for key in bs._fw_graphs)
