"""The port's min-plus kernels (safepy_tpu_torch/ops/apsp_cuda.py) against the
JAX package's Pallas kernels (safepy_tpu/ops/apsp_pallas.py).

On the CPU the wrappers run their plain torch versions; the JAX kernels run in
Pallas interpret mode, as tests/test_apsp.py runs them. Every comparison is
bitwise: each candidate a + b is one f32 rounding and min is exact, so any
tiling and k order gives the same bits. The CUDA kernels themselves are held
against these plain versions in tests/test_torch_cuda.py, on a card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from safepy_tpu.ops import apsp_pallas as jp
from safepy_tpu.ops.apsp import _apsp_jax, pad_distances as jax_pad
from safepy_tpu.ops.neighborhoods import dense_initial_distances
from safepy_tpu_torch.ops import apsp_cuda as K
from safepy_tpu_torch.ops.apsp import (_apsp_torch, apsp, min_plus_product,
                                       pad_distances)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BLOCK = 32


def _inf_laced(rng, shape, inf_share=0.3):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    x[rng.random(shape) < inf_share] = np.inf
    return x


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("form", ["rows", "cols"])
def test_relax_panel_matches_pallas(form):
    rng = np.random.default_rng(0)
    diag = _inf_laced(rng, (BLOCK, BLOCK))
    if form == "rows":
        panel = _inf_laced(rng, (BLOCK, 5 * BLOCK))
        with pltpu.force_tpu_interpret_mode():
            want = jp._relax_rows(jnp.asarray(diag), jnp.asarray(panel),
                                  block=BLOCK)
        got = K.relax_panel(_t(panel), _t(diag), _t(panel))
    else:
        panel = _inf_laced(rng, (5 * BLOCK, BLOCK))
        with pltpu.force_tpu_interpret_mode():
            want = jp._relax_cols(jnp.asarray(panel), jnp.asarray(diag),
                                  block=BLOCK)
        got = K.relax_panel(_t(panel), _t(panel), _t(diag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("band_tiles", [1, 3, 0, 4])
def test_relax_window_sym_matches_pallas(band_tiles):
    """The window lies inside a larger matrix at lo = BLOCK; everything
    outside it must stay untouched."""
    rng = np.random.default_rng(band_tiles)
    w, lo = 5 * BLOCK, BLOCK
    d = _inf_laced(rng, (w + 2 * BLOCK, w + 2 * BLOCK))
    d = np.minimum(d, d.T)
    q = _inf_laced(rng, (w, BLOCK))
    p = _inf_laced(rng, (BLOCK, w))
    win = d[lo:lo + w, lo:lo + w]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp._relax_full_banded_sym(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(win), block=BLOCK,
            band_tiles=band_tiles))
    got = _t(d)
    K.relax_window_sym(_t(q), _t(p), got, lo, w, band_tiles)
    got = got.numpy()
    np.testing.assert_array_equal(got[lo:lo + w, lo:lo + w], want)
    outside = np.ones_like(d, dtype=bool)
    outside[lo:lo + w, lo:lo + w] = False
    np.testing.assert_array_equal(got[outside], d[outside])


def _relax_window_by_tiles(q, p, d, lo, w, tiles):
    """relax_window_sym as its kernel runs it: each listed tile relaxed on
    its own (relax_panel_plain) and written back, its transpose into the
    mirror where the row names one."""
    block = q.shape[1]
    win = d[lo:lo + w, lo:lo + w]

    def tile(i, j):
        return win[i * block:(i + 1) * block, j * block:(j + 1) * block]

    relaxed = [K.relax_panel_plain(tile(i, j), q[i * block:(i + 1) * block],
                                   p[:, j * block:(j + 1) * block])
               for i, j, _, _ in tiles.tolist()]
    for (i, j, mi, mj), r in zip(tiles.tolist(), relaxed):
        tile(i, j).copy_(r)
        if mi >= 0:
            tile(mi, mj).copy_(r.T)


@pytest.mark.parametrize("nbw,band_tiles", [(5, 0), (5, 1), (5, 2), (5, 4),
                                            (6, 9)])
def test_window_tile_list_gives_the_plain_version(nbw, band_tiles):
    """The window relax's tile list, applied tile by tile, is bitwise
    relax_window_sym_plain (its ``upper`` and ``lower`` masks), the window
    at lo = BLOCK inside a larger matrix."""
    rng = np.random.default_rng(nbw * 10 + band_tiles)
    w, lo = nbw * BLOCK, BLOCK
    d = _inf_laced(rng, (w + 2 * BLOCK, w + 2 * BLOCK))
    d = np.minimum(d, d.T)
    q, p = _t(_inf_laced(rng, (w, BLOCK))), _t(_inf_laced(rng, (BLOCK, w)))
    got, want = _t(d.copy()), _t(d.copy())
    _relax_window_by_tiles(q, p, got, lo, w,
                           K.window_tiles(nbw, min(band_tiles, nbw - 1)))
    K.relax_window_sym_plain(q, p, want, lo, w, band_tiles)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not np.array_equal(got.numpy(), d)


@pytest.mark.parametrize("nbw,band_tiles,count", [
    (8, 6, 35), (32, 31, 528), (1, 0, 1), (5, 0, 5), (9, 2, 24)])
def test_window_tile_list_is_upper_in_band_tiles_only(nbw, band_tiles,
                                                      count):
    """One row a live tile: exactly the upper tiles with 0 <= j - i <=
    band_tiles, each off the diagonal mirrored into (j, i), no mirror among
    the listed tiles (the in-place safety argument); 35 tiles at Example_1's
    window (w 1,024, band_tiles 6) and 528 at the dense 4,096."""
    tiles = K.window_tiles(nbw, band_tiles)
    assert tiles.dtype == torch.int32 and tiles.shape == (count, 4)
    listed = [tuple(t) for t in tiles[:, :2].tolist()]
    assert sorted(listed) == [(i, j) for i in range(nbw) for j in range(nbw)
                              if 0 <= j - i <= band_tiles]
    for i, j, mi, mj in tiles.tolist():
        assert (mi, mj) == ((j, i) if j > i else (-1, -1))
    mirrors = {tuple(m) for m in tiles[:, 2:].tolist() if m[0] >= 0}
    assert len(mirrors) == count - nbw and not mirrors & set(listed)


def test_window_sym_form_follows_the_list_length(monkeypatch):
    """Whole tiles on the tile engine at block 128 where their waves of two
    CTAs an SM (264 slots on the H100's 132) come out at least 90% full,
    else 32x32 sub-tiles; block 64 always sub-tiles."""
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    dev = torch.device("cuda")
    whole = [n for n in range(1, 1000) if K.window_sym_whole(n, 128, dev)]
    assert whole == [*range(238, 265), *range(476, 529), *range(713, 793),
                     *range(951, 1000)]
    assert not K.window_sym_whole(35, 128, dev)   # Example_1's window
    assert K.window_sym_whole(528, 128, dev)      # the dense 4,096
    assert not K.window_sym_whole(528, 64, dev)


@pytest.mark.parametrize("symmetric", [True, False])
def test_close_diag_matches_jnp(symmetric):
    rng = np.random.default_rng(5)
    tile = _inf_laced(rng, (BLOCK, BLOCK), inf_share=0.6)
    if symmetric:
        tile = np.minimum(tile, tile.T)
    np.fill_diagonal(tile, 0.0)
    want = np.asarray(jp._close_diag(jnp.asarray(tile), BLOCK))
    np.testing.assert_array_equal(K.close_diag(_t(tile)).numpy(), want)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("case", ["zero_diag", "inf_diag", "inf_padding"])
def test_close_diag_plain_matches_jnp_edge_tiles(block, case):
    """close_diag's plain version against jnp ``_close_diag`` at the CUDA
    kernel's blocks, on the tiles the rounds meet: a zero diagonal, +inf
    diagonal entries, and all-+inf padding rows and columns."""
    rng = np.random.default_rng(block + len(case))
    tile = _inf_laced(rng, (block, block), inf_share=0.9)
    np.fill_diagonal(tile, 0.0)
    if case == "inf_diag":
        tile[np.diag_indices(block)] = np.where(rng.random(block) < 0.3,
                                                np.inf, 0.0)
    elif case == "inf_padding":
        tile[block - 24:] = np.inf
        tile[:, block - 24:] = np.inf
    want = np.asarray(jp._close_diag(jnp.asarray(tile), block))
    got = K.close_diag_plain(_t(tile)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(K.close_diag(_t(tile)).numpy(), want)
    assert (want < tile).any()  # the closure found shorter paths


def _random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    keep = rng.random(len(iu[0])) < p
    edges = np.stack([iu[0][keep], iu[1][keep]], 1)
    return edges, rng.uniform(0.1, 2.0, len(edges))


def test_apsp_blocked_fw_matches_pallas():
    """Symmetric blocked FW, port (plain versions) against JAX (interpret)."""
    n = 200
    edges, w = _random_graph(n, 0.02, 3)
    d0 = dense_initial_distances(n, edges, w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.apsp_blocked_fw(jnp.asarray(d0), block=BLOCK,
                                             symmetric=True))
    src = _t(d0)
    got = K.apsp_blocked_fw(src, block=BLOCK, symmetric=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), d0)  # input left as it was
    assert np.isinf(want).any() and np.isfinite(want).any()


def test_apsp_entry_points():
    n = 90
    edges, w = _random_graph(n, 0.05, 4)
    d0 = dense_initial_distances(n, edges, w)
    want = np.asarray(_apsp_jax(jnp.asarray(d0)))
    # the textbook loop associates exactly as the jnp oracle
    np.testing.assert_array_equal(_apsp_torch(_t(d0)).numpy(), want)
    np.testing.assert_array_equal(apsp(_t(d0), method="torch").numpy(), want)
    np.testing.assert_allclose(apsp(_t(d0), block=BLOCK).numpy(), want,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        pad_distances(_t(d0), 64).numpy(),
        np.asarray(jax_pad(jnp.asarray(d0), 64)))
    # the squaring and the classic FW, once refused, now run: all methods
    # give the textbook distances to f32 association
    for method in ("pallas_squaring", "pallas_fw", "fw"):
        np.testing.assert_allclose(
            apsp(_t(d0), method=method, block=BLOCK).numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(
        K.apsp_blocked_fw(_t(d0), block=BLOCK, symmetric=False).numpy(),
        K.apsp_blocked_fw(_t(d0), block=BLOCK, symmetric=True).numpy())
    np.testing.assert_array_equal(apsp(_t(d0), method="jax").numpy(), want)
    with pytest.raises(ValueError):
        apsp(_t(d0), method="bogus")
    with pytest.raises(ValueError):
        min_plus_product(_t(d0), _t(d0), method="bogus")


def test_cpu_wrappers_count_no_launches_and_check_inputs():
    rng = np.random.default_rng(1)
    a = _t(_inf_laced(rng, (BLOCK, BLOCK)))
    K.reset_launches()
    K.relax_panel(a, a, a)
    K.close_diag(a)
    K.relax_window_sym(a, a, a.clone(), 0, BLOCK, 1)
    K.relax_full(a, a.clone(), a.clone())
    K.relax_full(a, a.clone(), a.clone(), 0)
    K.minplus_product(a, a)
    K.relax_band_row(a, a.clone(), a)
    K.relax_band_rows(torch.cat([a] * 3, 1), torch.cat([a] * 5, 1), 0, 1)
    assert K.LAUNCHES == {"relax_panel": 0, "relax_window_sym": 0,
                          "close_diag": 0, "relax_skew_sym": 0,
                          "relax_skew": 0, "relax_full": 0,
                          "relax_full_banded": 0, "minplus_product": 0,
                          "relax_band_row": 0}
    with pytest.raises(TypeError):
        K.relax_panel(a.double(), a.double(), a.double())
    with pytest.raises(ValueError, match="shape"):
        K.relax_panel(a, a[:, :16], a)
    with pytest.raises(ValueError, match="no min-plus kernel"):
        K.close_diag(torch.empty((BLOCK, BLOCK), device="meta"))
    with pytest.raises(ValueError, match="bad window"):
        K.relax_window_sym(a, a, a.clone(), 16, BLOCK, 1)
    with pytest.raises(ValueError, match="shape"):
        K.relax_full(a, a[:16], a.clone())
    with pytest.raises(ValueError, match="band_tiles"):
        K.relax_full(a, a.clone(), a.clone(), -1)
    with pytest.raises(ValueError, match="apart from d"):
        d = a.clone()
        K.relax_full(d[:, :BLOCK], a.clone(), d)  # q is a view into d
    with pytest.raises(TypeError):
        K.relax_full(a.double(), a.double(), a.double())
    with pytest.raises(ValueError, match="shape"):
        K.minplus_product(a, a[:16])
    with pytest.raises(TypeError):
        K.minplus_product(a.double(), a.double())
    with pytest.raises(ValueError, match="shape"):
        K.relax_band_row(a, a[:, :16], a)
    with pytest.raises(ValueError, match="bad window rows"):
        K.relax_band_rows(torch.cat([a] * 3, 1), torch.cat([a] * 5, 1), 1, 3)
