"""The port on the card: CUDA kernels against their plain torch versions, and
CUDA sessions against CPU sessions. Every test needs an NVIDIA GPU and nvcc
and skips without one.

This file imports no jax, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` skips tests/conftest.py, which imports jax.) Comparisons are
bitwise: the kernels round every candidate a + b once, as the plain versions
do, and min is exact.
"""

import numpy as np
import pytest
import torch

from safepy_tpu_torch import SAFE
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import apsp_cuda as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inf_laced(gen, dev, *shape):
    x = torch.rand(shape, generator=gen, device=dev)
    x[torch.rand(shape, generator=gen, device=dev) < 0.3] = float("inf")
    return x


@pytest.mark.parametrize("block,w,band_tiles", [(128, 768, 2), (128, 512, 9),
                                                (64, 448, 3)])
def test_kernels_match_plain(dev, block, w, band_tiles):
    gen = torch.Generator(device=dev).manual_seed(block + w)
    tile = _inf_laced(gen, dev, block, block)
    tile.diagonal().zero_()
    assert torch.equal(K.close_diag(tile), K.close_diag_plain(tile))
    diag = K.close_diag_plain(tile)
    p, q = _inf_laced(gen, dev, block, w), _inf_laced(gen, dev, w, block)
    assert torch.equal(K.relax_panel(p, diag, p),
                       K.relax_panel_plain(p, diag, p))
    assert torch.equal(K.relax_panel(q, q, diag),
                       K.relax_panel_plain(q, q, diag))
    # a window at lo = block inside a larger matrix, as the banded rounds use
    d = _inf_laced(gen, dev, w + 2 * block, w + 2 * block)
    got, want = d.clone(), d.clone()
    K.relax_window_sym(q, p, got, block, w, band_tiles)
    K.relax_window_sym_plain(q, p, want, block, w, band_tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("strided", [False, True],
                         ids=["stride-W", "stride-wider"])
@pytest.mark.parametrize("block,bt", [(128, 0), (128, 1), (128, 2), (128, 5),
                                      (128, 12), (64, 0), (64, 1), (64, 3),
                                      (64, 12)])
def test_skew_kernels_match_plain(dev, symmetric, strided, block, bt):
    """The skewed window lies inside a band with rows above and below it,
    as in the band rounds, or (strided) is a view at column 8 of a band 40
    columns wider than W; everything outside it must stay untouched. At
    block 128, bt 12 takes the kernels' whole-tile form (a long tile list)
    and bt 0-5 their 64x64 sub-tile form, which block 64 always takes."""
    from safepy_tpu_torch.ops.apsp_bandstore import skew_pivot_column

    gen = torch.Generator(device=dev).manual_seed(block + bt + symmetric
                                                  + 1000 * strided)
    w = (2 * bt + 1) * block
    c0, extra = (8, 40) if strided else (0, 0)
    s = _inf_laced(gen, dev, w + 2 * block, w + extra)
    win = s[block:block + w, c0:c0 + w]
    win.copy_(torch.minimum(win, win.T))
    p = _inf_laced(gen, dev, block, w)
    q = skew_pivot_column(win, bt, block)
    got, want = s.clone(), s.clone()
    kernel = K.relax_skew_sym if symmetric else K.relax_skew
    plain = K.relax_skew_sym_plain if symmetric else K.relax_skew_plain
    K.reset_launches()
    kernel(got[block:block + w, c0:c0 + w], q, p, bt)
    plain(want[block:block + w, c0:c0 + w], q, p, bt)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, s)
    assert K.LAUNCHES["relax_skew_sym" if symmetric else "relax_skew"] == 1
    assert sum(K.LAUNCHES.values()) == 1


@pytest.mark.parametrize("m,n,block,band_tiles", [
    (768, 768, 128, None), (384, 1152, 128, None), (320, 192, 32, None),
    (1024, 1024, 128, 2), (448, 448, 64, 3),
    (1024, 1024, 128, 0), (1024, 1024, 128, 1), (1024, 1024, 128, 6),
    (384, 640, 128, 1), (640, 384, 64, 2), (320, 448, 128, 1),
    (4096, 4096, 128, 31)],
    ids=["768", "rect", "block32", "bt2", "block64", "w1024-bt0",
         "w1024-bt1", "w1024-bt6", "rect-bt1", "rect-block64-bt2",
         "ragged-bt1", "all-1024-tiles"])
def test_relax_full_matches_plain(dev, m, n, block, band_tiles):
    """In place on a window at (block, block) of a larger matrix, whose row
    stride exceeds n: rectangular, and banded (the list kernel) at bt 0, 1
    and 6 on Example_1's 1,024 window, at blocks 64 and 128, on windows
    whose last tiles are cut (m, n no multiples of block) and with every
    tile of 4096^2 listed; bitwise, one launch, everything outside the
    window untouched."""
    gen = torch.Generator(device=dev).manual_seed(m + n + block)
    q, p = _inf_laced(gen, dev, m, block), _inf_laced(gen, dev, block, n)
    d = _inf_laced(gen, dev, m + 2 * block, n + 2 * block)
    if band_tiles is not None:  # Example_1's window: sub-tiles; 1,024: whole
        nb_i, nb_j = -(-m // block), -(-n // block)
        tiles = len(K.full_tiles(nb_i, nb_j, band_tiles))
        assert K.full_banded_whole(tiles, m, n, block, dev) == (tiles == 1024)
    got, want = d.clone(), d.clone()
    K.reset_launches()
    K.relax_full(q, p, got[block:block + m, block:block + n], band_tiles)
    K.relax_full_plain(q, p, want[block:block + m, block:block + n],
                       band_tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, d)
    outside = torch.ones_like(d, dtype=torch.bool)
    outside[block:block + m, block:block + n] = False
    assert torch.equal(got[outside], d[outside])
    key = "relax_full" if band_tiles is None else "relax_full_banded"
    assert K.LAUNCHES[key] == 1 and sum(K.LAUNCHES.values()) == 1


@pytest.mark.parametrize("m,k,n", [(256, 128, 320), (100, 130, 70),
                                   (1, 5, 3), (700, 257, 129)])
def test_minplus_product_matches_plain(dev, m, k, n):
    """Ragged shapes go through the wrapper's +inf padding."""
    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    a, b = _inf_laced(gen, dev, m, k), _inf_laced(gen, dev, k, n)
    K.reset_launches()
    got = K.minplus_product(a, b)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.is_contiguous()
    assert torch.equal(got, K.minplus_product_plain(a, b))
    assert K.LAUNCHES["minplus_product"] == 1


@pytest.mark.parametrize("m,k,n", [
    (256, 16, 384),      # one k slab
    (256, 50, 128),      # k no multiple of the slab
    (384, 4096, 256),    # the squaring's depth: 256 slabs, parities wrap
    (200, 64, 300),      # m and n no multiples of the 128 tile
    (2500, 96, 2000)],   # 320 tiles: more than one wave of 264 CTAs
    ids=["k-one-slab", "k-ragged", "k-4096", "mn-ragged", "many-tiles"])
def test_minplus_product_slabs_and_signs_match_plain(dev, m, k, n):
    """The tile engine's product: negative entries (the op level takes any
    f32), whole rows of a and columns of b at +inf, b a view whose row
    stride is no multiple of 4 (the wrapper copies it); bitwise, one
    launch, the operands untouched."""
    gen = torch.Generator(device=dev).manual_seed(m + 7 * k + n)
    a = _inf_laced(gen, dev, m, k) * 4 - 2
    wide = _inf_laced(gen, dev, k, n + 3) * 4 - 2
    b = wide[:, 1:n + 1]
    a[::7] = float("inf")
    b[:, ::5] = float("inf")
    a0, b0 = a.clone(), b.clone()
    K.reset_launches()
    got = K.minplus_product(a, b)
    torch.cuda.synchronize()
    want = K.minplus_product_plain(a, b)
    assert got.shape == (m, n) and torch.equal(got, want)
    assert (got < 0).any() and torch.isinf(got).any() and torch.isfinite(
        got).any()
    assert torch.equal(a, a0) and torch.equal(b, b0)
    assert K.LAUNCHES["minplus_product"] == 1 and sum(K.LAUNCHES.values()) == 1


@pytest.mark.parametrize("block,w,lo,band_tiles,whole", [
    (128, 1024, 512, 6, False),   # Example_1's window: 35 tiles, sub-tiles
    (128, 4096, 0, 32, True),     # the dense FW: 528 tiles, whole tiles
    (128, 1024, 0, 0, False),     # the diagonal tiles only
    (64, 448, 64, 3, False),      # block 64: always sub-tiles
    (128, 2048, 256, 15, False),  # 136 tiles: a part-full wave, sub-tiles
    (128, 4096, 128, 8, True)],   # 252 tiles: a 95% full wave, whole tiles
    ids=["example1", "dense", "bt0", "block64", "long-sub", "window-whole"])
def test_relax_window_sym_forms_match_plain(dev, block, w, lo, band_tiles,
                                            whole):
    """Both list forms of relax_window_sym on a symmetric +inf-laced matrix,
    the window at lo inside it; bitwise, one launch, everything outside the
    window untouched."""
    gen = torch.Generator(device=dev).manual_seed(block + w + band_tiles)
    n = lo + w + block
    d = _inf_laced(gen, dev, n, n)
    d = torch.minimum(d, d.T).contiguous()
    q, p = _inf_laced(gen, dev, w, block), _inf_laced(gen, dev, block, w)
    tiles = K.window_tiles(w // block, min(band_tiles, w // block - 1))
    assert K.window_sym_whole(len(tiles), block, d.device) == whole
    got, want = d.clone(), d.clone()
    K.reset_launches()
    K.relax_window_sym(q, p, got, lo, w, band_tiles)
    torch.cuda.synchronize()
    K.relax_window_sym_plain(q, p, want, lo, w, band_tiles)
    assert torch.equal(got, want) and not torch.equal(got, d)
    outside = torch.ones_like(d, dtype=torch.bool)
    outside[lo:lo + w, lo:lo + w] = False
    assert torch.equal(got[outside], d[outside])
    assert K.LAUNCHES["relax_window_sym"] == 1 and sum(K.LAUNCHES.values()) == 1


def test_op_level_apsp_on_the_card(dev):
    """The op-level entry points on a directed matrix: the classic FW, the
    squaring and the banded classic FW against the plain versions on the
    host, and the launch counts of each path."""
    from safepy_tpu_torch import ops
    from safepy_tpu_torch.ops.apsp_banded import apsp_banded_fw

    rng = np.random.default_rng(5)
    n = 300
    d0 = np.full((n, n), np.inf, np.float32)
    arcs = rng.random((n, n)) < 0.03
    d0[arcs] = rng.uniform(0.1, 2.0, int(arcs.sum()))
    np.fill_diagonal(d0, 0.0)
    host, card = torch.as_tensor(d0), torch.as_tensor(d0, device=dev)
    nb = -(-n // 128)
    K.reset_launches()
    got = ops.apsp(card)
    assert K.LAUNCHES["relax_full"] == nb and K.LAUNCHES["relax_window_sym"] == 0
    assert torch.equal(got.cpu(), ops.apsp(host))
    K.reset_launches()
    got = ops.apsp(card, method="pallas_squaring")
    assert K.LAUNCHES["minplus_product"] == 9  # ceil(log2(300))
    assert torch.equal(got.cpu(), ops.apsp(host, method="pallas_squaring"))
    # a banded window over a padded matrix: 384 = 3 tiles, window 256
    pad = torch.full((384, 384), float("inf"))
    pad.diagonal().zero_()
    pad[:n, :n] = host
    want = apsp_banded_fw(pad.clone(), window=256, symmetric=False)
    K.reset_launches()
    got = apsp_banded_fw(pad.to(dev), window=256, symmetric=False)
    assert K.LAUNCHES["relax_full_banded"] == 3
    assert torch.equal(got.cpu(), want)


def test_op_level_takes_array_likes_onto_the_card(dev):
    """Numpy operands at each of the seven op-level entry points compute
    on the card, as JAX's entry points compute array-likes on the
    accelerator: a CUDA result equal to the CPU-tensor result of the same
    numpy (min-plus, indicators, integer-valued scores and counts
    bitwise; FDR within 1e-12 and distances within 1e-6 relative, summed in
    another order)."""
    from safepy_tpu_torch import ops

    rng = np.random.default_rng(8)
    n = 300
    d0 = np.full((n, n), np.inf, np.float32)
    arcs = rng.random((n, n)) < 0.03
    d0[arcs] = rng.uniform(0.1, 2.0, int(arcs.sum()))
    np.fill_diagonal(d0, 0.0)
    coords = rng.uniform(-1, 1, (n, 2))
    dist = np.hypot(*(coords[:, None] - coords[None]).transpose(2, 0, 1))
    nbr = (dist <= 0.4).astype(np.float32)
    vals = rng.integers(-3, 4, (n, 2)).astype(float)
    vals[rng.random((n, 2)) < 0.3] = np.nan
    obs = nbr @ np.nan_to_num(vals).astype(np.float32)
    perm_idx = np.stack([rng.permutation(n) for _ in range(50)])
    pv = rng.uniform(0, 1, (40, 60)) ** 3
    pv[rng.random(pv.shape) < 0.15] = np.nan
    exact = np.testing.assert_array_equal
    cases = [
        (ops.apsp, (d0,), exact),
        (ops.min_plus_product, (d0[:, :200], d0[:200, :250]), exact),
        (ops.euclidean_distance_matrix, (coords,),
         lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6)),
        (lambda x: ops.neighborhoods_from_distances(x, 0.4, strict=False),
         (dist,), exact),
        (ops.compute_neighborhood_score, (nbr, vals), exact),
        (lambda a, v, o: torch.stack(ops.run_permutations(
            a, v, None, o, perm_idx=perm_idx, num_permutations=50)),
         (nbr, vals, obs), exact),
        (ops.fdr_bh, (pv,),
         lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-12,
                                                 atol=1e-12))]
    for fn, args, compare in cases:
        got = fn(*args)
        assert got.device.type == "cuda"
        want = fn(*(torch.as_tensor(x) for x in args))
        assert want.device.type == "cpu" and got.dtype == want.dtype
        compare(got.cpu().numpy(), want.numpy())


def _network(n=700, k=8, seed=3):
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


@pytest.mark.parametrize("mode", ["auto", "full"])
def test_cuda_session_matches_cpu_session(dev, mode):
    """Same arrays, same permutations: identical neighborhoods, distances and
    counts (integer-valued attribute, so the f32 GEMM sums are exact)."""
    net = _network()
    rng = np.random.default_rng(0)
    vals = rng.integers(-3, 4, (700, 1)).astype(float)
    vals[rng.random(700) < 0.3] = np.nan
    valid = np.flatnonzero(np.isfinite(vals).any(axis=1))
    perm_idx = np.stack([rng.permutation(len(valid)) for _ in range(100)])

    runs = []
    for device in ("cpu", dev):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode = mode
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        sf.run_pipeline(perm_idx=perm_idx)
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, cpu_launches), (gpu, gpu_launches) = runs
    assert gpu.apsp_engine_used == cpu.apsp_engine_used
    assert (gpu.apsp_engine_used == "banded-window") == (mode == "auto")
    assert set(cpu_launches.values()) == {0}
    assert gpu_launches["relax_window_sym"] == 6  # one per FW round, npad 768
    np.testing.assert_array_equal(gpu.neighborhoods, cpu.neighborhoods)
    np.testing.assert_array_equal(gpu.node_distances, cpu.node_distances)
    np.testing.assert_array_equal(gpu.ns, cpu.ns)
    np.testing.assert_array_equal(gpu.counts_neg, cpu.counts_neg)
    np.testing.assert_array_equal(gpu.counts_pos, cpu.counts_pos)


def test_cuda_band_session_matches_cpu_band_session(dev):
    """apsp_mode='band' on the card and on the host, same arrays and
    permutations: identical band distances, neighborhoods and counts; the
    classic (non-symmetric) FW gives the same indicator."""
    from safepy_tpu_torch.ops import apsp_bandstore as bs
    from safepy_tpu_torch.ops.neighborhoods import inclusive_radius

    net = _network(n=900)
    rng = np.random.default_rng(1)
    vals = rng.integers(-3, 4, (900, 1)).astype(float)
    vals[rng.random(900) < 0.3] = np.nan
    valid = np.flatnonzero(np.isfinite(vals).any(axis=1))
    perm_idx = np.stack([rng.permutation(len(valid)) for _ in range(100)])

    runs = []
    for device in ("cpu", dev):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode = "band"
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        sf.run_pipeline(perm_idx=perm_idx)
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, _), (gpu, launches) = runs
    assert gpu.apsp_engine_used == cpu.apsp_engine_used == "band-storage"
    nb = -(-900 // 128)
    assert launches == {"close_diag": nb, "relax_panel": nb,
                        "relax_skew_sym": nb, "relax_window_sym": 0,
                        "relax_skew": 0, "relax_full": 0,
                        "relax_full_banded": 0, "minplus_product": 0,
                        "relax_band_row": 0}
    assert torch.equal(gpu._node_distances_dev.data.cpu(),
                       cpu._node_distances_dev.data)
    np.testing.assert_array_equal(gpu.neighborhoods, cpu.neighborhoods)
    np.testing.assert_array_equal(gpu.ns, cpu.ns)
    np.testing.assert_array_equal(gpu.counts_neg, cpu.counts_neg)
    np.testing.assert_array_equal(gpu.counts_pos, cpu.counts_pos)
    plan = next(p for p in gpu._bandstore_cache.values() if p)
    s = bs.band_init_from_edges(plan["u"], plan["v"], plan["w"], n=900,
                                band=plan["band"])
    K.reset_launches()
    bs.apsp_band_fw(s, bt=plan["band"] // 128 + 1, symmetric=False)
    assert K.LAUNCHES["relax_skew"] == nb
    x = net[0][:, 0]
    r = inclusive_radius(gpu.neighborhood_radius * (x.max() - x.min()))
    assert torch.equal(bs.band_threshold(s, r), gpu._neighborhoods_dev.data)


@pytest.mark.parametrize("block,bt", [(128, 12), (128, 2), (64, 3)])
def test_relax_band_row_matches_plain(dev, block, bt):
    """B3 on one window row: q a tile of c, p a slice of an inf-extended
    pivot row (a row stride wider than W), as the sharded rounds call it."""
    gen = torch.Generator(device=dev).manual_seed(block + bt)
    w = (2 * bt + 1) * block
    c = _inf_laced(gen, dev, block, w)
    p_ext = _inf_laced(gen, dev, block, w + 2 * bt * block)
    q, p = c[:, block:2 * block], p_ext[:, block:block + w]
    before = c.clone()
    K.reset_launches()
    got = K.relax_band_row(q, p, c)
    want = K.relax_band_row_plain(c, q, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, c)
    assert torch.equal(c, before)
    assert K.LAUNCHES["relax_band_row"] == 1 and sum(K.LAUNCHES.values()) == 1


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("case", ["zero_diag", "inf_diag", "inf_padding",
                                  "strided_view"])
def test_close_diag_cases_match_plain(dev, block, case):
    """close_diag on the tiles the rounds meet: a zero diagonal, +inf
    diagonal entries, all-+inf padding rows and columns, and a view into a
    wider matrix at an offset (the pivot tile of a band row)."""
    gen = torch.Generator(device=dev).manual_seed(block + len(case))
    tile = _inf_laced(gen, dev, block, block)
    tile.diagonal().zero_()
    if case == "inf_diag":
        tile.diagonal()[::3] = float("inf")
    elif case == "inf_padding":
        tile[block - 40:] = float("inf")
        tile[:, block - 40:] = float("inf")
    elif case == "strided_view":
        wide = _inf_laced(gen, dev, block + 5, 3 * block + 7)
        wide[3:3 + block, block + 1:2 * block + 1] = tile
        tile = wide[3:3 + block, block + 1:2 * block + 1]
    K.reset_launches()
    got = K.close_diag(tile)
    torch.cuda.synchronize()
    want = K.close_diag_plain(tile)
    assert torch.equal(got, want) and not torch.equal(got, tile)
    assert got.is_contiguous() and K.LAUNCHES["close_diag"] == 1


@pytest.mark.parametrize("k", [32, 64, 128])
def test_relax_panel_k_and_strides_match_plain(dev, k):
    """relax_panel at k 32, 64 and 128 in both forms, every operand a view
    with a row stride wider than its width."""
    gen = torch.Generator(device=dev).manual_seed(k)
    big = _inf_laced(gen, dev, 1024 + k, 1024 + 2 * k)
    diag = big[:k, 4:4 + k]
    p = big[k:2 * k, 2 * k:2 * k + 640]          # rows form: (k, 640)
    q = big[k:k + 576, k + 8:2 * k + 8]         # cols form: (576, k)
    K.reset_launches()
    rows = K.relax_panel(p, diag, p)
    cols = K.relax_panel(q, q, diag)
    torch.cuda.synchronize()
    assert torch.equal(rows, K.relax_panel_plain(p, diag, p))
    assert torch.equal(cols, K.relax_panel_plain(q, q, diag))
    assert not torch.equal(rows, p) and not torch.equal(cols, q)
    assert K.LAUNCHES["relax_panel"] == 2


@pytest.mark.parametrize("bt,o_lo,o_hi", [(2, 0, 5), (2, 1, 4), (12, 0, 25),
                                          (12, 9, 25), (12, 0, 7)])
def test_relax_band_rows_match_plain(dev, bt, o_lo, o_hi):
    """B3 batched, in place on a round's window rows inside a larger slab:
    full windows and windows cut at the first or last rows, at bt 2 and 12
    (the 49,920-node slice); the rows around stay untouched; one launch."""
    b = 128
    w = (2 * bt + 1) * b
    gen = torch.Generator(device=dev).manual_seed(bt * 100 + o_lo + o_hi)
    slab = _inf_laced(gen, dev, (o_hi - o_lo + 2) * b, w)
    p_ext = _inf_laced(gen, dev, b, w + 2 * bt * b)
    got, want = slab.clone(), slab.clone()
    K.reset_launches()
    K.relax_band_rows(got[b:-b], p_ext, o_lo, o_hi)
    torch.cuda.synchronize()
    K.relax_band_rows_plain(want[b:-b], p_ext, o_lo, o_hi)
    assert torch.equal(got, want) and not torch.equal(got, slab)
    assert K.LAUNCHES["relax_band_row"] == 1 and sum(K.LAUNCHES.values()) == 1


def test_sharded_band_fw_world_one_nccl(dev, tmp_path):
    """The row-sharded band FW on a one-rank NCCL 'data' mesh: bitwise the
    classic band FW, with 2 bt + 1 relax_band_row launches a round."""
    import torch.distributed as dist
    from safepy_tpu_torch.ops import apsp_bandstore as bs
    from safepy_tpu_torch.ops.apsp_banded import banded_order
    from safepy_tpu_torch.parallel import band_sharded as bsh
    from safepy_tpu_torch.parallel import make_mesh

    n = 900
    coords, edges, lengths, _ = _network(n=n)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pe = torch.as_tensor(rank[edges], device=dev)
    s = bs.band_init_from_edges(pe[:, 0], pe[:, 1],
                                torch.as_tensor(lengths, device=dev), n=n,
                                band=band)
    bt, nb = band // 128 + 1, -(-n // 128)
    want = bs.apsp_band_fw(s.clone(), bt=bt, symmetric=False)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1}, device_type="cuda")
        K.reset_launches()
        got = bsh.apsp_band_fw_sharded(s, mesh=mesh, n=n, band=band)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert got is s and torch.equal(got, want)
    assert K.LAUNCHES["close_diag"] == K.LAUNCHES["relax_panel"] == nb
    assert K.LAUNCHES["relax_band_row"] == nb  # a round's rows in one launch


def test_staged_pvalues_after_sharded_band_go_run_on_the_card(dev, tmp_path,
                                                               monkeypatch):
    """A band GO run on a one-rank NCCL 'data' mesh leaves its bands and
    (n, A) outputs in host memory and only the rank's operand window on
    the card. A staged compute_pvalues afterwards uploads the band and
    computes on the card (``table-band-staged``), with the sharded run's
    indicator, counts and log sf; the domain stage's device copies of the
    host indicator and NES are on the card and equal the host's."""
    import torch.distributed as dist
    from safepy_tpu_torch.ops import enrich_band as eb
    from safepy_tpu_torch.parallel import band_sharded as bsh
    from safepy_tpu_torch.parallel import make_mesh
    from safepy_tpu_torch.safe import _nes_from_logsf_host

    net = _network(n=900)
    vals = _band_go_matrix(net[0])
    census_devices = []
    table = eb.hypergeom_band_table

    def recorded(s_ind, *a, **k):
        census_devices.append(s_ind.device.type)
        return table(s_ind, *a, **k)

    monkeypatch.setattr(eb, "hypergeom_band_table", recorded)
    before = torch.cuda.memory_allocated(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        sf = SAFE(device=dev, verbose=False)
        sf.apsp_mode = "band"
        sf.mesh = make_mesh({"data": 1}, device_type="cuda")
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        sf.run_pipeline()
        torch.cuda.synchronize()
        assert sf._hypergeom_engine_used == "table-band-sharded"
        held = torch.cuda.memory_allocated(dev) - before
        band, logsf = sf._neighborhoods_dev.data, sf._logsf_dev
        want = (sf.nes_binary, logsf.numpy().copy(),
                np.asarray(sf.attributes["num_neighborhoods_enriched"]))
        assert band.device.type == logsf.device.type == "cpu"
        assert sf._nes_binary_dev.device.type == "cpu"
        ops = sf._band_operands_cache[1][0]
        p0, p1 = bsh.operand_window(0, bsh.sharded_band_geometry(
            900, sf._hbm_plan_last["band"], 1))
        assert ops.is_cuda and ops.shape[0] == p1 - p0
        assert held <= ops.nbytes + (32 << 20)  # the operands, edges, ranks
        nes_dev, b_dev = sf._nes_on_device(), sf._nes_binary_on_device()
        assert nes_dev.is_cuda and b_dev.is_cuda
        np.testing.assert_array_equal(nes_dev.cpu().numpy(),
                                      _nes_from_logsf_host(want[1]))
        np.testing.assert_array_equal(b_dev.cpu().numpy(), want[0])
        sf.compute_pvalues()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert sf._hypergeom_engine_used == "table-band-staged"
    assert census_devices == ["cuda"]
    assert sf._neighborhoods_dev.data.is_cuda and sf._logsf_dev.is_cuda
    # the uploaded band now counts among the session's planned residents
    assert sf._planned_resident_bytes() >= sf._neighborhoods_dev.data.nbytes
    np.testing.assert_array_equal(sf.nes_binary, want[0])
    np.testing.assert_array_equal(sf._logsf_dev.cpu().numpy(), want[1])
    np.testing.assert_array_equal(
        sf.attributes["num_neighborhoods_enriched"], want[2])


def test_wrappers_refuse_rather_than_fall_back(dev):
    x = torch.zeros((100, 100), device=dev)
    with pytest.raises(ValueError, match="% 32"):
        K.relax_panel(x, x, x)
    with pytest.raises(TypeError):
        K.close_diag(torch.zeros((128, 128), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="block 64 or 128"):
        K.close_diag(torch.zeros((32, 32), device=dev))
    with pytest.raises(ValueError, match="unit column stride"):
        y = torch.zeros((128, 256), device=dev)
        K.relax_panel(y.T[:128], y[:, :128], y.T[:128])
    with pytest.raises(ValueError, match="% 64"):
        K.relax_full(x[:, :64].clone(), x[:64].clone(), x)
    with pytest.raises(ValueError, match="apart from d"):
        K.relax_full(x[:64, :64], x[:64, :64].clone(), x[:64, :64])
    with pytest.raises(ValueError, match="% 64 with a band"):
        y = torch.zeros((128, 128), device=dev)
        K.relax_full(y[:, :32], y[:32].clone(), y.clone(), 1)
    # the banded kernel: a pivot-row panel that is not 16-byte aligned; a
    # window of whole tiles (1,024 listed) at an odd column
    with pytest.raises(ValueError, match="16-byte aligned p"):
        y = torch.zeros((128, 260), device=dev)
        K.relax_full(torch.zeros((128, 128), device=dev), y[:, 1:129],
                     torch.zeros((128, 128), device=dev), 0)
    with pytest.raises(ValueError, match="whole-tile form"):
        y = torch.zeros((4096, 4097), device=dev)
        K.relax_full(torch.zeros((4096, 128), device=dev),
                     torch.zeros((128, 4096), device=dev), y[:, 1:], 31)
    with pytest.raises(TypeError):
        K.minplus_product(x.double(), x.double())
    with pytest.raises(ValueError, match="relax_band_row kernel"):
        K.relax_band_row(x, x, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        y = torch.zeros((128, 260), device=dev)
        K.relax_panel(y[:, 1:129], y[:, 1:129], y[:, 1:129])
    # skew kernels: a window row stride that is no multiple of 4, a window
    # at an odd column, a block the kernels do not take
    q, p = torch.zeros((384, 128), device=dev), torch.zeros((128, 384),
                                                            device=dev)
    y = torch.zeros((384, 386), device=dev)
    for win in (y[:, :384], y[:, 1:385]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            K.relax_skew_sym(win, q, p, 1)
    with pytest.raises(ValueError, match="block 64 or 128"):
        K.relax_skew(torch.zeros((96, 96), device=dev),
                     torch.zeros((96, 32), device=dev),
                     torch.zeros((32, 96), device=dev), 1)
    # the window relax: a window origin or a row stride that is no
    # multiple of 4
    q, p = torch.zeros((256, 128), device=dev), torch.zeros((128, 256),
                                                            device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.relax_window_sym(q, p, torch.zeros((384, 384), device=dev), 2,
                           256, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.relax_window_sym(q, p, torch.zeros((384, 390), device=dev)[:, :384],
                           0, 256, 1)


# ------------------------------------------------- binary enrichment (A5)

def _f32_ulps(got, want):
    got = got.cpu().to(torch.float32).numpy()
    want = want.cpu().to(torch.float32).numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return np.where(same, 0.0, diff / np.spacing(np.abs(want))).max()


def _census_grid(M=3971, N=300, A=200, seed=5):
    rng = np.random.default_rng(seed)
    K = rng.integers(0, 400, (1, A)).astype(float)
    n = rng.integers(0, 600, (N, 1)).astype(float)
    k = np.floor(np.minimum(K, n) * rng.random((N, A)) ** 0.3)
    return np.broadcast_arrays(k, K, n)


def test_hypergeom_tail_and_finalization_on_the_card(dev):
    """The f64 tail loop on the card equals the host's (integer products,
    IEEE f64 divides and adds, one op a launch); the finalization's f32
    exp and log1p round as CUDA's do: within 4 f32 ulps, the indicator
    exactly."""
    from safepy_tpu_torch.ops import hypergeom as H

    M = 3971
    k, K, n = (torch.as_tensor(x) for x in _census_grid(M))
    lgt = torch.as_tensor(H.lgamma_table(M))
    it = H.tail_iterations(M, 400)
    cpu = H._sf_parts(k, M, K, n, lgt, it)
    gpu = H._sf_parts(k.to(dev), M, K.to(dev), n.to(dev), lgt.to(dev), it)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    for a, b in zip(H.finalize_logsf_device(cpu, 0.05),
                    H.finalize_logsf_device(gpu, 0.05)):
        if a.dtype == torch.int8:
            assert torch.equal(a, b.cpu())
        else:
            assert _f32_ulps(b, a) <= 4


def test_hypergeom_table_build_and_lookup_on_the_card(dev):
    """The class table on the card: within 1 f32 ulp plus 1e-11 of the
    host's (f64 log rounds in the last bit otherwise), the significance
    bits equal; the lookup of one table equal on both."""
    from safepy_tpu_torch.ops import hypergeom_table as T

    M = 3971
    K_dist = torch.as_tensor(np.r_[np.arange(3, 120, 2), [0.0] * 5]
                             .astype(np.float64))
    R, S_max = T.table_geometry(K_dist.numpy(), M, M)
    log_thr = float(np.log(0.05))
    cpu = T.build_logsf_table(K_dist, M, log_thr, R=R, S_max=S_max, C=64)
    gpu = T.build_logsf_table(K_dist.to(dev), M, log_thr, R=R, S_max=S_max,
                              C=64).cpu()
    diff = (gpu.double() - cpu.double()).abs()
    assert bool((diff <= torch.as_tensor(np.spacing(np.abs(cpu.numpy())))
                 .double() + 1e-11).all())
    thr32 = torch.tensor(log_thr, dtype=torch.float32)
    assert torch.equal(gpu < thr32, cpu < thr32)
    rng = np.random.default_rng(2)
    nsize = torch.as_tensor(rng.integers(0, 400, 500).astype(np.float32))
    colc = torch.as_tensor(rng.integers(0, 59, 300))
    Kc = K_dist[colc].to(torch.float32)
    counts = torch.floor(torch.minimum(nsize[:, None], Kc[None, :])
                         * torch.as_tensor(rng.random((500, 300)),
                                           dtype=torch.float32))
    want = T.table_lookup(cpu, counts, nsize, colc, float(thr32), S_max=S_max,
                          R=R, C=64)
    got = T.table_lookup(cpu.to(dev), counts.to(dev), nsize.to(dev),
                         colc.to(dev), float(thr32), S_max=S_max, R=R, C=64)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("row_chunk", [None, 128])
def test_fdr_bh_logsf_on_the_card(dev, row_chunk):
    from safepy_tpu_torch.ops import fdr

    rng = np.random.default_rng(4)
    logp = np.log(rng.random((700, 300))).astype(np.float32)
    logp[0, :3] = [-np.inf, -500.0, 0.0]
    logp[1, ::4] = np.nan
    cpu = fdr.fdr_bh_logsf(torch.as_tensor(logp), np.log(0.05),
                           row_chunk=row_chunk)
    gpu = fdr.fdr_bh_logsf(torch.as_tensor(logp, device=dev), np.log(0.05),
                           row_chunk=row_chunk)
    assert _f32_ulps(gpu[0], cpu[0]) <= 1
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert torch.equal(gpu[2].cpu(), cpu[2])


def test_hypergeom_sf_on_numpy_operands_computes_on_the_card(dev):
    """As the other entry points: numpy operands go to the card; the result
    (numpy, finalized on the host) equals the CPU tensors' within 1e-12."""
    from safepy_tpu_torch import ops

    k, K, n = _census_grid(N=50, A=40)
    for fn in (ops.hypergeom_sf, ops.hypergeom_neglog10_sf):
        got = fn(k, 3971, K, n)
        want = fn(*(torch.as_tensor(x) for x in (k,)), 3971,
                  torch.as_tensor(K), torch.as_tensor(n))
        assert isinstance(got, np.ndarray)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert np.max(np.abs(got[fin] - want[fin])) <= 1e-12


@pytest.mark.parametrize("engine", ["auto", "loop"])
def test_cuda_binary_session_matches_cpu_session(dev, engine):
    """The fused binary run_pipeline on the card and on the host: the same
    engine, neighborhoods, indicator and enriched counts; p-values within
    4 f32 ulps of their log-survival; the banded window's kernels
    launched."""
    net = _network()
    coords = net[0]
    rng = np.random.default_rng(1)
    vals = np.zeros((700, 60))
    for j in range(60):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        vals[:, j] = near & (rng.random(700) < 0.6)
    vals[rng.random(700) < 0.1] = np.nan
    runs = []
    for device in ("cpu", dev):
        sf = SAFE(device=device, verbose=False)
        sf.hypergeom_engine = engine
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        sf.run_pipeline()
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, _), (gpu, gpu_launches) = runs
    assert gpu._hypergeom_engine_used == cpu._hypergeom_engine_used
    assert gpu_launches["relax_window_sym"] == 6
    np.testing.assert_array_equal(gpu.neighborhoods, cpu.neighborhoods)
    np.testing.assert_array_equal(gpu.nes_binary, cpu.nes_binary)
    np.testing.assert_array_equal(gpu.attributes["num_neighborhoods_enriched"],
                                  cpu.attributes["num_neighborhoods_enriched"])
    pc = cpu.pvalues_pos
    assert np.all(np.abs(gpu.pvalues_pos - pc)
                  <= 1e-9 + 2.0 ** -21 * pc
                  * np.abs(np.log(np.maximum(pc, 1e-300))))


def _band_go_matrix(coords, a=40, seed=6):
    rng = np.random.default_rng(seed)
    n = len(coords)
    vals = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        vals[:, j] = near & (rng.random(n) < 0.6)
    vals[rng.random(n) < 0.1] = np.nan
    return vals


@pytest.mark.parametrize("staged", [False, True], ids=["fused", "staged"])
@pytest.mark.parametrize("label,engine,attr_chunk", [
    ("table-band", "auto", None), ("hostchunks-band", "loop", 7),
    ("loop-band", "loop", None)])
def test_cuda_band_binary_session_matches_cpu_session(dev, label, engine,
                                                      attr_chunk, staged):
    """The band GO engines on the card and on the host, band storage
    forced: the same engine, neighborhoods, indicator and enriched counts;
    the log-survival within 4 f32 ulps (the tail loop's f32 exp and log1p)
    or 1 ulp plus 1e-11 (the class table's f64 log); one launch of each
    band FW kernel a round on the card."""
    net = _network(n=900)
    vals = _band_go_matrix(net[0])
    runs = []
    for device in ("cpu", dev):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode, sf.hypergeom_engine = "band", engine
        if attr_chunk is not None:
            sf._hypergeom_attr_chunk = lambda n, a, budget_elems=0: attr_chunk
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        if staged:
            sf.define_neighborhoods()
            sf.compute_pvalues()
        else:
            sf.run_pipeline()
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, _), (gpu, launches) = runs
    want = label + ("-staged" if staged else "")
    assert gpu._hypergeom_engine_used == cpu._hypergeom_engine_used == want
    nb = -(-900 // 128)
    assert (launches["close_diag"], launches["relax_panel"],
            launches["relax_skew_sym"]) == (nb, nb, nb)
    np.testing.assert_array_equal(gpu.neighborhoods, cpu.neighborhoods)
    np.testing.assert_array_equal(gpu.nes_binary, cpu.nes_binary)
    np.testing.assert_array_equal(gpu.attributes["num_neighborhoods_enriched"],
                                  cpu.attributes["num_neighborhoods_enriched"])
    got, ref = gpu._logsf_dev, cpu._logsf_dev
    if label == "table-band":
        diff = (got.cpu().double() - ref.double()).abs()
        assert bool((diff <= torch.as_tensor(np.spacing(np.abs(ref.numpy())))
                     .double() + 1e-11).all())
    else:
        assert _f32_ulps(got, ref) <= 4


def test_band_table_residencies_on_the_card(dev):
    """hypergeom_band_table on the card: 'host' bit-equal to 'device',
    'f16' with the same indicator and counts; each within the table's
    tolerance of the host run."""
    from safepy_tpu_torch.ops import enrich_band as eb

    net = _network(n=900)
    sf = SAFE(device=dev, verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=_band_go_matrix(net[0]))
    sf.define_neighborhoods()
    bm = sf._neighborhoods_dev
    order = np.argsort(bm.rank)
    nan0, nnn, K_, ok, M = sf._band_hyper_operands_cached(order)
    assert ok and nan0.is_cuda
    kw = dict(bt=bm.bt, rank_np=bm.rank, chunk_cols=16, K_np=K_.cpu().numpy())
    out = {mode: eb.hypergeom_band_table(bm.data, nan0, nnn, M, 0.05,
                                         logsf_out=mode, **kw)
           for mode in ("device", "f16", "host")}
    cpu = eb.hypergeom_band_table(bm.data.cpu(), nan0.cpu(), nnn.cpu(), M,
                                  0.05, **kw)
    dev_logsf, dev_bin, dev_counts = out["device"]
    np.testing.assert_array_equal(out["host"][0], dev_logsf.cpu().numpy())
    np.testing.assert_array_equal(out["host"][1], dev_bin.cpu().numpy())
    assert out["f16"][0].dtype == torch.float16
    for mode in ("f16", "host"):
        np.testing.assert_array_equal(np.asarray(out[mode][1].cpu()
                                                 if mode == "f16"
                                                 else out[mode][1]),
                                      cpu[1].numpy())
        assert torch.equal(out[mode][2].cpu(), cpu[2])
    diff = (dev_logsf.cpu().double() - cpu[0].double()).abs()
    assert bool((diff <= torch.as_tensor(np.spacing(np.abs(cpu[0].numpy())))
                 .double() + 1e-11).all())
    assert torch.equal(dev_bin.cpu(), cpu[1])
    assert torch.equal(dev_counts.cpu(), cpu[2])


def test_domain_ops_on_the_card_are_exact(dev):
    """The intersection GEMM past the counts where bf16 (256) and fp16
    (2,048) outputs would round equals the host f64 product; the node
    aggregates and the CSC view equal their CPU results."""
    from safepy_tpu_torch.ops import domains_device as dd

    rng = np.random.default_rng(4)
    b = (rng.random((3000, 300)) < 0.8).astype(np.int8)
    b[:, 7] = 0
    want = b.T.astype(np.float64) @ b.astype(np.float64)
    assert want.max() > 2048
    np.testing.assert_array_equal(
        dd.enrichment_intersections(torch.as_tensor(b, device=dev)), want)
    np.testing.assert_array_equal(dd.enrichment_intersections(b, dev), want)
    nes = rng.normal(size=b.shape).astype(np.float32)
    nes[rng.random(b.shape) < 0.3] = np.nan
    dom = rng.integers(0, 9, size=300)
    got = dd.domain_aggregates(torch.as_tensor(b, device=dev),
                               torch.as_tensor(nes, device=dev), dom, 10)
    for g, w in zip(got, dd.domain_aggregates(torch.as_tensor(b),
                                              torch.as_tensor(nes), dom, 10)):
        np.testing.assert_array_equal(g, w)
    sparse = b * (rng.random(b.shape) < 0.05)
    csc = dd.indicator_csc(torch.as_tensor(sparse, device=dev),
                           sparse.sum(axis=0))
    np.testing.assert_array_equal(csc.toarray(), sparse)


@pytest.mark.parametrize("engine", ["gemm", "scipy"])
def test_cuda_domain_stage_matches_cpu_session(dev, engine):
    """The domain stage of a CUDA binary session (device indicator and NES)
    equals that of a CPU session handed the same indicator, NES and
    enriched counts through the setters, exactly, labels included."""
    net = _network()
    coords = net[0]
    rng = np.random.default_rng(2)
    vals = np.zeros((700, 120))
    for j in range(120):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        vals[:, j] = near & (rng.random(700) < 0.6)
    vals[rng.random(700) < 0.1] = np.nan
    gpu = SAFE(device=dev, verbose=False)
    gpu.load_network(network_file=net)
    gpu.load_attributes(attribute_file=vals)
    gpu.run_pipeline()
    cpu = SAFE(device="cpu", verbose=False)
    cpu.load_network(network_file=net)
    cpu.load_attributes(attribute_file=vals)
    cpu.nes_binary = gpu.nes_binary
    cpu.nes = gpu.nes
    cpu.attributes["num_neighborhoods_enriched"] = \
        gpu.attributes["num_neighborhoods_enriched"]
    for sf in (gpu, cpu):
        sf.cluster_engine = engine
        sf.define_top_attributes()
        sf.define_domains()
        sf.trim_domains()
    assert gpu._nes_binary_dev.device.type == dev.type
    assert int(gpu.attributes["top"].sum()) >= 2
    for k in ("top", "num_connected_components", "domain"):
        np.testing.assert_array_equal(gpu.attributes[k], cpu.attributes[k])
    for k in ("domains", "counts", "primary_domain", "primary_nes"):
        np.testing.assert_array_equal(getattr(gpu.node2domain, k),
                                      getattr(cpu.node2domain, k))
    np.testing.assert_array_equal(gpu.domains["id"], cpu.domains["id"])
    assert gpu.domains["label"] == cpu.domains["label"]
    if engine == "gemm":
        b = gpu.nes_binary
        np.testing.assert_array_equal(gpu._domains_inter_cache, b.T @ b)


# ---------------------------------------------- the A7 remainder on the card

def test_packed_band_consumers_on_the_card(dev):
    """The bit-packed band's consumers on the card against the host: pack,
    unpack, the packed threshold, per-row sizes, the banded products and
    the packed compaction, bitwise (dyadic operands: every f32 sum is exact
    in any order), and a packed band's products equal the int8 band's."""
    from safepy_tpu_torch.ops import apsp_bandstore as bs

    rng = np.random.default_rng(5)
    n, band = 1500, 300
    coords = np.sort(rng.uniform(-1, 1, (n, 2)).astype(np.float32), axis=0)
    dist = bs.euclidean_band_distances(torch.as_tensor(coords), n=n, band=band)
    r = np.float32(0.06)
    bt = band // 128 + 1
    valid = rng.random(n) < 0.7
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt)
    def dyadic(*shape):
        return torch.as_tensor(rng.integers(-8, 9, shape) / 4,
                               dtype=torch.float32)

    x = dyadic(-(-n // 128) * 128, 3)
    xb = dyadic(4, int(valid.sum()) + w_c, 2)
    obs = dyadic(x.shape[0], 2)
    out = {}
    for device in ("cpu", dev):
        packed = bs.band_threshold(dist.to(device), r, packed=True,
                                   chunk_blocks=3)
        plain = bs.band_threshold(dist.to(device), r)
        assert torch.equal(bs.unpack_band_bits(packed), plain)
        assert torch.equal(bs.pack_band_bits(plain), packed)
        comp = bs.apply_compaction(packed, valid, w_c, bt=bt)
        assert torch.equal(bs.band_matmul(packed, x.to(device), bt=bt),
                           bs.band_matmul(plain, x.to(device), bt=bt))
        out[device] = [packed, bs.band_row_sizes(packed), comp,
                       bs.band_matmul(packed, x.to(device), bt=bt),
                       *bs.band_count_batch(comp, xb.to(device), starts,
                                            obs.to(device), bt=bt)]
    for got, want in zip(out[dev], out["cpu"]):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_euclidean_band_on_the_card(dev, packed):
    """The euclidean band built on the card is the host's bitwise (the same
    f64 sum of squares and f64 root, rounded to f32 once each), and a CUDA
    euclidean band session equals a CPU one."""
    from safepy_tpu_torch.ops import apsp_bandstore as bs

    rng = np.random.default_rng(6)
    n, band = 2000, 400
    coords = np.sort(rng.uniform(-1, 1, (n, 2)).astype(np.float32), axis=0)
    got = bs.euclidean_band_distances(torch.as_tensor(coords, device=dev),
                                      n=n, band=band)
    want = bs.euclidean_band_distances(torch.as_tensor(coords), n=n,
                                       band=band)
    assert torch.equal(got.cpu(), want)
    ind = bs.euclidean_band_indicator(torch.as_tensor(coords, device=dev),
                                      np.float32(0.05), n=n, band=band,
                                      packed=packed)
    assert torch.equal(ind.cpu(), bs.euclidean_band_indicator(
        torch.as_tensor(coords), np.float32(0.05), n=n, band=band,
        packed=packed))

    vals = rng.integers(-3, 4, (n, 1)).astype(float)
    vals[rng.random(n) < 0.3] = np.nan
    perm_idx = np.stack([rng.permutation(int(np.isfinite(vals).sum()))
                         for _ in range(50)])
    runs = []
    for device in ("cpu", dev):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode, sf.node_distance_metric = "band", "euclidean"
        sf.keep_node_distances = not packed
        sf.band_indicator_bits = packed
        sf.load_network(network_file=(coords, np.zeros((0, 2), np.int64),
                                      None, None))
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        sf.run_pipeline(perm_idx=perm_idx)
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, _), (gpu, launches) = runs
    assert not any(launches.values())  # the euclidean band runs no FW
    assert gpu._neighborhoods_dev.data.dtype == (torch.uint8 if packed
                                                 else torch.int8)
    assert torch.equal(gpu._neighborhoods_dev.data.cpu(),
                       cpu._neighborhoods_dev.data)
    np.testing.assert_array_equal(gpu.ns, cpu.ns)
    np.testing.assert_array_equal(gpu.counts_neg, cpu.counts_neg)
    np.testing.assert_array_equal(gpu.counts_pos, cpu.counts_pos)


@pytest.mark.parametrize("budget", [None, 1])
def test_band_bf_on_the_card(dev, monkeypatch, budget):
    """``band_relax='bf'`` on the card: the band, the flag and the rounds
    of ``apsp_band_bf`` equal the host's; the session records "bf" and
    gives the FW session's indicator and counts; with a budget of one round
    it records "bf->fw" and launches the FW kernels once a round."""
    from safepy_tpu_torch.ops import apsp_bandstore as bs
    from safepy_tpu_torch.ops.neighborhoods import inclusive_radius

    if budget is not None:
        monkeypatch.setattr(bs, "bf_max_iters", lambda *a, **k: budget)
    net = _network(n=900)
    rng = np.random.default_rng(2)
    vals = rng.integers(-3, 4, (900, 1)).astype(float)
    vals[rng.random(900) < 0.3] = np.nan
    perm_idx = np.stack([rng.permutation(int(np.isfinite(vals).sum()))
                         for _ in range(50)])
    runs = []
    for device, relax in (("cpu", "bf"), (dev, "bf"), (dev, "fw")):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode, sf.band_relax = "band", relax
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        K.reset_launches()
        sf.run_pipeline(perm_idx=perm_idx)
        runs.append((sf, dict(K.LAUNCHES)))
    (cpu, _), (gpu, launches), (fw, _) = runs
    want = "bf" if budget is None else "bf->fw"
    assert gpu._band_relax_used == cpu._band_relax_used == want
    nb = -(-900 // 128)
    assert launches["relax_skew_sym"] == (0 if budget is None else nb)
    assert torch.equal(gpu._neighborhoods_dev.data.cpu(),
                       cpu._neighborhoods_dev.data)
    assert torch.equal(gpu._neighborhoods_dev.data, fw._neighborhoods_dev.data)
    np.testing.assert_array_equal(gpu.counts_neg, fw.counts_neg)
    np.testing.assert_array_equal(gpu.counts_pos, fw.counts_pos)
    plan = next(p for p in gpu._bandstore_cache.values() if p)
    if budget is None:
        s0 = bs.band_init_from_edges(plan["u"], plan["v"], plan["w"], n=900,
                                     band=plan["band"])
        bt = plan["band"] // 128 + 1
        x = net[0][:, 0]
        r = inclusive_radius(gpu.neighborhood_radius * (x.max() - x.min()))
        got = bs.apsp_band_bf(s0.clone(), *plan["bf_slots"], r, bt=bt)
        want_s = bs.apsp_band_bf(
            s0.cpu(), *(t.cpu() for t in plan["bf_slots"]), r, bt=bt)
        assert torch.equal(got[0].cpu(), want_s[0])
        assert got[1:] == want_s[1:]


# --------------------------------------------- the file-driven workflow (A9)

def _knn_edges(n, k=6, seed=2):
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    return np.asarray(sorted({(min(i, int(j)), max(i, int(j)))
                              for i in range(n) for j in nn[i, 1:]}),
                      np.int64)


@pytest.mark.parametrize("engine", ["dense", "energy"])
def test_layouts_run_on_the_card_by_default(dev, monkeypatch, engine):
    """The device spring layouts default to the card, and after a few
    iterations agree with the CPU run within 2e-5 (float32 reductions
    round differently on the two; tests/test_torch_layout.py holds the CPU
    run against JAX's)."""
    from safepy_tpu_torch.io import layout as L

    n = 300
    edges = _knn_edges(n)
    fn = (L._spring_dense if engine == "dense"
          else L.spring_layout_energy_device)
    seen = []
    orig = torch.as_tensor

    def spy(x, *a, **kw):
        out = orig(x, *a, **kw)
        seen.append(out.device.type)
        return out

    monkeypatch.setattr(L.torch, "as_tensor", spy)
    got = fn(n, edges, k=0.2, iterations=3, seed=4)
    monkeypatch.setattr(L.torch, "as_tensor", orig)
    assert seen and set(seen) == {"cuda"}
    want = fn(n, edges, k=0.2, iterations=3, seed=4, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_file_session_on_the_card_matches_cpu(dev, tmp_path):
    """SAFE(path_to_ini_file=...) on the card: the spring_tpu layout on
    the card, then the stages; neighborhoods and indicator equal a CPU
    session's handed the card's coordinates."""
    n = 600
    edges = _knn_edges(n, seed=5)
    net = tmp_path / "net.txt"
    net.write_text("".join(f"g{u}\tg{v}\t1.0\n" for u, v in edges))
    rng = np.random.default_rng(6)
    attrs = tmp_path / "attrs.txt"
    attrs.write_text("gene\tt0\tt1\n" + "".join(
        f"g{i}\t{int(rng.random() < 0.2)}\t{int(rng.random() < 0.3)}\n"
        for i in range(n)))
    ini = tmp_path / "run.ini"
    ini.write_text(f"[Input files]\nnetworkfile = {net}\nannotationfile = "
                   f"{attrs}\nlayoutAlgorithm = spring_tpu\n"
                   "[Analysis parameters]\nrandomSeed = 3\n")
    gpu = SAFE(path_to_ini_file=str(ini), verbose=False)
    assert gpu.device.type == "cuda"
    gpu.load_network(node_key_attribute="key")
    gpu.load_attributes()
    assert gpu.graph.nodes["x"].dtype == np.float32
    gpu.define_neighborhoods()
    gpu.compute_pvalues()
    cpu = SAFE(device="cpu", verbose=False)
    cpu.load_network(network_file=gpu.graph, node_key_attribute="key")
    cpu.load_attributes(attribute_file=str(attrs))
    cpu.define_neighborhoods()
    cpu.compute_pvalues()
    np.testing.assert_array_equal(gpu.neighborhoods, cpu.neighborhoods)
    np.testing.assert_array_equal(gpu.nes_binary, cpu.nes_binary)


# --------------------------------------------------- save and checkpoints


def _card_session(dev, apsp_mode, bits=False, n=900):
    sf = SAFE(device=dev, verbose=False)
    sf.apsp_mode = apsp_mode
    sf.band_indicator_bits = bits
    net = _network(n=n)
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=_band_go_matrix(net[0]))
    sf.run_pipeline()
    return sf


_PUBLIC = ("neighborhoods", "node2attribute", "pvalues_pos", "nes",
           "nes_binary")


@pytest.mark.parametrize("apsp_mode,bits", [("auto", False), ("band", False),
                                            ("band", True)])
def test_pickle_on_the_card(dev, apsp_mode, bits):
    """A CUDA session pickles no tensor (numpy, device as its string), loads
    bitwise, serves one column at a time and refuses an out-of-range
    column on the host; a band session's band stays numpy until the
    enrichment runs again on the card, with the same results."""
    import pickle

    sf = _card_session(dev, apsp_mode, bits)
    blob = pickle.dumps(sf)
    assert b"torch._utils" not in blob and b"_rebuild_tensor" not in blob
    back = pickle.loads(blob)
    assert back.device == torch.device(str(sf.device))
    for name in _PUBLIC:
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(sf, name), err_msg=name)
    a = sf._logsf_dev.shape[1]
    for j in (0, a - 1):
        np.testing.assert_array_equal(back._nes_column(j), sf.nes[:, j])
    fresh = _card_session(dev, apsp_mode, bits)
    with pytest.raises(IndexError, match="out of range"):
        fresh._nes_binary_column(a)
    np.testing.assert_array_equal(fresh._nes_column(3), sf.nes[:, 3])
    if apsp_mode == "band":
        assert isinstance(back._neighborhoods_dev.data, np.ndarray)
        back.compute_pvalues()
        assert back._neighborhoods_dev.data.device.type == "cuda"
        np.testing.assert_array_equal(back.nes_binary, sf.nes_binary)


@pytest.mark.parametrize("bits", [False, True])
def test_checkpoint_on_the_card(dev, tmp_path, monkeypatch, bits):
    """save_session of a CUDA band session (the dense guard lowered to this
    scale) writes its band in its dtype; load_session(device='cuda')
    resumes: the enrichment and the top attributes equal the original's."""
    from safepy_tpu_torch import checkpoint
    from safepy_tpu_torch.ops.apsp_bandstore import BandedMatrix

    monkeypatch.setattr(BandedMatrix, "DENSE_MAX_BYTES", 1000)
    sf = _card_session(dev, "band", bits)
    sf.define_top_attributes(attribute_enrichment_min_size=3)
    path = str(tmp_path / "s")
    checkpoint.save_session(sf, path)
    with np.load(path + ".npz") as data:
        assert data["neighborhoods_band"].dtype == (np.uint8 if bits
                                                    else np.int8)
    back = checkpoint.load_session(path, graph=sf.graph, verbose=False,
                                   device="cuda")
    for name in _PUBLIC[1:]:
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(sf, name), err_msg=name)
    back.compute_pvalues()
    np.testing.assert_array_equal(back.nes_binary, sf.nes_binary)
    back.define_top_attributes(attribute_enrichment_min_size=3)
    np.testing.assert_array_equal(back.attributes["top"], sf.attributes["top"])


def test_device_budget_counts_free_cache_and_own_bytes(dev):
    """``hbm.device_hbm_budget`` on the card: what CUDA reports free,
    plus the allocator's whole free segments (not the free remainders of
    segments a live tensor holds), plus the caller's own residents; a live
    tensor that is not the caller's is out of it."""
    from safepy_tpu_torch import hbm

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    big = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    del big  # a free 96 MiB block: its segment is releasable
    other = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the 64 MiB tensor takes the cached block: the 32 MiB remainder is a
    # split no longer releasable
    free, _ = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    split = stats["inactive_split_bytes.all.current"]
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    assert split > 0
    assert hbm.releasable_cache_bytes(dev) == cached - split
    assert hbm.device_hbm_budget(dev) == free + cached - split
    assert hbm.device_hbm_budget(dev, own_bytes=other.nbytes) \
        == free + cached - split + other.nbytes
    del other
