"""The Floyd-Warshall round on hand-written CUDA kernels, with plain versions.

Port of the path that ``safepy_tpu/ops/apsp_pallas.py`` takes through its
Pallas kernels. Three wrappers, each beside its plain torch version:

  * :func:`relax_panel` -- ``min(C, A (x) B)`` with one 128-wide operand;
    replaces ``_relax_rows`` :95 (A = closed diagonal, B = C = pivot row panel)
    and ``_relax_cols`` :128 (A = C = pivot column panel, B = closed diagonal).
  * :func:`relax_window_sym` -- phase 3 on a window, in place; replaces
    ``_relax_full_banded_sym`` :193.
  * :func:`close_diag` -- closure of the pivot tile; replaces ``_close_diag``
    :258.

two for the classic (non-symmetric) rounds and the product of the op-level
surface (``ops.apsp``):

  * :func:`relax_full` -- ``min(D, Q (x) P)`` over a whole (m, n) matrix or
    window, in place; replaces ``_relax_full`` :144 and, with a tile band,
    ``_relax_full_banded`` :161;
  * :func:`minplus_product` -- ``A (x) B`` into a new tensor; replaces
    ``min_plus_pallas`` :62;

two for phase 3 of the band-storage round
(``safepy_tpu/ops/apsp_bandstore.py``, driven by ``ops.apsp_bandstore``):

  * :func:`relax_skew_sym` -- the skewed window's upper wedge plus mirror, in
    place; replaces ``_relax_skew_sym_pallas`` :324;
  * :func:`relax_skew` -- every in-band tile of the skewed window, in place;
    replaces ``_relax_skew_pallas`` :281;

and one for the row-sharded band round (``parallel.band_sharded``):

  * :func:`relax_band_rows` -- ``min(C, Q (x) P)`` on each of a round's
    (block, W) window rows, in place, in one launch; :func:`relax_band_row`
    is its one-row form into a new tensor. Replaces ``_relax_panel`` :111.

A wrapper takes the plain version only for CPU tensors. A CUDA tensor goes
through the kernel (``csrc/minplus.cu``, built by :mod:`safepy_tpu_torch.native`)
or raises. Each kernel launch adds one to :data:`LAUNCHES`.

:func:`fw_round` is one round of the blocked Floyd-Warshall, shared by the
dense :func:`apsp_blocked_fw` and the banded ``ops.apsp_banded.apsp_banded_fw``.
Every candidate ``a + b`` is one f32 rounding and ``min`` is exact, so the
kernels and the plain versions agree bitwise; the round structure (pivot
block, panels snapshotted before phase 3, window origin, band) is what fixes
the result, and it is the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from safepy_tpu_torch.ops.apsp import (_apsp_torch, _min_plus_torch,
                                       min_plus_relax, pad_distances)
from safepy_tpu_torch.profiling import span

# Kernel launches since the last reset_launches(), by wrapper name;
# relax_full counts its whole-matrix and its banded launches apart.
LAUNCHES = {"relax_panel": 0, "relax_window_sym": 0, "close_diag": 0,
            "relax_skew_sym": 0, "relax_skew": 0, "relax_full": 0,
            "relax_full_banded": 0, "minplus_product": 0,
            "relax_band_row": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"min-plus kernels take float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"min-plus kernels take 2-D tensors, got {t.dim()}-D")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no min-plus kernel for device {dev}")
    for t in tensors:
        if t.stride(1) != 1:
            raise ValueError("CUDA min-plus kernels need unit column stride, "
                             f"got strides {t.stride()}")
    return True


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# --------------------------------------------------------------- relax_panel

relax_panel_plain = min_plus_relax  # plain version of relax_panel


def _check_panel(name: str, c: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> bool:
    """Shapes of ``min(C, A (x) B)``; False for CPU tensors (plain version),
    True for CUDA tensors the panel kernel takes; raise otherwise."""
    m, k = a.shape
    if b.shape[0] != k or tuple(c.shape) != (m, b.shape[1]):
        raise ValueError(f"shape mismatch: c {tuple(c.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not _use_kernel(c, a, b):
        return False
    n = b.shape[1]
    if m % 32 or n % 32 or k % 32:
        raise ValueError(f"{name} kernel needs m, n, k % 32 == 0, got m={m} "
                         f"n={n} k={k}")
    # the kernel copies and loads 16 bytes at a time
    for t in (c, a, b):
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError(f"{name} kernel needs 16-byte aligned operands "
                             f"with row strides % 4 == 0, got stride "
                             f"{t.stride(0)} at offset {t.data_ptr() % 16}")
    return True


def _check_out(name: str, out: torch.Tensor, shape, like: torch.Tensor):
    """Raise unless ``out`` is an f32 buffer of ``shape`` on ``like``'s
    device, apart from ``like``, with unit column stride."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.float32
            or out.device != like.device or out.stride(1) != 1):
        raise ValueError(f"{name}: out must be a {tuple(shape)} float32 "
                         f"tensor on {like.device} with unit column stride, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if out.untyped_storage().data_ptr() == like.untyped_storage().data_ptr():
        raise ValueError(f"{name}: out must lie apart from its operands")


def relax_panel(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``min(C, A (x) B)`` into a new (m, n) tensor, or into ``out``, which
    is returned; C is not modified.

    a: (m, k), b: (k, n), c: (m, n) float32, any row stride. On CUDA, m, n
    and k must be multiples of 32, and each operand 16-byte aligned with a
    row stride that is a multiple of 4; so must ``out`` be, which lies apart
    from the operands (a workspace reused round after round).
    """
    m, k = a.shape
    n = b.shape[1]
    if out is not None:
        _check_out("relax_panel", out, (m, n), c)
    if not _check_panel("relax_panel", c, a, b):
        relaxed = min_plus_relax(c, a, b)
        return relaxed if out is None else out.copy_(relaxed)
    from safepy_tpu_torch import native

    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=c.device)
    elif out.data_ptr() % 16 or out.stride(0) % 4:
        raise ValueError("relax_panel kernel needs a 16-byte aligned out with "
                         f"a row stride % 4 == 0, got stride {out.stride(0)} "
                         f"at offset {out.data_ptr() % 16}")
    native.launch("relax_panel", _ptr(a), a.stride(0), _ptr(b), b.stride(0),
                  _ptr(c), c.stride(0), _ptr(out), out.stride(0), m, n, k,
                  _stream(c))
    LAUNCHES["relax_panel"] += 1
    return out


# ------------------------------------------------------------ relax_band_row

# plain version of relax_band_row, called as relax_band_row_plain(c, q, p)
relax_band_row_plain = min_plus_relax


def _launch_band_rows(q, q_rs, p, p_rs, c, c_rs, out, o_rs, rows):
    from safepy_tpu_torch import native

    m, k = q.shape[-2:]
    native.launch("relax_band_rows", _ptr(q), q.stride(-2), q_rs, _ptr(p),
                  p.stride(0), p_rs, _ptr(c), c.stride(0), c_rs, _ptr(out),
                  out.stride(0), o_rs, rows, m, p.shape[1], k, _stream(c))
    LAUNCHES["relax_band_row"] += 1


def relax_band_row(q: torch.Tensor, p: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """``min(C, Q (x) P)`` into a new (block, W) tensor; C is not modified
    (``apsp_pallas._relax_panel`` :111, the argument order of the JAX call).

    One window row of the row-sharded band FW: q (block, block) is the
    row's pivot-column tile, which may be a view into ``c``; p (block, W) a
    slice of the inf-extended pivot row; any row strides (aligned as for
    :func:`relax_panel`). The one-row launch of :func:`relax_band_rows`'s
    kernel.
    """
    if not _check_panel("relax_band_row", c, q, p):
        return relax_band_row_plain(c, q, p)
    out = torch.empty(tuple(c.shape), dtype=torch.float32, device=c.device)
    _launch_band_rows(q, 0, p, 0, c, 0, out, 0, 1)
    return out


def _band_rows_geometry(rows: torch.Tensor, p_ext: torch.Tensor, o_lo: int,
                        o_hi: int):
    """(block, W, nt) of a round's window rows o_lo .. o_hi - 1; raise
    unless ``rows`` holds them and ``p_ext`` is their inf-extended pivot
    row."""
    block = p_ext.shape[0]
    width = rows.shape[1]
    nt = width // block
    if (width % block or nt % 2 == 0 or rows.shape[0] != (o_hi - o_lo) * block
            or not 0 <= o_lo < o_hi <= nt
            or p_ext.shape[1] != width + (nt - 1) * block):
        raise ValueError(f"bad window rows: rows {tuple(rows.shape)}, p_ext "
                         f"{tuple(p_ext.shape)}, o_lo={o_lo}, o_hi={o_hi}")
    return block, width, nt


def relax_band_rows_plain(rows: torch.Tensor, p_ext: torch.Tensor, o_lo: int,
                          o_hi: int) -> None:
    """Plain version of :func:`relax_band_rows`, also in place: each row
    through ``min_plus_relax`` (:func:`relax_band_row_plain`)."""
    block, width, nt = _band_rows_geometry(rows, p_ext, o_lo, o_hi)
    for z, o in enumerate(range(o_lo, o_hi)):
        c = rows[z * block:(z + 1) * block]
        q = c[:, (nt - 1 - o) * block:(nt - o) * block]
        c.copy_(relax_band_row_plain(c, q,
                                     p_ext[:, o * block:o * block + width]))


def relax_band_rows(rows: torch.Tensor, p_ext: torch.Tensor, o_lo: int,
                    o_hi: int) -> None:
    """Window rows o_lo .. o_hi - 1 of a sharded band round, in place, in
    one launch (``apsp_pallas._relax_panel`` :111 on each row).

    rows: the ((o_hi - o_lo) block, W) block-rows of the slab that hold
    window rows o_lo .. o_hi - 1, W = (2 bt + 1) block, any row stride;
    p_ext: (block, W + 2 bt block), the relaxed pivot row inf-extended by bt
    tiles on each side, apart from ``rows``. Window row o becomes ``min(C,
    Q (x) P)`` with C the row, Q its tile (o, 2 bt - o) as it stood before
    the call and P = ``p_ext[:, o block : o block + W]``. The Q tiles are
    snapshotted in one gather, so a row's Q is read before it is rewritten,
    as when the rows are relaxed one by one.
    """
    block, width, nt = _band_rows_geometry(rows, p_ext, o_lo, o_hi)
    if not _use_kernel(rows, p_ext):
        relax_band_rows_plain(rows, p_ext, o_lo, o_hi)
        return
    nr = o_hi - o_lo
    z = torch.arange(nr, device=rows.device)
    # (nr, block, block): tile (z, nt - 1 - o_lo - z) of the rows, contiguous
    qs = rows.unflatten(0, (nr, block)).unflatten(2, (nt, block))[
        z, :, nt - 1 - o_lo - z, :]
    p = p_ext[:, o_lo * block:o_lo * block + width]  # row o_lo's P
    _check_panel("relax_band_row", rows[:block], qs[0], p)  # or raise
    _launch_band_rows(qs, block * block, p, block, rows,
                      block * rows.stride(0), rows, block * rows.stride(0),
                      nr)


# ---------------------------------------------------------- relax_window_sym

def relax_window_sym_plain(q: torch.Tensor, p: torch.Tensor, d: torch.Tensor,
                           lo: int, w: int, band_tiles: int) -> None:
    """Plain version of :func:`relax_window_sym`, also in place on ``d``."""
    block = q.shape[1]
    win = d[lo:lo + w, lo:lo + w]
    relaxed = min_plus_relax(win, q, p)
    tile = torch.arange(w, device=d.device) // block
    off = tile[None, :] - tile[:, None]          # tile column - tile row
    upper = (off >= 0) & (off <= band_tiles)
    lower = (off < 0) & (off >= -band_tiles)
    out = torch.where(upper, relaxed, win)
    out = torch.where(lower, out.T, out)
    win.copy_(out)


def window_tiles(nbw: int, band_tiles: int) -> torch.Tensor:
    """(T, 4) int32 CPU tensor of the upper in-band tiles of a window of
    ``nbw`` block-tiles, the tiles :func:`relax_window_sym`'s kernel relaxes,
    one row each: (i, j, j, i) for ``0 < j - i <= band_tiles`` (the tile and
    the lower tile its transpose goes to), (i, i, -1, -1) on the diagonal;
    the row convention of :func:`skew_tiles`."""
    rows = [(i, j, j, i) if j > i else (i, i, -1, -1) for i in range(nbw)
            for j in range(i, min(i + band_tiles, nbw - 1) + 1)]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def _device_window_tiles(nbw: int, band_tiles: int, device) -> torch.Tensor:
    """:func:`window_tiles` on ``device``, uploaded once a (nbw, band_tiles,
    device) and only read by the kernels."""
    return window_tiles(nbw, band_tiles).to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def window_sym_whole(n_tiles: int, block: int, device) -> bool:
    """Whether :func:`relax_window_sym` relaxes ``n_tiles`` listed tiles as
    whole tiles on the tile engine rather than as 32x32 sub-tiles on the
    panel body: at block 128, where the whole tiles' waves of two CTAs an
    SM come out at least 90% full (the dense FW's 528 tiles at 4,096 on the
    H100's 132 SMs; a part-full last wave costs nearly a full one, so
    Example_1's 35 tiles and most band lengths take sub-tiles)."""
    if block != 128:
        return False
    slots = 2 * _sm_count(device)
    return n_tiles >= 0.9 * slots * -(-n_tiles // slots)


def relax_window_sym(q: torch.Tensor, p: torch.Tensor, d: torch.Tensor,
                     lo: int, w: int, band_tiles: int) -> None:
    """Phase 3 of a round, in place on the (w, w) window ``d[lo:lo+w, lo:lo+w]``.

    q: (w, block) relaxed pivot column panel, p: (block, w) relaxed pivot row
    panel, both separate from ``d``. Each upper block-tile (i, j) with
    ``0 <= j - i <= band_tiles`` becomes ``min(C[i, j], Q[i] (x) P[j])`` and,
    for i < j, its transpose is written into tile (j, i); tiles beyond the
    band keep their values. For the symmetric matrices of undirected graphs
    ``q == p.T`` bitwise, so the mirror equals the relaxation of the lower
    tile (``apsp_pallas._relax_full_banded_sym``). The kernel runs over the
    list of :func:`window_tiles`, in the form :func:`window_sym_whole`
    picks; on CUDA, ``d`` is 16-byte aligned with a row stride and ``lo``
    that are multiples of 4.
    """
    block = q.shape[1]
    if (tuple(q.shape) != (w, block) or tuple(p.shape) != (block, w)
            or w % block or lo < 0 or lo + w > min(d.shape)
            or band_tiles < 0):
        raise ValueError(f"bad window: q {tuple(q.shape)}, p {tuple(p.shape)}, "
                         f"d {tuple(d.shape)}, lo={lo}, w={w}, "
                         f"band_tiles={band_tiles}")
    if not _use_kernel(q, p, d):
        relax_window_sym_plain(q, p, d, lo, w, band_tiles)
        return
    if block not in (64, 128) or not q.is_contiguous() or not p.is_contiguous():
        raise ValueError("relax_window_sym kernel needs block 64 or 128 and "
                         f"contiguous panels, got block={block}")
    # the kernels load and store the window 16 bytes at a time
    if d.data_ptr() % 16 or d.stride(0) % 4 or lo % 4:
        raise ValueError("relax_window_sym kernel needs a 16-byte aligned d "
                         f"with row stride and lo % 4 == 0, got stride "
                         f"{d.stride(0)}, lo={lo} at offset "
                         f"{d.data_ptr() % 16}")
    from safepy_tpu_torch import native

    nbw = w // block
    tiles = _device_window_tiles(nbw, min(band_tiles, nbw - 1), d.device)
    whole = window_sym_whole(tiles.shape[0], block, d.device)
    native.launch("relax_window_sym", _ptr(tiles), tiles.shape[0], _ptr(q),
                  _ptr(p), _ptr(d), d.stride(0), lo, w, block, int(whole),
                  _stream(d))
    LAUNCHES["relax_window_sym"] += 1


# ---------------------------------------------------------------- close_diag

# plain version of close_diag: the jnp fori_loop is the textbook FW on the tile
close_diag_plain = _apsp_torch


def close_diag(tile: torch.Tensor, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """In-tile Floyd-Warshall closure of a (block, block) tile into a new
    tensor, or into ``out`` (contiguous, apart from ``tile``), which is
    returned; ``tile`` may be a view into the distance matrix."""
    if tile.shape[0] != tile.shape[1]:
        raise ValueError(f"close_diag needs a square tile, got {tuple(tile.shape)}")
    if out is not None:
        _check_out("close_diag", out, tile.shape, tile)
        if not out.is_contiguous():
            raise ValueError("close_diag needs a contiguous out")
    if not _use_kernel(tile):
        closed = close_diag_plain(tile)
        return closed if out is None else out.copy_(closed)
    block = tile.shape[0]
    if block not in (64, 128):
        raise ValueError(f"close_diag kernel needs block 64 or 128, got {block}")
    from safepy_tpu_torch import native

    if out is None:
        out = torch.empty((block, block), dtype=torch.float32,
                          device=tile.device)
    native.launch("close_diag", _ptr(tile), tile.stride(0), _ptr(out), block,
                  _stream(tile))
    LAUNCHES["close_diag"] += 1
    return out


# ------------------------------------------------- relax_skew_sym, relax_skew

def _skew_tiles(x: torch.Tensor, block: int) -> torch.Tensor:
    """(W, W) window -> (nt, nt, block, block) view of its tiles."""
    nt = x.shape[0] // block
    return x.view(nt, block, nt, block).permute(0, 2, 1, 3)


def _skew_relaxed(win, q, p, bt: int) -> torch.Tensor:
    """Every tile (o, j) of the window as ``min(C, Q[o] (x) P[o + j - bt])``,
    with P inf-extended by bt tiles on each side (``p_ext``,
    ``apsp_bandstore.py:468``). A new (nt, nt, block, block) tensor."""
    block = q.shape[1]
    nt = 2 * bt + 1
    inf = torch.full((block, bt * block), float("inf"), dtype=p.dtype,
                     device=p.device)
    p_ext = torch.cat([inf, p, inf], dim=1)
    # window row o reads the pivot-row slab p_ext[:, o*b : o*b + W]
    slabs = p_ext.unfold(1, nt * block, block).permute(1, 0, 2)  # (nt, b, W)
    qo = q.view(nt, block, block)
    acc = win.view(nt, block, nt * block).clone()
    for k in range(block):
        torch.minimum(acc, qo[:, :, k:k + 1] + slabs[:, k:k + 1, :], out=acc)
    return _skew_tiles(acc.view(nt * block, nt * block), block)


def _skew_grid(bt: int, device):
    o = torch.arange(2 * bt + 1, device=device)
    return o[:, None], o[None, :]


def relax_skew_sym_plain(win: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                         bt: int) -> None:
    """Plain version of :func:`relax_skew_sym`, also in place on ``win``.

    Follows the two Pallas passes tile by tile: pass A relaxes the upper
    tiles (o, j >= bt) with o + j <= 3 bt and passes the others through;
    pass B sets each lower tile (o, j < bt) with o + j >= bt to the transpose
    of its relaxed mirror (o + j - bt, 2 bt - j) and passes the others
    through."""
    block = q.shape[1]
    relaxed = _skew_relaxed(win, q, p, bt)
    tiles = _skew_tiles(win, block)
    o, j = _skew_grid(bt, win.device)
    upper = (j >= bt) & (o + j <= 3 * bt)
    lower = (j < bt) & (o + j >= bt)
    mirror = relaxed[(o + j - bt).clamp(0, 2 * bt), (2 * bt - j).expand_as(o + j)]
    out = torch.where(upper[..., None, None], relaxed, tiles)
    out = torch.where(lower[..., None, None], mirror.transpose(-1, -2), out)
    tiles.copy_(out)


def relax_skew_plain(win: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                     bt: int) -> None:
    """Plain version of :func:`relax_skew`, also in place on ``win``: tiles
    with ``|o + j - 2 bt| <= bt`` relaxed, the others passed through."""
    block = q.shape[1]
    relaxed = _skew_relaxed(win, q, p, bt)
    tiles = _skew_tiles(win, block)
    o, j = _skew_grid(bt, win.device)
    in_band = (o + j - 2 * bt).abs() <= bt
    tiles.copy_(torch.where(in_band[..., None, None], relaxed, tiles))


def skew_tiles(bt: int, symmetric: bool) -> torch.Tensor:
    """(T, 4) int32 CPU tensor of the window tiles a skew kernel relaxes,
    one CTA each: rows (o, j, mo, mj), tile (o, j) relaxed and, where
    mo >= 0, its transpose written into tile (mo, mj).

    Symmetric: the upper wedge (o, bt + jj), o + jj <= 2 bt, each with
    jj >= 1 mirrored into (o + jj, bt - jj) (the plain version's ``upper``
    and ``lower`` masks); non-symmetric: every tile with
    ``|o + j - 2 bt| <= bt``, no mirror."""
    nt = 2 * bt + 1
    if symmetric:
        rows = [(o, bt + jj, o + jj, bt - jj) if jj else (o, bt, -1, -1)
                for jj in range(bt + 1) for o in range(nt - jj)]
    else:
        rows = [(o, j, -1, -1) for o in range(nt) for j in range(nt)
                if abs(o + j - 2 * bt) <= bt]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def _device_skew_tiles(bt: int, symmetric: bool, device) -> torch.Tensor:
    """:func:`skew_tiles` on ``device``, uploaded once a (bt, form, device)
    and only read by the kernels."""
    return skew_tiles(bt, symmetric).to(device)


def _check_skew(win, q, p, bt):
    block = q.shape[1]
    w = (2 * bt + 1) * block
    if (tuple(win.shape) != (w, w) or tuple(q.shape) != (w, block)
            or tuple(p.shape) != (block, w) or bt < 0):
        raise ValueError(f"bad skewed window: win {tuple(win.shape)}, "
                         f"q {tuple(q.shape)}, p {tuple(p.shape)}, bt={bt}")
    if not _use_kernel(win, q, p):
        return False
    if block not in (64, 128) or not q.is_contiguous():
        raise ValueError("skew kernels need block 64 or 128 and a contiguous "
                         f"q, got block={block}")
    # the kernels copy and load 16 bytes at a time
    for t in (win, q, p):
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError("skew kernels need 16-byte aligned operands "
                             f"with row strides % 4 == 0, got stride "
                             f"{t.stride(0)} at offset {t.data_ptr() % 16}")
    return True


def _launch_skew(name, win, q, p, bt):
    from safepy_tpu_torch import native

    tiles = _device_skew_tiles(bt, name == "relax_skew_sym", win.device)
    native.launch(name, _ptr(tiles), tiles.shape[0], _ptr(q), _ptr(p),
                  p.stride(0), _ptr(win), win.stride(0), bt, q.shape[1],
                  _stream(win))
    LAUNCHES[name] += 1


def relax_skew_sym(win: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                   bt: int) -> None:
    """Phase 3 of a band-storage round, symmetric form, in place on the
    (W, W) skewed window ``win`` (W = (2 bt + 1) block; any row stride, on
    CUDA a multiple of 4 with every operand 16-byte aligned).

    In window tiles (o, j), C = win[o, j], Q = q[o] and P = the pivot-row
    tile o + j - bt of p. q: (W, block), the window's tiles (o, 2 bt - o)
    (the pivot column) snapshotted before the call; p: (block, W), the
    relaxed pivot row. Both are separate from ``win``: the launch rewrites
    tiles that the in-window Q tiles and the pivot row occupy. Each upper
    tile (o, bt + jj), o + jj <= 2 bt, becomes ``min(C, Q (x) P)`` and, for
    jj >= 1, its transpose goes into tile (o + jj, bt - jj); every other tile
    keeps its value (``apsp_bandstore._relax_skew_sym_pallas``). The
    kernel runs one CTA a tile of :func:`skew_tiles`, or a 64x64 sub-tile
    where the list is short.
    """
    if _check_skew(win, q, p, bt):
        _launch_skew("relax_skew_sym", win, q, p, bt)
    else:
        relax_skew_sym_plain(win, q, p, bt)


def relax_skew(win: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
               bt: int) -> None:
    """Non-symmetric phase 3 of a band-storage round, in place: every tile
    (o, j) with ``|o + j - 2 bt| <= bt`` becomes ``min(C, Q (x) P)`` (same
    operands as :func:`relax_skew_sym`); the others keep their values
    (``apsp_bandstore._relax_skew_pallas``)."""
    if _check_skew(win, q, p, bt):
        _launch_skew("relax_skew", win, q, p, bt)
    else:
        relax_skew_plain(win, q, p, bt)


# ---------------------------------------------------------------- relax_full

def relax_full_plain(q: torch.Tensor, p: torch.Tensor, d: torch.Tensor,
                     band_tiles: int | None = None) -> None:
    """Plain version of :func:`relax_full`, also in place on ``d``."""
    relaxed = min_plus_relax(d, q, p)
    if band_tiles is not None:
        block = q.shape[1]
        rows = torch.arange(d.shape[0], device=d.device) // block
        cols = torch.arange(d.shape[1], device=d.device) // block
        in_band = (rows[:, None] - cols[None, :]).abs() <= band_tiles
        relaxed = torch.where(in_band, relaxed, d)
    d.copy_(relaxed)


def full_tiles(nb_i: int, nb_j: int, band_tiles: int) -> torch.Tensor:
    """(T, 4) int32 CPU tensor of the block-tiles of an (nb_i, nb_j) tile
    grid that :func:`relax_full` relaxes with a band, one row each:
    (i, j, -1, -1) for every tile with ``|i - j| <= band_tiles``, both
    triangles, no mirror; the row convention of :func:`window_tiles`."""
    rows = [(i, j, -1, -1) for i in range(nb_i)
            for j in range(max(0, i - band_tiles), min(nb_j, i + band_tiles + 1))]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def _device_full_tiles(nb_i: int, nb_j: int, band_tiles: int,
                       device) -> torch.Tensor:
    """:func:`full_tiles` on ``device``, uploaded once a (nb_i, nb_j,
    band_tiles, device) and only read by the kernel."""
    return full_tiles(nb_i, nb_j, band_tiles).to(device)


def full_banded_whole(n_tiles: int, m: int, n: int, block: int,
                      device) -> bool:
    """Whether :func:`relax_full` relaxes ``n_tiles`` listed tiles of a
    band as whole tiles on the tile engine rather than as 64x64 sub-tiles:
    on whole 128x128 tiles (m and n multiples of the block), where their
    waves of two CTAs an SM come out at least 90% full, the rule of
    :func:`window_sym_whole` (measured on the H100: whole tiles fastest at
    518 and 1,024 listed tiles, sub-tiles at Example_1's 62)."""
    return (m % block == 0 and n % block == 0
            and window_sym_whole(n_tiles, block, device))


def relax_full(q: torch.Tensor, p: torch.Tensor, d: torch.Tensor,
               band_tiles: int | None = None) -> None:
    """``D = min(D, Q (x) P)``, in place on the (m, n) ``d`` (any row
    stride, so a window ``dist[lo:lo+w, lo:lo+w]`` works).

    q: (m, block), p: (block, n), both separate from ``d``: each CUDA block
    reads and writes only its own tile of ``d``. With ``band_tiles``, every
    block-tile (i, j) with ``|i - j| > band_tiles`` keeps its value
    (``apsp_pallas._relax_full_banded`` :161), and the kernel runs over the
    list of :func:`full_tiles`, in the form :func:`full_banded_whole`
    picks; without, every tile is relaxed (``_relax_full`` :144). On CUDA,
    m and n must be multiples of 64, block of 32 (of 64 with a band, and
    then p 16-byte aligned with a row stride that is a multiple of 4, as
    the rounds' new pivot-row panels are; so is d where whole tiles are
    taken, as the rounds' windows in a block-padded matrix are).
    """
    m, block = q.shape
    if p.shape[0] != block or tuple(d.shape) != (m, p.shape[1]):
        raise ValueError(f"shape mismatch: d {tuple(d.shape)}, "
                         f"q {tuple(q.shape)}, p {tuple(p.shape)}")
    if band_tiles is not None and band_tiles < 0:
        raise ValueError(f"band_tiles must be >= 0, got {band_tiles}")
    if (q.untyped_storage().data_ptr() == d.untyped_storage().data_ptr()
            or p.untyped_storage().data_ptr() == d.untyped_storage().data_ptr()):
        raise ValueError("relax_full needs q and p in buffers apart from d")
    if not _use_kernel(q, p, d):
        relax_full_plain(q, p, d, band_tiles)
        return
    n = p.shape[1]
    if m % 64 or n % 64 or block % (32 if band_tiles is None else 64):
        raise ValueError(f"relax_full kernel needs m, n % 64 == 0 and block "
                         f"% 32 == 0 (% 64 with a band), got m={m} n={n} "
                         f"block={block}")
    from safepy_tpu_torch import native

    if band_tiles is None:
        native.launch("relax_full", _ptr(q), q.stride(0), _ptr(p),
                      p.stride(0), _ptr(d), d.stride(0), m, n, block,
                      _stream(d))
        LAUNCHES["relax_full"] += 1
        return
    # the banded kernel copies P 16 bytes at a time
    if p.data_ptr() % 16 or p.stride(0) % 4:
        raise ValueError("relax_full banded kernel needs a 16-byte aligned p "
                         "with a row stride % 4 == 0 (fw_round's pivot-row "
                         f"panel is a new tensor), got stride {p.stride(0)} "
                         f"at offset {p.data_ptr() % 16}")
    nb_i, nb_j = -(-m // block), -(-n // block)
    tiles = _device_full_tiles(nb_i, nb_j, min(band_tiles, max(nb_i, nb_j)),
                               d.device)
    whole = full_banded_whole(tiles.shape[0], m, n, block, d.device)
    if whole:
        # the whole-tile form loads and stores D 16 bytes at a time, and
        # reads q at the constant row stride block
        if d.data_ptr() % 16 or d.stride(0) % 4:
            raise ValueError(
                "relax_full banded kernel's whole-tile form needs a 16-byte "
                "aligned d with a row stride % 4 == 0 (fw_round's windows at "
                "lo % block == 0 in a block-padded matrix are), got stride "
                f"{d.stride(0)} at offset {d.data_ptr() % 16}")
        q = q.contiguous()
    native.launch("relax_full_banded", _ptr(tiles), tiles.shape[0], _ptr(q),
                  q.stride(0), _ptr(p), p.stride(0), _ptr(d), d.stride(0), m,
                  n, block, int(whole), _stream(d))
    LAUNCHES["relax_full_banded"] += 1


# ----------------------------------------------------------- minplus_product

minplus_product_plain = _min_plus_torch  # plain version of minplus_product


def _pad_inf(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` padded with +inf to (rows, cols) (``apsp_pallas._pad_to`` :54);
    ``x`` itself when it has that shape."""
    if tuple(x.shape) == (rows, cols):
        return x
    out = torch.full((rows, cols), float("inf"), dtype=x.dtype,
                     device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def minplus_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A (x) B`` into a new (m, n) f32 tensor (``apsp_pallas.min_plus_pallas``
    :62). a: (m, k), b: (k, n), any shapes and row strides: on CUDA the
    ragged edges are padded with +inf to the kernel's multiples (128 for m
    and n, 16 for k), which changes no minimum, b is copied where the
    kernel's 16-byte loads need it, and the result is sliced back."""
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if not _use_kernel(a, b):
        return minplus_product_plain(a, b)
    n = b.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    mp, np_, kp = (-(-x // t) * t for x, t in ((m, 128), (n, 128), (k, 16)))
    ap = _pad_inf(a, mp, kp)
    bp = _pad_inf(b, kp, np_)
    if bp.data_ptr() % 16 or bp.stride(0) % 4:
        bp = bp.clone(memory_format=torch.contiguous_format)
    from safepy_tpu_torch import native

    out = torch.empty((mp, np_), dtype=torch.float32, device=a.device)
    native.launch("minplus_product", _ptr(ap), ap.stride(0), _ptr(bp),
                  bp.stride(0), _ptr(out), out.stride(0), mp, np_, kp,
                  _stream(out))
    LAUNCHES["minplus_product"] += 1
    return out if (mp, np_) == (m, n) else out[:m, :n].contiguous()


# ------------------------------------------------------------------- rounds

def fw_round(d: torch.Tensor, start: int, lo: int, w: int, block: int,
             band_tiles: int | None = None, *, symmetric: bool) -> None:
    """One blocked Floyd-Warshall round with pivot rows [start, start+block),
    in place on the window ``d[lo:lo+w, lo:lo+w]``
    (``apsp_banded.py:260-274``, ``apsp_pallas.py:288-296``).

    Q and P are the pivot column and row panels, relaxed against the closed
    diagonal into new tensors before phase 3. Phase 3 relaxes the window's
    tiles within ``band_tiles`` of the diagonal (all of them for None):
    symmetric, the upper ones mirrored into the lower
    (:func:`relax_window_sym`, for undirected graphs); classic, each tile
    against its own Q and P (:func:`relax_full`)."""
    diag = close_diag(d[start:start + block, start:start + block])
    p = d[start:start + block, lo:lo + w]
    p = relax_panel(p, diag, p)
    q = d[lo:lo + w, start:start + block]
    q = relax_panel(q, q, diag)
    if symmetric:
        relax_window_sym(q, p, d, lo, w,
                         w // block if band_tiles is None else band_tiles)
    else:
        relax_full(q, p, d[lo:lo + w, lo:lo + w], band_tiles)


def apsp_blocked_fw(dist: torch.Tensor, *, block: int = 128,
                    symmetric: bool = False) -> torch.Tensor:
    """All-pairs shortest paths by panel-blocked Floyd-Warshall
    (``apsp_pallas.apsp_blocked_fw`` :270).

    Phase 3 runs over the whole padded matrix: :func:`relax_full`, or with
    ``symmetric=True`` (the caller guarantees a symmetric ``dist``, an
    undirected graph) :func:`relax_window_sym` with the band covering every
    tile, as ``apsp_pallas.py:285`` does; bitwise equal on such inputs.
    Returns a new (N, N) f32 tensor; ``dist`` is not modified.
    """
    n = dist.shape[0]
    d = pad_distances(dist.to(torch.float32), block)
    if d.data_ptr() == dist.data_ptr():
        d = d.clone()  # the rounds update d in place
    npad = d.shape[0]
    with span("neighborhoods.relax"):
        for kb in range(npad // block):
            fw_round(d, kb * block, 0, npad, block, symmetric=symmetric)
    return d[:n, :n]
