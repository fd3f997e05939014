"""Band-STORAGE Floyd-Warshall: O(N W) memory APSP for large networks.

Port of ``safepy_tpu/ops/apsp_bandstore.py`` (FW engine, plain int8
indicator). The radius certificate of :mod:`.apsp_banded` puts every matrix
entry that a within-radius result needs within B of the diagonal in the
banded order, so the matrix is held in block-row-aligned skewed storage: with
tile size b and tile half-band bt = B // b + 1, row i (block I = i // b)
stores the column slab [(I - bt) b, (I + bt + 1) b), an (N_ghost, W) array
with W = (2 bt + 1) b, plus bt ghost block-rows of +inf on each side so the
pivot windows never branch at the edges.

Each round of :func:`apsp_band_fw` closes the pivot tile (at the static slab
offset bt b), relaxes the pivot row against it, and relaxes the (W, W)
window of block-rows [K - bt, K + bt], in which window tile (o, j) has
C = V[o, j], Q = V[o, 2 bt - o] (the pivot column) and P = the pivot-row tile
o + j - bt. The three steps are the kernels ``close_diag``, ``relax_panel``
and ``relax_skew_sym`` / ``relax_skew`` of :mod:`.apsp_cuda`, all in place on
the band: one f32 band is the only large buffer of the relaxation.

Entries are exact for every pair whose true distance is within the certified
radius and genuine-path upper bounds elsewhere, so :func:`band_threshold`
reproduces the reference's Dijkstra-cutoff neighborhoods exactly; the
banded contractions (:func:`band_matmul`, :func:`band_matmul_batch`,
:func:`band_count_batch`) and the valid-column compaction then run the
scores and the permutation null without densifying.

Not ported (ROADMAP A7): the bit-packed indicator, the sparse Bellman-Ford
relax ``apsp_band_bf`` and the euclidean band. The chunked compaction sort is
a TPU workaround and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from safepy_tpu_torch.ops.apsp_cuda import (close_diag, relax_panel,
                                            relax_skew, relax_skew_sym)
from safepy_tpu_torch.ops.score import check_fp32_matmul

_INF = float("inf")
# elements of the largest transient a banded contraction builds per group of
# block-rows (f32 slabs and products): 64 MB
_GROUP_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# Geometry of the storage
# ---------------------------------------------------------------------------

def band_params(n: int, band: int, block: int = 128):
    """(bt, nb, W): tile half-band, real block-row count, slab width (``:67``).

    bt = B // b + 1 tiles puts every element pair with separation <= B in a
    stored tile."""
    bt = band // block + 1
    nb = -(-n // block)
    w = (2 * bt + 1) * block
    return bt, nb, w


def band_nbytes(n: int, band: int, block: int = 128, itemsize: int = 4) -> int:
    """Device bytes of the skewed storage, ghost rows included (``:80``)."""
    bt, nb, w = band_params(n, band, block)
    return (nb + 2 * bt) * block * w * itemsize


def pack_band(dense, band: int, block: int = 128) -> torch.Tensor:
    """Dense (n, n) matrix in banded order -> skewed storage (``:86``), a CPU
    f32 tensor. Test helper."""
    dense = np.asarray(dense)
    n = dense.shape[0]
    bt, nb, w = band_params(n, band, block)
    s = np.full(((nb + 2 * bt) * block, w), _INF, dtype=np.float32)
    for i_blk in range(nb):
        lo = (i_blk - bt) * block
        r0, r1 = i_blk * block, min((i_blk + 1) * block, n)
        c0, c1 = max(0, -lo), min(w, n - lo)
        s[bt * block + r0:bt * block + r1, c0:c1] = dense[r0:r1, lo + c0:lo + c1]
    return torch.from_numpy(s)


def _host(s) -> np.ndarray:
    return s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)


def unpack_band(s, n: int, band: int, block: int = 128, fill=_INF):
    """Skewed storage (tensor or array) -> dense numpy (n, n), ``fill``
    outside the stored band (``:154``)."""
    s = _host(s)
    bt, nb, w = band_params(n, band, block)
    dense = np.full((n, n), fill, dtype=s.dtype)
    for i_blk in range(nb):
        lo = (i_blk - bt) * block
        c0, c1 = max(0, -lo), min(w, n - lo)
        r0, r1 = i_blk * block, min((i_blk + 1) * block, n)
        dense[r0:r1, lo + c0:lo + c1] = s[bt * block + r0:bt * block + r1, c0:c1]
    return dense


class BandedMatrix:
    """A skewed band on its device plus its frame (``:171``): the facade's
    stand-in for the dense (N, N) neighborhood and distance matrices at
    band-storage scale.

    ``data`` rows are in the permuted (banded-order) frame; ``rank`` maps
    original node i to its permuted position. ``fill`` is the implicit value
    outside the band (+inf for distances, 0 for indicators).
    """

    # dense materialization guard: ~2 GB of f32 (n ~ 22k)
    DENSE_MAX_BYTES = 2_000_000_000

    def __init__(self, data, rank, n: int, band: int, block: int = 128,
                 fill=_INF):
        self.data = data
        self.rank = np.asarray(rank)
        self.n = int(n)
        self.band = int(band)
        self.block = int(block)
        self.fill = fill

    @property
    def bt(self) -> int:
        return self.band // self.block + 1

    @property
    def shape(self):
        return (self.n, self.n)

    def dense_ok(self) -> bool:
        return 4 * self.n * self.n <= self.DENSE_MAX_BYTES

    def to_dense(self) -> np.ndarray:
        """Dense (n, n) numpy matrix in the original node frame (guarded)."""
        if not self.dense_ok():
            raise MemoryError(
                f"dense materialization of a {self.n}x{self.n} matrix "
                f"(~{4 * self.n * self.n / 1e9:.1f} GB) is disabled at "
                "band-storage scale; use to_sparse() / the banded pipeline "
                "outputs instead")
        dense = unpack_band(self.data, self.n, self.band, self.block,
                            fill=self.fill)
        return dense[self.rank][:, self.rank]

    def to_sparse(self):
        """scipy CSR of the finite (distances) or nonzero (indicator)
        entries, original frame; O(nnz) host memory."""
        from scipy.sparse import coo_matrix

        s = _host(self.data)
        bt, nb, _ = band_params(self.n, self.band, self.block)
        real = s[bt * self.block:(bt + nb) * self.block]
        gi, c = np.nonzero(np.isfinite(real) if np.isinf(self.fill)
                           else real != 0)
        keep = gi < self.n
        gi, c = gi[keep], c[keep]
        gj = (gi // self.block - bt) * self.block + c
        keep = (gj >= 0) & (gj < self.n)
        gi, gj, c = gi[keep], gj[keep], c[keep]
        vals = real[gi, c]
        order = np.argsort(self.rank)  # permuted position -> original node
        return coo_matrix((vals, (order[gi], order[gj])),
                          shape=(self.n, self.n)).tocsr()

    def to_host(self) -> "BandedMatrix":
        """The same wrapper with the band copied to a CPU tensor."""
        return BandedMatrix(self.data.cpu(), self.rank, self.n, self.band,
                            self.block, self.fill)


def band_init_from_edges(u, v, w, *, n: int, band: int,
                         block: int = 128) -> torch.Tensor:
    """Skewed-storage FW initialization from permuted edge arrays (``:247``),
    on the device of ``w``.

    u, v: node ranks in the banded order; w: edge lengths. Duplicate edges
    keep their minimum; edges whose tile separation exceeds the band are
    dropped (by the radius certificate they lie on no within-radius path)
    and scatter +inf into the ghost cell (0, 0).
    """
    bt, nb, width = band_params(n, band, block)
    dev = w.device
    s = torch.full(((nb + 2 * bt) * block, width), _INF, dtype=torch.float32,
                   device=dev)
    i = torch.arange(n, device=dev)
    s[bt * block + i, (i % block) + bt * block] = 0.0

    u = u.to(device=dev, dtype=torch.int64)
    v = v.to(device=dev, dtype=torch.int64)
    w = w.to(torch.float32)
    uu, vv, ww = torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w])
    col = vv - (uu // block - bt) * block  # skew column of (uu, vv)
    keep = (col >= 0) & (col < width)
    g = torch.where(keep, bt * block + uu, 0)
    c = torch.where(keep, col, 0)
    ww = torch.where(keep, ww, _INF)
    s.view(-1).scatter_reduce_(0, g * width + c, ww, reduce="amin")
    return s


# ---------------------------------------------------------------------------
# Band-storage blocked Floyd-Warshall
# ---------------------------------------------------------------------------

def skew_pivot_column(win: torch.Tensor, bt: int, block: int) -> torch.Tensor:
    """(W, block) copy of the window's pivot-column tiles (o, 2 bt - o): the
    Q operand of every window row, snapshotted before the skew relax
    rewrites them."""
    nt = 2 * bt + 1
    o = torch.arange(nt, device=win.device)
    return win.view(nt, block, nt, block)[o, :, 2 * bt - o, :].reshape(
        nt * block, block)


def band_fw_round(s: torch.Tensor, kb: int, *, bt: int, block: int,
                  symmetric: bool = True) -> None:
    """One round of :func:`apsp_band_fw` with pivot block-row ``kb``, in place
    (``round_body``, ``apsp_bandstore.py:459``)."""
    width = s.shape[1]
    kg = kb + bt
    row = s[kg * block:(kg + 1) * block]
    c0 = bt * block
    diag = close_diag(row[:, c0:c0 + block])
    row[:, c0:c0 + block] = diag
    p = relax_panel(row, diag, row)  # the relaxed pivot row, kept apart
    row.copy_(p)
    win = s[(kg - bt) * block:(kg - bt) * block + width]
    q = skew_pivot_column(win, bt, block)
    (relax_skew_sym if symmetric else relax_skew)(win, q, p, bt)


def apsp_band_fw(s: torch.Tensor, *, bt: int, block: int = 128,
                 symmetric: bool = True) -> torch.Tensor:
    """Blocked Floyd-Warshall over skewed band storage (``:431``), IN PLACE on
    ``s``, which is returned.

    ``s``: ((nb + 2 bt) b, (2 bt + 1) b) f32 from :func:`band_init_from_edges`
    or :func:`pack_band`. In-band entries come out exact for every pair
    within the certified radius. ``symmetric`` (the default, for the
    symmetric matrices of undirected graphs) relaxes the window's upper
    wedge and mirrors the lower half (``relax_skew_sym``); ``False`` relaxes
    every in-band tile (``relax_skew``). Three kernel launches a round, nb
    rounds; the host loop stands for the JAX ``fori_loop``.
    """
    if s.dtype != torch.float32 or s.shape[1] != (2 * bt + 1) * block:
        raise ValueError(f"not a band of bt={bt}, block={block}: "
                         f"{tuple(s.shape)} {s.dtype}")
    if not s.is_contiguous():
        raise ValueError("apsp_band_fw needs a contiguous band")
    nb = s.shape[0] // block - 2 * bt
    for kb in range(nb):
        band_fw_round(s, kb, bt=bt, block=block, symmetric=symmetric)
    return s


# ---------------------------------------------------------------------------
# Downstream consumers: threshold, sizes, contractions, without densifying
# ---------------------------------------------------------------------------

def band_threshold(s: torch.Tensor, radius) -> torch.Tensor:
    """``<= radius`` int8 0/1 indicator in the same skewed frame (``:736``,
    unpacked form)."""
    r = torch.as_tensor(radius, dtype=s.dtype, device=s.device)
    return (s <= r).to(torch.int8)


def band_row_sizes(s_ind: torch.Tensor) -> torch.Tensor:
    """f32 per-row sums of an int8 indicator band (``:773``)."""
    return s_ind.sum(dim=1, dtype=torch.float32)


def band_row_stats(s_ind: torch.Tensor, *, n: int, bt: int, block: int = 128):
    """(sizes, mean, std) of the neighborhood sizes (``:784``). Only the n
    real rows count; sizes are in the permuted frame; the std is the
    population one (``jnp.std``)."""
    real = s_ind[bt * block:s_ind.shape[0] - bt * block]
    sizes = band_row_sizes(real)[:n]
    return sizes, sizes.mean(), sizes.std(correction=0)


def _block_range(s_rows, bt: int, block: int, blocks, row_block_offset: int):
    """(lo, hi): the real block-rows a banded contraction computes.

    ``s_rows`` holds ghosted block-rows ``row_block_offset`` onwards (0: the
    whole ghosted band); ``blocks`` is the (lo, hi) range of real block-rows
    to compute, all of them (``s_rows``' own) when None. A row shard of the
    band passes its offset and its real range
    (``parallel.band_sharded``)."""
    if blocks is None:
        return 0, s_rows.shape[0] // block - 2 * bt
    lo, hi = blocks
    if hi > lo and (lo + bt < row_block_offset or (
            hi + bt - row_block_offset) * block > s_rows.shape[0]):
        raise ValueError(f"real block-rows {blocks} are not all in rows "
                         f"held from ghosted block-row {row_block_offset}")
    return lo, hi


def _groups(lo: int, hi: int, per_block_elems: int):
    """Ranges of block-rows lo .. hi - 1 whose transient stays under
    ``_GROUP_ELEMS``."""
    g = max(1, _GROUP_ELEMS // max(1, per_block_elems))
    return [(i0, min(hi, i0 + g)) for i0 in range(lo, hi, g)]


def _block_rows(s_rows, i0: int, i1: int, bt: int, block: int,
                row_block_offset: int = 0):
    """(i1 - i0, block, width) f32 rows of real block-rows i0 .. i1 - 1."""
    width = s_rows.shape[1]
    r0 = i0 + bt - row_block_offset
    return s_rows[r0 * block:(r0 + i1 - i0) * block].view(
        i1 - i0, block, width).to(torch.float32)


def band_matmul(s_ind, x, *, bt: int, block: int = 128,
                precision: str = "highest", blocks=None,
                row_block_offset: int = 0) -> torch.Tensor:
    """(banded indicator) @ x without densifying (``:801``).

    s_ind: ((nb + 2 bt) b, W); x: (npad, A) in the same permuted row frame.
    Block-row I's slab covers rows [(I - bt) b, (I + bt + 1) b) of x, so the
    product is nb (b, W) x (W, A) matmuls, run as batched matmuls over
    groups of block-rows. Returns (npad, A) f32. A row shard passes
    ``blocks`` and ``row_block_offset`` (:func:`_block_range`) and gets the
    ((hi - lo) b, A) rows of its real block-rows
    (``band_sharded._band_matmul_local`` :187).
    """
    check_fp32_matmul(precision)
    width = s_ind.shape[1]
    lo, hi = _block_range(s_ind, bt, block, blocks, row_block_offset)
    a_dim = x.shape[1]
    xg = F.pad(x.to(torch.float32), (0, 0, bt * block, bt * block))
    slabs = xg.unfold(0, width, block)  # (nb, A, W): slab i at row i * b
    out = torch.empty(((hi - lo) * block, a_dim), dtype=torch.float32,
                      device=x.device)
    for i0, i1 in _groups(lo, hi, block * width):
        prod = torch.bmm(
            _block_rows(s_ind, i0, i1, bt, block, row_block_offset),
            slabs[i0:i1].transpose(1, 2))
        out[(i0 - lo) * block:(i1 - lo) * block] = prod.reshape(-1, a_dim)
    return out


def _batch_windows(x_batch, w_c: int):
    """Every w_c-row window of x_batch in the value-major (v_pad, C A)
    layout: a (v_pad - w_c + 1, C A, w_c) view. Window ``starts[i]`` is the
    slab of block-row i."""
    c_dim, v_pad, a_dim = x_batch.shape
    xt = x_batch.permute(1, 0, 2).reshape(v_pad, c_dim * a_dim)
    return xt.unfold(0, w_c, 1)


def band_matmul_batch(s_rows, x_batch, starts, *, bt: int, block: int = 128,
                      precision: str = "highest", blocks=None,
                      row_block_offset: int = 0) -> torch.Tensor:
    """Batched banded product against per-block-row slabs at given offsets
    (``:835``).

    s_rows: ((nb + 2 bt) b, w_c) banded indicator, column-compacted
    (:func:`compact_band_columns`); x_batch: (C, v_pad, A) value rows;
    starts: (nb,) slab start rows. Returns (C, npad, A); for a row shard
    (``blocks``, ``row_block_offset``: :func:`_block_range`) the
    (C, (hi - lo) b, A) rows of its real block-rows.
    """
    check_fp32_matmul(precision)
    w_c = s_rows.shape[1]
    lo, hi = _block_range(s_rows, bt, block, blocks, row_block_offset)
    c_dim, _, a_dim = x_batch.shape
    starts = torch.as_tensor(starts, dtype=torch.int64, device=x_batch.device)
    windows = _batch_windows(x_batch, w_c)
    out = torch.empty((c_dim, (hi - lo) * block, a_dim), dtype=torch.float32,
                      device=x_batch.device)
    for i0, i1 in _groups(lo, hi, max(w_c, block) * c_dim * a_dim):
        prod = torch.bmm(
            _block_rows(s_rows, i0, i1, bt, block, row_block_offset),
            windows[starts[i0:i1]].transpose(1, 2))
        out[:, (i0 - lo) * block:(i1 - lo) * block] = prod.view(
            -1, c_dim, a_dim).transpose(0, 1)
    return out


def band_count_batch(s_rows, x_batch, starts, obs, live=None, *, bt: int,
                     block: int = 128, precision: str = "highest",
                     blocks=None, row_block_offset: int = 0):
    """Two-sided tie-inclusive counts of one permutation chunk against the
    banded (compacted) indicator (``:870``): :func:`band_matmul_batch` fused
    with the comparisons, so the (C, npad, A) chunk-score array never
    exists; the transient is a group of block-rows.

    obs: (npad, A) observed scores (permuted frame); live: (C,) bool chunk
    liveness, or None for all live. Returns int32 (npad, A) counts_neg,
    counts_pos of this chunk. A row shard (``blocks``, ``row_block_offset``:
    :func:`_block_range`) passes and gets the ((hi - lo) b, A) rows of its
    real block-rows.
    """
    check_fp32_matmul(precision)
    w_c = s_rows.shape[1]
    lo, hi = _block_range(s_rows, bt, block, blocks, row_block_offset)
    c_dim, _, a_dim = x_batch.shape
    starts = torch.as_tensor(starts, dtype=torch.int64, device=x_batch.device)
    cn = torch.empty(((hi - lo) * block, a_dim), dtype=torch.int32,
                     device=x_batch.device)
    cp = torch.empty_like(cn)
    lv = None if live is None else live.view(1, 1, c_dim, 1)
    windows = _batch_windows(x_batch, w_c)
    for i0, i1 in _groups(lo, hi, max(w_c, block) * c_dim * a_dim):
        prod = torch.bmm(
            _block_rows(s_rows, i0, i1, bt, block, row_block_offset),
            windows[starts[i0:i1]].transpose(1, 2))
        prod = prod.view(i1 - i0, block, c_dim, a_dim)
        r0, r1 = (i0 - lo) * block, (i1 - lo) * block
        ob = obs[r0:r1].view(i1 - i0, block, 1, a_dim)
        le, ge = prod <= ob, prod >= ob
        if lv is not None:
            le, ge = le & lv, ge & lv
        cn[r0:r1] = le.sum(dim=2, dtype=torch.int32).view(-1, a_dim)
        cp[r0:r1] = ge.sum(dim=2, dtype=torch.int32).view(-1, a_dim)
    return cn, cp


# ---------------------------------------------------------------------------
# Valid-column compaction
# ---------------------------------------------------------------------------

def compaction_plan(valid, *, n: int, bt: int, block: int = 128):
    """Host half of the valid-column compaction (``:922``): (starts (nb,)
    int64, w_c), the rank of each slab's first valid column and the
    block-padded largest valid count of any slab."""
    valid = np.asarray(valid).astype(bool)
    nb = -(-n // block)
    width = (2 * bt + 1) * block

    cum = np.concatenate([[0], np.cumsum(valid)])
    lo = (np.arange(nb) - bt) * block
    hi = np.clip(lo + width, 0, n)
    lo_c = np.clip(lo, 0, n)
    starts = cum[lo_c]
    counts = cum[hi] - cum[lo_c]
    w_c = int(-(-max(1, counts.max()) // block) * block)
    w_c = min(w_c, width)
    return np.asarray(starts, np.int64), w_c


def apply_compaction(s_ind, valid, w_c: int, *, bt: int, block: int = 128,
                     row_block_offset: int = 0) -> torch.Tensor:
    """Device half of the compaction (``:968``): each slab's columns stably
    sorted valid-first, invalid entries zeroed, the first ``w_c`` kept.

    ``valid``: (n,) bool in the permuted order. The 128 rows of a block-row
    share one slab and so one validity key: one stable argsort of the
    (nbg, W) keys and one gather give JAX's per-row stable sort exactly.
    ``s_ind`` holds ghosted block-rows ``row_block_offset`` onwards (a row
    shard, ``band_sharded.py:483``). Returns (nbg b, w_c) int8.
    """
    rows, width = s_ind.shape
    nbg = rows // block
    dev = s_ind.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    n = valid.shape[0]
    # absolute column of slab cell (Ig, c) is (Ig - 2 bt) b + c
    cols = ((torch.arange(nbg, device=dev)[:, None] + row_block_offset
             - 2 * bt) * block + torch.arange(width, device=dev)[None, :])
    ok = valid[cols.clamp(0, n - 1)] & (cols >= 0) & (cols < n)
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)[:, :w_c]
    kept = torch.gather(ok, 1, order).to(torch.int8)
    comp = torch.gather(s_ind.to(torch.int8).view(nbg, block, width), 2,
                        order[:, None, :].expand(nbg, block, w_c))
    return (comp * kept[:, None, :]).view(nbg * block, w_c)


def compact_band_columns(s_ind, valid, *, bt: int, block: int = 128):
    """Restrict the banded indicator to valid columns, keeping bandedness
    (``:1053``). Returns (compact ((nb + 2 bt) b, w_c) int8, starts (nb,)
    int64 tensor, w_c)."""
    n = np.asarray(valid).shape[0]
    starts, w_c = compaction_plan(valid, n=n, bt=bt, block=block)
    return (apply_compaction(s_ind, valid, w_c, bt=bt, block=block),
            torch.as_tensor(starts, device=s_ind.device), w_c)
