"""Band-STORAGE Floyd-Warshall: O(N W) memory APSP for large networks.

Port of ``safepy_tpu/ops/apsp_bandstore.py``. The radius certificate of
:mod:`.apsp_banded` puts every matrix entry that a within-radius result
needs within B of the diagonal in the banded order, so the matrix is held in
block-row-aligned skewed storage: with tile size b and tile half-band
bt = B // b + 1, row i (block I = i // b) stores the column slab
[(I - bt) b, (I + bt + 1) b), an (N_ghost, W) array with W = (2 bt + 1) b,
plus bt ghost block-rows of +inf on each side so the pivot windows never
branch at the edges.

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

Besides the FW: the sparse Bellman-Ford relax :func:`apsp_band_bf` (with
its host slots :func:`band_bf_slots` and budget :func:`bf_max_iters`); the
euclidean metric's band straight from the coordinates
(:func:`euclidean_band_distances`, :func:`euclidean_band_indicator`); and
the bit-packed indicator (uint8, 8 cells a byte, LSB-first), which every
consumer recognizes by its dtype and unpacks one group of block-rows at a
time. The chunked compaction sort of JAX is a TPU workaround; the port's
compaction runs in groups of block-rows for its transient's sake.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from safepy_tpu_torch.ops.apsp_cuda import (LAUNCHES, close_diag,
                                            relax_panel, relax_skew,
                                            relax_skew_sym)
from safepy_tpu_torch.ops.score import check_fp32_matmul
from safepy_tpu_torch.profiling import span

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


# ---------------------------------------------------------------------------
# Bit-packed indicator storage (``:102-151``)
#
# A 0/1 indicator band may store 8 columns a byte: uint8, LSB-first (bit j of
# byte c is column 8 c + j, numpy's bitorder='little'). The dtype is the
# flag: uint8 means packed bits, int8 plain 0/1, and every banded consumer
# branches on it. Consumers unpack one group of block-rows at a time.
# ---------------------------------------------------------------------------

def is_packed_bits(x: torch.Tensor) -> bool:
    """True when ``x`` is a bit-packed indicator band (``:115``)."""
    return x.dtype == torch.uint8


def _bit_weights(device) -> torch.Tensor:
    return torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=device)


def unpack_bits_tile(packed: torch.Tensor) -> torch.Tensor:
    """(..., w8) uint8 -> (..., 8 w8) bool, LSB-first (``:120``)."""
    bits = (packed.unsqueeze(-1) & _bit_weights(packed.device)) != 0
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def pack_bits_tile(ind: torch.Tensor) -> torch.Tensor:
    """(..., w) 0/1 values -> (..., w // 8) uint8, LSB-first, w divisible by
    8 (``:127``)."""
    bits = (ind.reshape(*ind.shape[:-1], ind.shape[-1] // 8, 8) != 0)
    return (bits.to(torch.uint8) * _bit_weights(ind.device)).sum(
        dim=-1, dtype=torch.uint8)


def pack_band_bits(s_ind: torch.Tensor) -> torch.Tensor:
    """Whole-band pack (``:135``); the producers pack group by group."""
    return pack_bits_tile(s_ind)


def unpack_band_bits(packed: torch.Tensor) -> torch.Tensor:
    """Whole-band unpack to int8 (``:142``), for small bands and tests."""
    return unpack_bits_tile(packed).to(torch.int8)


def unpack_band_bits_host(packed) -> np.ndarray:
    """NumPy unpack, LSB-first (``:148``): the host side of a packed
    download."""
    return np.unpackbits(_host(packed), axis=1, bitorder="little")


def band_width(s: torch.Tensor) -> int:
    """Slab width W of a band, packed or not."""
    return s.shape[1] * (8 if is_packed_bits(s) else 1)


def unpack_band(s, n: int, band: int, block: int = 128, fill=_INF):
    """Skewed storage (tensor or array, possibly bit-packed) -> dense numpy
    (n, n), ``fill`` outside the stored band (``:154``)."""
    s = _host(s)
    if s.dtype == np.uint8:
        s = unpack_band_bits_host(s)
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
        entries, original frame; O(nnz) host memory besides the band's
        download (a packed band is unpacked on the host, as in JAX)."""
        from scipy.sparse import coo_matrix

        s = _host(self.data)
        if s.dtype == np.uint8:
            s = unpack_band_bits_host(s)
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

def skew_pivot_column(win: torch.Tensor, bt: int, block: int, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(W, block) copy of the window's pivot-column tiles (o, 2 bt - o): the
    Q operand of every window row, snapshotted before the skew relax
    rewrites them. Into a new tensor, or into the contiguous ``out``.

    Tile (o, 2 bt - o) starts o (block ld - block) elements after tile
    (0, 2 bt), ld being the window's row stride, so the tiles are one
    strided view of the window and the snapshot is one copy: no index is
    built and nothing is allocated with ``out``."""
    nt = 2 * bt + 1
    ld = win.stride(0)
    if win.stride(1) != 1:
        raise ValueError("skew_pivot_column needs unit column stride")
    tiles = win.as_strided((nt, block, block), (block * ld - block, ld, 1),
                           win.storage_offset() + 2 * bt * block)
    if out is None:
        out = torch.empty((nt * block, block), dtype=win.dtype,
                          device=win.device)
    out.view(nt, block, block).copy_(tiles)
    return out


class _FwWork:
    """The buffers one band FW reuses in every round: the closed pivot tile
    (block, block), the relaxed pivot row (block, W) and the pivot-column
    snapshot (W, block), on the band's device."""

    __slots__ = ("diag", "p", "q")

    def __init__(self, s: torch.Tensor, block: int):
        width = s.shape[1]
        new = functools.partial(torch.empty, dtype=torch.float32,
                                device=s.device)
        self.diag = new((block, block))
        self.p = new((block, width))
        self.q = new((width, block))


def band_fw_round(s: torch.Tensor, kb: int, *, bt: int, block: int,
                  symmetric: bool = True, work: _FwWork | None = None) -> None:
    """One round of :func:`apsp_band_fw` with pivot block-row ``kb``, in place
    (``round_body``, ``apsp_bandstore.py:459``); ``work`` holds its
    operands (fresh buffers without), so that a round allocates nothing."""
    if work is None:
        work = _FwWork(s, block)
    width = s.shape[1]
    kg = kb + bt
    row = s[kg * block:(kg + 1) * block]
    c0 = bt * block
    diag = close_diag(row[:, c0:c0 + block], out=work.diag)
    row[:, c0:c0 + block].copy_(diag)
    p = relax_panel(row, diag, row, out=work.p)  # the relaxed pivot row, apart
    row.copy_(p)
    win = s[(kg - bt) * block:(kg - bt) * block + width]
    q = skew_pivot_column(win, bt, block, out=work.q)
    (relax_skew_sym if symmetric else relax_skew)(win, q, p, bt)


def _band_fw_rounds(s, nb, *, bt, block, symmetric, work) -> None:
    for kb in range(nb):
        band_fw_round(s, kb, bt=bt, block=block, symmetric=symmetric,
                      work=work)


# How apsp_band_fw's calls ran, since the process started: "eager" (the
# round loop on the host), "captures" (the rounds captured into a CUDA graph,
# then replayed once), "replays" (a graph captured before, replayed).
FW_GRAPHS = {"eager": 0, "captures": 0, "replays": 0}
# (device, data_ptr, shape, bt, block, symmetric) -> None (the band seen
# once) or its _FwGraph; the newest FW_GRAPH_CACHE entries
FW_GRAPH_CACHE = 2
_fw_graphs: OrderedDict = OrderedDict()


class _FwGraph:
    """The nb rounds of one band, captured: the CUDA graph, the workspace
    its kernels read and write, and the launches it replays."""

    __slots__ = ("graph", "work", "launches")

    def __init__(self, s, nb, *, bt, block, symmetric):
        self.work = _FwWork(s, block)
        stream = torch.cuda.current_stream(s.device)
        side = torch.cuda.Stream(s.device)  # a graph is never captured on
        side.wait_stream(stream)            # the legacy default stream
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                _band_fw_rounds(s, nb, bt=bt, block=block,
                                symmetric=symmetric, work=self.work)
            finally:
                self.graph.capture_end()
        stream.wait_stream(side)
        # a capture launches nothing: its counts are the replay's
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k, v in self.launches.items():
            LAUNCHES[k] -= v

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v


def _band_fw_run(s, nb, *, bt, block, symmetric) -> str:
    """The rounds on ``s``, eagerly the first time a band is seen at its
    address, then from a graph captured the second time and replayed
    after (a session's analyses rebuild their band where the last one
    was). A CPU band, or a call inside another capture, runs eagerly.
    Returns how the rounds ran: "eager", "capture" or "replay"."""
    key = None
    if s.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        key = (s.device, s.data_ptr(), tuple(s.shape), bt, block, symmetric)
    if key is None or key not in _fw_graphs:
        if key is not None:
            _fw_graphs[key] = None
            while len(_fw_graphs) > FW_GRAPH_CACHE:
                _fw_graphs.popitem(last=False)
        _band_fw_rounds(s, nb, bt=bt, block=block, symmetric=symmetric,
                        work=_FwWork(s, block))
        FW_GRAPHS["eager"] += 1
        return "eager"
    _fw_graphs.move_to_end(key)
    entry = _fw_graphs[key]
    mode = "replay"
    if entry is None:
        entry = _fw_graphs[key] = _FwGraph(s, nb, bt=bt, block=block,
                                           symmetric=symmetric)
        mode = "capture"
    entry.replay()
    FW_GRAPHS["captures" if mode == "capture" else "replays"] += 1
    return mode


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
    rounds; the host loop stands for the JAX ``fori_loop``. On the card a
    band met again at the same address runs the rounds as one CUDA graph
    (:func:`_band_fw_run`, counted in :data:`FW_GRAPHS`), bitwise the same.
    """
    if s.dtype != torch.float32 or s.shape[1] != (2 * bt + 1) * block:
        raise ValueError(f"not a band of bt={bt}, block={block}: "
                         f"{tuple(s.shape)} {s.dtype}")
    if not s.is_contiguous():
        raise ValueError("apsp_band_fw needs a contiguous band")
    nb = s.shape[0] // block - 2 * bt
    with span("neighborhoods.relax") as rec:
        mode = _band_fw_run(s, nb, bt=bt, block=block, symmetric=symmetric)
        if rec is not None:
            rec.attrs["graph"] = mode
    return s


# ---------------------------------------------------------------------------
# Sparse Bellman-Ford band relaxation (the low-hop alternative to FW)
# ---------------------------------------------------------------------------

def band_bf_slots(u, v, w, *, n: int, band: int, block: int = 128):
    """Host-side neighbor slots of each permuted row for
    :func:`apsp_band_bf` (``:481``, copied).

    u, v: node ranks in the banded order; w: edge lengths, one entry per
    undirected edge (both directions are made here). Out-of-band edges are
    dropped as in :func:`band_init_from_edges`. Returns ``(nbr, dlt, wgt,
    S)``: ``nbr[i, s]`` the s-th neighbor of permuted row i (0-padded),
    ``dlt[i, s] = i // block - nbr // block`` (int8), ``wgt[i, s]`` the edge
    length (+inf padding), ``S`` the largest directed degree; None when the
    offset would overflow int8 (a band of ~16k elements and more).
    """
    bt, nb, width = band_params(n, band, block)
    if bt + 1 > 127:
        return None
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    w = np.asarray(w, np.float32)
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    ww = np.concatenate([w, w])
    col = vv - (uu // block - bt) * block
    keep = (col >= 0) & (col < width)
    uu, vv, ww = uu[keep], vv[keep], ww[keep]

    order = np.argsort(uu, kind="stable")
    uu, vv, ww = uu[order], vv[order], ww[order]
    idx = np.arange(len(uu), dtype=np.int64)
    first = np.r_[True, uu[1:] != uu[:-1]] if len(uu) else np.zeros(0, bool)
    group_start = np.maximum.accumulate(np.where(first, idx, 0))
    slot = idx - group_start
    S = int(slot.max()) + 1 if len(slot) else 1

    npad = nb * block
    nbr = np.zeros((npad, S), np.int32)
    dlt = np.zeros((npad, S), np.int8)
    wgt = np.full((npad, S), np.inf, np.float32)
    nbr[uu, slot] = vv.astype(np.int32)
    dlt[uu, slot] = (uu // block - vv // block).astype(np.int8)
    wgt[uu, slot] = ww
    return nbr, dlt, wgt, S


def apsp_band_bf(s: torch.Tensor, nbr, dlt, wgt, clamp, *, bt: int,
                 block: int = 128, max_iters: int = 512, group: int = 4,
                 stripe: int = 1024):
    """Sparse Bellman-Ford relaxation over the skewed band (``:526``), IN
    PLACE on ``s``.

    Each round relaxes every row against its neighbors' rows,
    ``D[i, :] = min(D[i, :], w(i, m) + D[m, :])``: a within-radius shortest
    path has few edges, so few rounds reach the FW fixpoint. Neighbor m's
    entries for row i's slab are one contiguous run of the flat band, at
    ``(bt b + m) W + dlt b``; they are gathered from a window view of the
    flat band (one start per row, ``group`` slots at a time), and lanes
    outside m's slab are masked to +inf, which is exact. Entries above
    ``clamp`` (the inclusive radius) go to +inf each round.

    A round runs in column stripes of ``stripe`` lanes, the last start
    clamped to W - stripe, each written back before the next is gathered
    (Gauss-Seidel), in JAX's order, so the band, the rounds and the flag are
    JAX's bit for bit. One host sync a round reads the flag.

    Returns ``(s, converged, iters)``. ``converged`` False (``max_iters``
    reached) means the band holds upper bounds: the caller finishes with
    :func:`apsp_band_fw`, which is exact from any such state.
    """
    dev = s.device
    width = s.shape[1]
    npad = s.shape[0] - 2 * bt * block
    P = min(stripe, width)
    nstripes = -(-width // P)
    clamp = torch.as_tensor(clamp, dtype=s.dtype, device=dev)
    nbr = torch.as_tensor(nbr, device=dev).to(torch.int64)
    shift = torch.as_tensor(dlt, device=dev).to(torch.int64) * block
    wgt = torch.as_tensor(wgt, device=dev).to(s.dtype)
    S = nbr.shape[1]
    base = (bt * block + nbr) * width + shift            # (npad, S) int64
    lane_lo = (-shift).clamp_min(0)[:, :, None]
    lane_hi = (width - shift).clamp_max(width)[:, :, None]
    lane = torch.arange(P, device=dev)
    windows = s.view(-1).unfold(0, P, 1)  # windows[j] = flat[j:j + P]
    real = s[bt * block:bt * block + npad]

    iters, changed = 0, True
    while changed and iters < max_iters:
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        for sp in range(nstripes):
            c0 = min(sp * P, width - P)
            cur = real[:, c0:c0 + P]
            acc = cur.clone()
            lanes = lane + c0
            for k0 in range(0, S, group):
                k1 = min(S, k0 + group)
                g = windows[base[:, k0:k1] + c0]        # (npad, k, P)
                g.masked_fill_((lanes < lane_lo[:, k0:k1])
                               | (lanes >= lane_hi[:, k0:k1]), _INF)
                g.add_(wgt[:, k0:k1, None])
                torch.minimum(acc, g.amin(dim=1), out=acc)
            acc.masked_fill_(acc > clamp, _INF)
            flag |= (acc < cur).any()
            cur.copy_(acc)
        changed = bool(flag)
        iters += 1
    return s, not changed, iters


def bf_max_iters(n: int, band: int, S: int, block: int = 128,
                 floor: int = 16, cap: int = 512) -> int:
    """Round budget at which BF has spent about one FW's time (``:622``,
    copied with its v5e rates: 0.76 T min-plus/s for FW, 0.8 TB/s for BF's
    gathers). It only decides when BF gives way to FW; the results do not
    depend on it."""
    bt, nb, width = band_params(n, band, block)
    fw_s = 0.75 * (2 * bt + 1) ** 2 * nb * 2 * block ** 3 / 0.76e12
    iter_s = 3 * S * nb * block * width * 4 / 0.8e12
    return int(np.clip(fw_s / max(iter_s, 1e-12), floor, cap))


# ---------------------------------------------------------------------------
# The euclidean metric's band, straight from the coordinates
# ---------------------------------------------------------------------------

def _euclid_ghosted(coords_perm, *, n: int, band: int, block: int):
    """(ghosted coordinates, bt, nb, W): the permuted coordinates at rows
    bt b .. bt b + n of a zero array, so that block-row i's slab is rows
    i b .. i b + W (``_euclid_block_setup`` ``:668``)."""
    bt, nb, width = band_params(n, band, block)
    coords_perm = torch.as_tensor(coords_perm).to(torch.float32)
    cg = torch.zeros(((nb + 2 * bt) * block, 2), dtype=torch.float32,
                     device=coords_perm.device)
    cg[bt * block:bt * block + n] = coords_perm
    return cg, bt, nb, width


def _euclid_distances(cg, i0: int, i1: int, *, n: int, bt: int, block: int,
                      width: int) -> torch.Tensor:
    """(i1 - i0, block, W) f32 distances of real block-rows i0 .. i1 - 1 to
    their slabs (``blk_d`` ``:680``).

    JAX's arithmetic: ``diff = rows - slab``, ``sqrt(max(sum(diff * diff),
    0))`` in f32. XLA's CPU backend computes that sum of two squares as one
    fused multiply-add, fma(dy, dy, dx dx), so it is taken so here: the f64
    product dy dy is exact and the sum of two nonnegative terms is rounded
    to f32 once. The square root is taken in f64 and rounded to f32, which
    is the correctly rounded f32 root on every device (torch's vectorized
    CPU f32 ``sqrt`` is not). Pad rows and columns are +inf explicitly, and
    the real diagonal exactly 0.
    """
    g = i1 - i0
    dev = cg.device
    rows = cg[(i0 + bt) * block:(i1 + bt) * block].view(g, block, 1, 2)
    slab = cg.unfold(0, width, block)[i0:i1]            # (g, 2, W)
    dx = rows[..., 0] - slab[:, None, 0, :]
    dy = rows[..., 1] - slab[:, None, 1, :]
    ssq = (dy.double() * dy.double() + (dx * dx).double()).float()
    d = torch.sqrt(ssq.clamp_min_(0.0).double()).float()
    row_g = torch.arange(i0 * block, i1 * block, device=dev).view(g, block, 1)
    col_g = (((torch.arange(i0, i1, device=dev) - bt) * block).view(g, 1, 1)
             + torch.arange(width, device=dev))
    d.masked_fill_((row_g >= n) | (col_g < 0) | (col_g >= n), _INF)
    d.diagonal(offset=bt * block, dim1=1, dim2=2).copy_(
        torch.where(row_g[..., 0] < n, 0.0, _INF))
    return d


def euclidean_band_distances(coords_perm, *, n: int, band: int,
                             block: int = 128) -> torch.Tensor:
    """Banded pairwise euclidean distances in the skewed frame (``:643``),
    on the device of ``coords_perm`` ((n, 2), banded order), a group of
    block-rows at a time. Pairs beyond the band are +inf: the band
    certificate puts them beyond the radius."""
    cg, bt, nb, width = _euclid_ghosted(coords_perm, n=n, band=band,
                                        block=block)
    out = torch.full(((nb + 2 * bt) * block, width), _INF,
                     dtype=torch.float32, device=cg.device)
    for i0, i1 in _groups(0, nb, block * width):
        out[(i0 + bt) * block:(i1 + bt) * block] = _euclid_distances(
            cg, i0, i1, n=n, bt=bt, block=block, width=width).view(-1, width)
    return out


def euclidean_band_indicator(coords_perm, radius, *, n: int, band: int,
                             block: int = 128,
                             packed: bool = False) -> torch.Tensor:
    """The strict ``dist < radius`` indicator band built directly
    (``:702``): int8, or bit-packed uint8 with ``packed``, packed group by
    group as it is built; the f32 band never exists. Bitwise
    ``euclidean_band_distances(...) < radius``."""
    cg, bt, nb, width = _euclid_ghosted(coords_perm, n=n, band=band,
                                        block=block)
    r = torch.as_tensor(radius, dtype=torch.float32, device=cg.device)
    out = torch.zeros(((nb + 2 * bt) * block, width // 8 if packed else width),
                      dtype=torch.uint8 if packed else torch.int8,
                      device=cg.device)
    for i0, i1 in _groups(0, nb, block * width):
        ind = _euclid_distances(cg, i0, i1, n=n, bt=bt, block=block,
                                width=width).view(-1, width) < r
        out[(i0 + bt) * block:(i1 + bt) * block] = (
            pack_bits_tile(ind) if packed else ind)
    return out


# ---------------------------------------------------------------------------
# Downstream consumers: threshold, sizes, contractions, without densifying
# ---------------------------------------------------------------------------

def band_threshold(s: torch.Tensor, radius, *, packed: bool = False,
                   chunk_blocks: int = 256, block: int = 128) -> torch.Tensor:
    """``<= radius`` 0/1 indicator in the same skewed frame (``:736``): int8,
    or with ``packed`` bit-packed uint8 made in row chunks of
    ``chunk_blocks`` block-rows, so that the transient is chunk-sized."""
    r = torch.as_tensor(radius, dtype=s.dtype, device=s.device)
    if not packed:
        return (s <= r).to(torch.int8)
    out = torch.empty((s.shape[0], s.shape[1] // 8), dtype=torch.uint8,
                      device=s.device)
    step = chunk_blocks * block
    for r0 in range(0, s.shape[0], step):
        out[r0:r0 + step] = pack_bits_tile(s[r0:r0 + step] <= r)
    return out


def band_row_sizes(s_ind: torch.Tensor) -> torch.Tensor:
    """f32 per-row sums of an int8 or bit-packed indicator band (``:773``),
    in groups of rows, a packed group's bytes counted through a popcount
    table. The sums are integers below 2^24, so exact in any order."""
    packed = is_packed_bits(s_ind)
    out = torch.empty(s_ind.shape[0], dtype=torch.float32,
                      device=s_ind.device)
    if packed:
        popcount = torch.tensor([bin(b).count("1") for b in range(256)],
                                dtype=torch.uint8, device=s_ind.device)
    step = max(1, _GROUP_ELEMS // max(1, s_ind.shape[1]))
    for r0 in range(0, s_ind.shape[0], step):
        x = s_ind[r0:r0 + step]
        if packed:
            x = popcount[x.to(torch.int64)]
        out[r0:r0 + step] = x.sum(dim=1, dtype=torch.float32)
    return out


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
    """(i1 - i0, block, W) f32 rows of real block-rows i0 .. i1 - 1, a
    packed band's unpacked here (``:821-825``)."""
    r0 = i0 + bt - row_block_offset
    rows = s_rows[r0 * block:(r0 + i1 - i0) * block].view(
        i1 - i0, block, s_rows.shape[1])
    if is_packed_bits(s_rows):
        rows = unpack_bits_tile(rows)
    return rows.to(torch.float32)


def band_matmul(s_ind, x, *, bt: int, block: int = 128,
                precision: str = "highest", blocks=None,
                row_block_offset: int = 0,
                x_from_block: int | None = None) -> torch.Tensor:
    """(banded indicator) @ x without densifying (``:801``).

    s_ind: ((nb + 2 bt) b, W) int8, or bit-packed; x: (npad, A) in the same
    permuted row frame.
    Block-row I's slab covers rows [(I - bt) b, (I + bt + 1) b) of x, so the
    product is nb (b, W) x (W, A) matmuls, run as batched matmuls over
    groups of block-rows. Returns (npad, A) f32. A row shard passes
    ``blocks`` and ``row_block_offset`` (:func:`_block_range`) and gets the
    ((hi - lo) b, A) rows of its real block-rows
    (``band_sharded._band_matmul_local`` :187). With ``x_from_block`` = lo,
    x is only the shard's window of the operand: the ((hi - lo + 2 bt) b,
    A) rows [(lo - bt) b, (hi + bt) b), zero outside [0, npad)
    (``band_sharded.operand_window``), which the slabs of real block-rows
    lo .. hi - 1 read.
    """
    check_fp32_matmul(precision)
    width = band_width(s_ind)
    lo, hi = _block_range(s_ind, bt, block, blocks, row_block_offset)
    a_dim = x.shape[1]
    out = torch.empty(((hi - lo) * block, a_dim), dtype=torch.float32,
                      device=x.device)
    if hi <= lo:
        return out  # a shard without real block-rows
    if x_from_block is None:
        xg, first = F.pad(x.to(torch.float32),
                          (0, 0, bt * block, bt * block)), 0
    else:
        xg, first = x.to(torch.float32), x_from_block
    slabs = xg.unfold(0, width, block)  # slab i - first at row (i - first) b
    for i0, i1 in _groups(lo, hi, block * width):
        prod = torch.bmm(
            _block_rows(s_ind, i0, i1, bt, block, row_block_offset),
            slabs[i0 - first:i1 - first].transpose(1, 2))
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
    (:func:`compact_band_columns`), int8 or bit-packed; x_batch:
    (C, v_pad, A) value rows; starts: (nb,) slab start rows. Returns
    (C, npad, A); for a row shard (``blocks``, ``row_block_offset``:
    :func:`_block_range`) the (C, (hi - lo) b, A) rows of its real
    block-rows.
    """
    check_fp32_matmul(precision)
    w_c = band_width(s_rows)
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
    w_c = band_width(s_rows)
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
    sorted valid-first, invalid entries zeroed, the first ``w_c`` kept;
    packed in, packed out.

    ``valid``: (n,) bool in the permuted order. The rows of a block-row
    share one slab and so one validity key: one stable argsort of the
    block-row's keys and one gather give JAX's per-row stable sort exactly.
    It runs a group of block-rows at a time (a packed group is unpacked,
    compacted and packed again), so that the transient stays group-sized.
    ``s_ind`` holds ghosted block-rows ``row_block_offset`` onwards (a row
    shard, ``band_sharded.py:483``). Returns (nbg b, w_c) int8, or
    (nbg b, w_c / 8) uint8 for a packed band.
    """
    packed = is_packed_bits(s_ind)
    width = band_width(s_ind)
    nbg = s_ind.shape[0] // block
    dev = s_ind.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    n = valid.shape[0]
    out = torch.empty((nbg * block, w_c // 8 if packed else w_c),
                      dtype=torch.uint8 if packed else torch.int8, device=dev)
    lanes = torch.arange(width, device=dev)
    for g0, g1 in _groups(0, nbg, block * width):
        # absolute column of slab cell (Ig, c) is (Ig - 2 bt) b + c
        cols = ((torch.arange(g0, g1, device=dev)[:, None] + row_block_offset
                 - 2 * bt) * block + lanes)
        ok = valid[cols.clamp(0, n - 1)] & (cols >= 0) & (cols < n)
        order = torch.argsort((~ok).to(torch.uint8), dim=1,
                              stable=True)[:, :w_c]
        kept = torch.gather(ok, 1, order).to(torch.int8)
        rows = s_ind[g0 * block:g1 * block].view(g1 - g0, block,
                                                 s_ind.shape[1])
        if packed:
            rows = unpack_bits_tile(rows)
        comp = torch.gather(rows.to(torch.int8), 2,
                            order[:, None, :].expand(g1 - g0, block, w_c))
        comp = (comp * kept[:, None, :]).view(-1, w_c)
        out[g0 * block:g1 * block] = pack_bits_tile(comp) if packed else comp
    return out


def compact_band_columns(s_ind, valid, *, bt: int, block: int = 128):
    """Restrict the banded indicator to valid columns, keeping bandedness
    (``:1053``). Returns (compact ((nb + 2 bt) b, w_c) int8, or its packed
    form for a packed band, starts (nb,) int64 tensor, w_c)."""
    n = np.asarray(valid).shape[0]
    starts, w_c = compaction_plan(valid, n=n, bt=bt, block=block)
    return (apply_compaction(s_ind, valid, w_c, bt=bt, block=block),
            torch.as_tensor(starts, device=s_ind.device), w_c)
