"""Row-sharded band-STORAGE Floyd-Warshall + banded enrichment over a mesh.

Port of ``safepy_tpu/parallel/band_sharded.py``: the FW engine and every
pipeline over it. The JAX package runs one program over
the mesh (``shard_map``); here every rank of the mesh's ``data`` axis runs
these functions on its own device (SPMD over ``torch.distributed``), and the
ghosted skewed band of ``ops.apsp_bandstore`` is split into equal row slabs
of ``local_rows`` block-rows, rank r holding ghosted block-rows
[r local_rows, (r + 1) local_rows).

Per pivot round kb (:func:`_band_fw_rounds`, ``band_sharded.py:91``):

  1. the rank owning ghosted block-row Kg = kb + bt copies its (b, W) pivot
     slab, the others fill +inf, and one ``all_reduce(MIN)`` over the axis
     gives every rank the slab: the only collective of the round, made by
     every rank every round;
  2. every rank closes the diagonal tile (``close_diag``) and relaxes the
     slab against it (``relax_panel``); the owner writes it back;
  3. each rank with rows in the pivot window [Kg - bt, Kg + bt] relaxes each
     of them, ``min(C, Q (x) P)`` with Q the row's own pivot-column tile and
     P a W-wide slice of the inf-extended pivot row, all in one launch
     (``relax_band_rows``, the B3 kernel). Per-rank work is
     O((N / ndev) W^2).

The downstream contractions run on each rank's real block-rows (the
row-shard forms of ``ops.apsp_bandstore``'s ``band_matmul``,
``band_matmul_batch``, ``band_count_batch`` and ``apply_compaction``, and
of ``ops.enrich_band``'s ``band_score`` and ``scan_counts_band``:
``_band_matmul_local`` :187, ``_band_matmul_batch_local`` :220,
``_band_score_local`` :253 and ``_scan_counts_local`` :278; the ghost
padding of ``_ghost_pad_cols`` :413 is ``band_matmul``'s own). The
quantitative null reads replicated (n, A) values; every rank draws the same
permutations (the same generator seed, or the same ``perm_idx``), so no
collective is needed until the outputs are assembled. The band GO engines
read only the rank's window of the (n, A) operands, its real block-rows
and ``bt`` ghost block-rows on each side (:func:`operand_window`), built
on its device by :func:`band_hyper_operands_sharded` with the totals
reduced over the ranks.

The binary engines run the census the same way: the class table
(:func:`hypergeom_band_table_sharded`, ``:701``) one K-sorted column chunk
at a time (each rank's census, the same table built on every rank, the
rank's lookup), and the f64 tail loop
(:func:`fused_hypergeom_pipeline_band_sharded`, ``:515``) over each rank's
real rows. The euclidean pipeline
(:func:`fused_permutation_pipeline_band_euclid_sharded`, ``:787``) builds
each rank's slab straight from the coordinates (``_euclid_band_local``
:362, ``_euclid_band_ind_local`` :381) and has no FW. ``packed=True``
stores each rank's indicator slab bit-packed (LSB-first, as
``ops.apsp_bandstore.pack_bits_tile``): a slab is a whole number of
block-rows and the packing runs along each row, so the shards hold the
rows of the single-device packed band.

Outputs: the JAX functions return global arrays whose rows stay sharded
over the devices (``:742-784``). Here every band and every (n, A) matrix
is assembled in host memory (pinned where the ranks' devices are cards),
one rank's segment at a time (:func:`_assemble_host`: each piece of a
segment is broadcast from its rank's device into one staging buffer of a
piece on the others', then copied out), so a rank's card holds its own
slabs and one piece, never the global arrays: adding ranks lowers each
rank's peak as it does in JAX. The (n, A) matrices go straight into their
rows of the original node frame. Vectors (row sizes, counts, totals) are
assembled or reduced on the device. The copies are exact for any dtype.
``all_reduce`` and ``broadcast`` are the only collectives, so the gloo
backend works on CUDA tensors too (two ranks on one card).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from safepy_tpu_torch.hbm import SHARD_STAGE_BYTES
from safepy_tpu_torch.ops import apsp_bandstore as bst
from safepy_tpu_torch.ops.apsp_cuda import (close_diag, relax_band_rows,
                                            relax_panel)
from safepy_tpu_torch.parallel.mesh import mesh_axis
from safepy_tpu_torch.pipeline import _band_null

_INF = float("inf")


def sharded_band_geometry(n: int, band: int, ndev: int, block: int = 128):
    """(bt, nb, width, g_pad, local_rows) (``:45``): the ghosted block-row
    count padded to a multiple of the rank count (the extra bottom rows are
    +inf ghosts); bt, nb and width are ``ops.apsp_bandstore.band_params``'s,
    so the shard frames stay aligned with the unsharded engine's."""
    bt, nb, width = bst.band_params(n, band, block)
    g_pad = -(-(nb + 2 * bt) // ndev) * ndev
    return bt, nb, width, g_pad, g_pad // ndev


def real_blocks(my: int, *, nb: int, bt: int, local_rows: int):
    """(lo, hi): the real block-rows among rank ``my``'s ghosted ones
    (empty, lo == hi, for a rank that holds only ghost or pad rows)."""
    lo = min(max(my * local_rows - bt, 0), nb)
    hi = min(max((my + 1) * local_rows - bt, lo), nb)
    return lo, hi


def _shard_rows(my, geom):
    """Rank ``my``'s real block-rows and the first ghosted block-row of its
    slab, as the row-shard forms of the banded products take them."""
    bt, nb, _, _, local_rows = geom
    return dict(blocks=real_blocks(my, nb=nb, bt=bt, local_rows=local_rows),
                row_block_offset=my * local_rows)


def band_init_local(u, v, w, my: int, *, n: int, bt: int, local_rows: int,
                    width: int, block: int = 128) -> torch.Tensor:
    """Rank ``my``'s (local_rows b, W) slab of the skewed FW initialization
    (``:58``), on the device of ``w``.

    u, v: permuted edge endpoints, w: edge lengths (replicated, O(E)). Only
    the diagonal entries and edges whose source row the rank holds are
    placed; the rest scatter +inf into the scrap cell (0, 0). Ghost and pad
    rows stay +inf. Rank by rank, the slabs are the rows of
    ``ops.apsp_bandstore.band_init_from_edges``."""
    dev = w.device
    lrows = local_rows * block
    row0 = my * lrows  # first ghosted element row this rank holds
    s = torch.full((lrows, width), _INF, dtype=torch.float32, device=dev)

    i = torch.arange(n, device=dev)
    r = bt * block + i - row0
    keep = (r >= 0) & (r < lrows)
    s[r[keep], (i[keep] % block) + bt * block] = 0.0

    u = u.to(device=dev, dtype=torch.int64)
    v = v.to(device=dev, dtype=torch.int64)
    w = w.to(torch.float32)
    uu, vv, ww = torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w])
    col = vv - (uu // block - bt) * block  # skew column of (uu, vv)
    r = bt * block + uu - row0
    keep = (col >= 0) & (col < width) & (r >= 0) & (r < lrows)
    flat = torch.where(keep, r * width + col, 0)
    s.view(-1).scatter_reduce_(0, flat, torch.where(keep, ww, _INF),
                               reduce="amin")
    return s


def _band_fw_rounds(slab: torch.Tensor, my: int, group, *, nb: int, bt: int,
                    local_rows: int, block: int) -> torch.Tensor:
    """The pivot loop over rank ``my``'s slab, in place (``:91``).

    Every rank runs every round and makes its one ``all_reduce``; a rank
    with no row in the pivot window skips only the window relax (the JAX
    ``lax.cond``). The rank's window rows are relaxed in place by one
    ``relax_band_rows`` call, which reads every row's Q tile before it
    rewrites any; the pivot row is relaxed again against its closed
    diagonal, as in the JAX rounds."""
    width = slab.shape[1]
    lrows = local_rows * block
    c0 = bt * block
    # the relaxed pivot row inf-extended by bt tiles on each side (p_ext,
    # :126); window row o reads its W columns from column o b
    p_ext = torch.full((block, width + 2 * c0), _INF, dtype=slab.dtype,
                       device=slab.device)
    for kb in range(nb):
        kg = kb + bt
        owner = kg // local_rows
        start = kg * block - owner * lrows
        if my == owner:
            p = slab[start:start + block].clone()
        else:
            p = torch.full((block, width), _INF, dtype=slab.dtype,
                           device=slab.device)
        dist.all_reduce(p, op=dist.ReduceOp.MIN, group=group)

        diag = close_diag(p[:, c0:c0 + block])
        p[:, c0:c0 + block] = diag
        p = relax_panel(p, diag, p)
        if my == owner:
            slab[start:start + block] = p

        # window rows o_lo .. o_hi - 1 are this rank's, contiguous in its slab
        o_lo = max(my * local_rows - (kg - bt), 0)
        o_hi = min((my + 1) * local_rows - (kg - bt), 2 * bt + 1)
        if o_lo >= o_hi:
            continue  # no row of the window is this rank's
        p_ext[:, c0:c0 + width] = p
        li = (kg - bt + o_lo) * block - my * lrows
        relax_band_rows(slab[li:li + (o_hi - o_lo) * block], p_ext, o_lo,
                        o_hi)
    return slab


def _share_rows(x: torch.Tensor, segments, group) -> None:
    """Fill the rows of ``x`` that other ranks computed: rank r broadcasts
    rows ``segments[r]`` (which it holds) to every rank. In place."""
    ranks = dist.get_process_group_ranks(group)
    for r, (r0, r1) in enumerate(segments):
        if r1 > r0:
            dist.broadcast(x[r0:r1], src=ranks[r], group=group)


def _assemble(local: torch.Tensor, rows: int, segments, my: int, group):
    """The (rows,) global vector whose ``segments[r]`` entries are rank r's
    ``local`` entries, on every rank's device (``local`` itself on one
    rank). Bands and (n, A) matrices go to the host instead
    (:func:`_assemble_host`)."""
    if len(segments) == 1:
        return local
    out = torch.zeros((rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    r0, r1 = segments[my]
    out[r0:r1] = local
    _share_rows(out, segments, group)
    return out


def _host_empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialized host tensor for an assembled output, pinned where
    the ranks' device is a card (each piece's copy is then a DMA)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _assemble_host(local: torch.Tensor, out: torch.Tensor, segments,
                   my: int, group, *, to_rows=None, cols=slice(None)):
    """Fill the host tensor ``out`` with every rank's rows of a frame, rank
    r's ``local`` holding frame rows ``segments[r]``.

    A segment crosses in pieces of at most ``hbm.SHARD_STAGE_BYTES`` (the
    plan's ``stage_buffer``): its rank broadcasts each piece from its
    device, the others receive it into one staging buffer of a piece on
    theirs (on the CPU, straight into ``out`` where the piece's rows are
    contiguous there), and every rank copies it into ``out``. With ``to_rows`` (host int64, one entry for each of the
    frame's first rows) frame row p lands in ``out[to_rows[p]]`` and the
    rows past ``len(to_rows)`` (pad rows) are dropped; else it lands in
    ``out[p]``. ``cols``: the columns of ``out`` written."""
    local = local.contiguous()
    ranks = (dist.get_process_group_ranks(group) if len(segments) > 1
             else None)
    dev = local.device
    row_shape = tuple(local.shape[1:])
    step = max(1, SHARD_STAGE_BYTES // max(1, local.element_size()
                                           * math.prod(row_shape)))
    direct = dev.type == "cpu" and to_rows is None and cols == slice(None)
    view = out[:, cols]
    stage = None
    for r, (r0, r1) in enumerate(segments):
        for a in range(r0, r1, step):
            b = min(r1, a + step)
            landed = False
            if r == my:
                piece = local[a - r0:b - r0]
            elif direct:
                piece, landed = out[a:b], True
            else:
                if stage is None:
                    longest = max(s1 - s0 for s0, s1 in segments)
                    stage = torch.empty((min(step, longest),) + row_shape,
                                        dtype=local.dtype, device=dev)
                piece = stage[:b - a]
            if ranks is not None:
                dist.broadcast(piece, src=ranks[r], group=group)
            if to_rows is None:
                if not landed:
                    view[a:b].copy_(piece)
                continue
            q = min(b, to_rows.shape[0])
            if q > a:
                view.index_copy_(0, to_rows[a:q], piece[:q - a].cpu())


def _node_rows(rank) -> torch.Tensor:
    """Host int64 ``order``: permuted-frame row p is node ``order[p]``
    (``rank`` maps node i to its permuted row)."""
    return torch.argsort(torch.as_tensor(rank).cpu())


def apsp_band_fw_sharded(s_ghosted: torch.Tensor, *, mesh, axis: str = "data",
                         n: int, band: int,
                         block: int = 128) -> torch.Tensor:
    """Band-storage FW with the ghosted skewed band row-sharded over the
    mesh's ``axis`` (``:154``).

    ``s_ghosted``: the (g_pad b, W) global frame of
    :func:`sharded_band_geometry` (the extra bottom ghost rows +inf), the
    same on every rank. Each rank relaxes its own rows in place, then every
    rank's rows are shared, so the relaxed global frame is returned (it is
    ``s_ghosted``) on every rank.
    """
    group, ndev, my = mesh_axis(mesh, axis)
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    if (tuple(s_ghosted.shape) != (g_pad * block, width)
            or s_ghosted.dtype != torch.float32
            or not s_ghosted.is_contiguous()):
        raise ValueError(f"s_ghosted must be a contiguous f32 "
                         f"{(g_pad * block, width)} band, got "
                         f"{tuple(s_ghosted.shape)} {s_ghosted.dtype}")
    lrows = local_rows * block
    _band_fw_rounds(s_ghosted[my * lrows:(my + 1) * lrows], my, group, nb=nb,
                    bt=bt, local_rows=local_rows, block=block)
    if ndev > 1:
        _share_rows(s_ghosted, [(r * lrows, (r + 1) * lrows)
                                for r in range(ndev)], group)
    return s_ghosted


def _sharded_front(u, v, w, radius, *, mesh, axis, n, band, block,
                   packed, keep_distances):
    """Init -> FW -> indicator (bit-packed with ``packed``) on this rank's
    slab. Returns (slab, ind, my, group, ndev, geometry of
    :func:`sharded_band_geometry`): with ``keep_distances`` the slab's
    entries beyond the radius +inf (JAX's ``where(slab <= radius, slab,
    inf)``), else None, the f32 slab freed once thresholded."""
    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    bt, nb, width, g_pad, local_rows = geom
    slab = band_init_local(u, v, w, my, n=n, bt=bt, local_rows=local_rows,
                           width=width, block=block)
    _band_fw_rounds(slab, my, group, nb=nb, bt=bt, local_rows=local_rows,
                    block=block)
    ind = bst.band_threshold(slab, radius, packed=packed, block=block)
    if not keep_distances:
        return None, ind, my, group, ndev, geom
    r = torch.as_tensor(radius, dtype=slab.dtype, device=slab.device)
    slab.masked_fill_(slab > r, _INF)
    return slab, ind, my, group, ndev, geom


def _band_segments(ndev: int, rows_per_rank: int):
    return [(r * rows_per_rank, (r + 1) * rows_per_rank) for r in range(ndev)]


def _real_segments(ndev: int, *, nb: int, bt: int, local_rows: int,
                   block: int):
    """Each rank's rows of the (npad, ...) real-row frame."""
    return [tuple(b * block for b in real_blocks(r, nb=nb, bt=bt,
                                                 local_rows=local_rows))
            for r in range(ndev)]


def operand_window(my: int, geom, block: int = 128):
    """(p0, p1): the rows of the permuted-frame (n, A) operands that rank
    ``my``'s banded products read, its real block-rows lo .. hi - 1 and
    ``bt`` ghost block-rows on each side: [(lo - bt) b, (hi + bt) b), rows
    outside [0, n) zero (``ops.apsp_bandstore.band_matmul``'s
    ``x_from_block``)."""
    bt, nb, _, _, local_rows = geom
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    return (lo - bt) * block, (hi + bt) * block


def _take_window(x, p0: int, p1: int, device, dtype=None) -> torch.Tensor:
    """Rows p0 .. p1 - 1 of the (n, ...) array or tensor ``x`` on
    ``device``, zero outside [0, n)."""
    x = torch.as_tensor(x)
    q0, q1 = max(p0, 0), min(p1, x.shape[0])
    out = torch.zeros((p1 - p0,) + tuple(x.shape[1:]),
                      dtype=x.dtype if dtype is None else dtype,
                      device=device)
    if q1 > q0:
        out[q0 - p0:q1 - p0] = x[q0:q1]
    return out


def _real_rows(my, geom, n: int, block: int):
    """(w0, w1, count): rank ``my``'s real rows below n in its operand
    window's coordinates, and how many; the first ``count`` rows of its
    outputs are those rows."""
    bt, nb, _, _, local_rows = geom
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    count = max(0, min(hi * block, n) - lo * block)
    return bt * block, bt * block + count, count


def band_hyper_operands_sharded(n2a_np, order, *, mesh, axis: str = "data",
                                n: int, band: int, block: int = 128,
                                chunk_cols: int = 512, device):
    """Rank ``my``'s band GO operands (``:322-365``, row-sharded as JAX
    keeps them): (nan0 int8, nodes_not_nan f32) over its window of the
    permuted frame (:func:`operand_window`), K f32 (A,) and M, and
    binary_ok, built on ``device`` from column chunks of the host matrix
    ``n2a_np`` (the window's rows of each chunk uploaded f32, as
    ``ops.enrich_band.band_hyper_operands_chunked`` uploads all of them),
    so no rank holds the (n, A) operands. K, M and the count of finite
    non-0/1 values sum each rank's real rows and are reduced with one
    integer ``all_reduce(SUM)``: the window's int8 and row validity equal
    the single-device build's rows, K and M its values wherever they are
    read (integer totals of binary columns), binary_ok its flag."""
    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    p0, p1 = operand_window(my, geom, block)
    q0, q1 = max(p0, 0), min(p1, n)
    w0, w1, _ = _real_rows(my, geom, n, block)
    idx = np.asarray(order)[q0:q1]
    a = n2a_np.shape[1]
    nan0_w = torch.zeros((p1 - p0, a), dtype=torch.int8, device=device)
    seen = torch.zeros(p1 - p0, dtype=torch.bool, device=device)
    k_parts, other = [], 0
    rows = slice(q0 - p0, q1 - p0)
    for j in range(0, a, chunk_cols):
        with np.errstate(over="ignore"):  # as the host count casts
            x = torch.as_tensor(
                np.asarray(n2a_np[idx, j:j + chunk_cols], np.float32),
                device=device)
        finite = torch.isfinite(x)
        other += int(not bool(((x == 0.0) | (x == 1.0) | ~finite).all()))
        nan0 = torch.where(finite, x, 0.0)
        seen[rows] |= finite.any(dim=1)
        del finite, x
        k_parts.append(nan0[w0 - rows.start:w1 - rows.start].sum(dim=0))
        nan0_w[rows, j:j + nan0.shape[1]] = nan0  # the int8 cast on the copy
        del nan0
    totals = torch.cat([
        (torch.cat(k_parts) if k_parts
         else torch.zeros(0, device=device)).to(torch.int64),
        seen[w0:w1].sum(dtype=torch.int64).view(1),
        torch.tensor([other], dtype=torch.int64, device=device)])
    dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=group)
    tail = totals[a:].tolist()
    return (nan0_w, seen.to(torch.float32), totals[:a].to(torch.float32),
            tail[1] == 0, int(tail[0]))


def _assemble_bands(ind, slab, my, group, ndev, geom, block):
    """(ind_g, dist_g or None): every rank's slabs assembled into the
    global ghost-padded frame (g_pad b rows) in host memory."""
    _, _, _, g_pad, local_rows = geom
    segs = _band_segments(ndev, local_rows * block)
    out = []
    for x in (ind, slab):
        if x is None:
            out.append(None)
            continue
        g = _host_empty((g_pad * block,) + tuple(x.shape[1:]), x.dtype,
                        x.device)
        _assemble_host(x, g, segs, my, group)
        out.append(g)
    return out[0], out[1]


def _band_stats(ind, my, group, ndev, geom, *, n: int, block: int):
    """(sizes_g, mean, std) from the ranks' own slabs: each slab's per-row
    sizes (exact integers), assembled on the device into the global
    ghosted frame, and the mean and population std of the n real rows',
    the floats ``ops.apsp_bandstore.band_row_stats`` gives on the
    assembled band."""
    bt, _, _, g_pad, local_rows = geom
    sizes_g = _assemble(bst.band_row_sizes(ind), g_pad * block,
                        _band_segments(ndev, local_rows * block), my, group)
    sizes = sizes_g[bt * block:bt * block + n].clone()
    return sizes_g, sizes.mean(), sizes.std(correction=0)


def _to_node_frame(local, order, n_cols, my, group, ndev, geom, block,
                   out=None, cols=slice(None)):
    """Every rank's real rows of an (n, w) block (permuted frame, the
    rank's ``local``) into the host (n, ``n_cols``) tensor ``out`` (made
    when None) at columns ``cols``, in the original node frame: permuted
    row p lands in row ``order[p]``. Returns ``out``."""
    bt, nb, _, _, local_rows = geom
    if out is None:
        out = _host_empty((order.shape[0], n_cols), local.dtype,
                          local.device)
    _assemble_host(local, out,
                   _real_segments(ndev, nb=nb, bt=bt, local_rows=local_rows,
                                  block=block),
                   my, group, to_rows=order, cols=cols)
    return out


def _column_counts(nbin, my, geom, n: int, block: int, group):
    """Enriched counts int32 (w,) of an indicator block over every rank's
    real rows: the rank's rows below n summed, one ``all_reduce(SUM)``."""
    counts = nbin[:_real_rows(my, geom, n, block)[2]].sum(dim=0,
                                                          dtype=torch.int32)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    return counts


def band_neighborhoods_sharded(u, v, w, radius, *, mesh, axis: str = "data",
                               n: int, band: int, block: int = 128,
                               packed: bool = False,
                               keep_distances: bool = True):
    """Row-sharded band FW front half (``:589``): (dist_g, ind_g, sizes_g,
    mean, std), the bands in the global ghost-padded permuted frame
    (g_pad b rows) in host memory, distances beyond the radius +inf; the
    row sizes (g_pad b,) and the stats on the device. ``packed``: the
    indicator bit-packed; ``keep_distances=False`` frees each rank's f32
    slab once thresholded and returns None for dist_g."""
    slab, ind, my, group, ndev, geom = _sharded_front(
        u, v, w, radius, mesh=mesh, axis=axis, n=n, band=band, block=block,
        packed=packed, keep_distances=keep_distances)
    ind_g, dist_g = _assemble_bands(ind, slab, my, group, ndev, geom, block)
    sizes_g, mean, std = _band_stats(ind, my, group, ndev, geom, n=n,
                                     block=block)
    return dist_g, ind_g, sizes_g, mean, std


def band_matmul_sharded(ind_g, x, *, mesh, axis: str = "data", n: int,
                        band: int, block: int = 128,
                        precision: str = "highest") -> torch.Tensor:
    """(row-sharded banded indicator) @ x for an (n, A) operand
    (``:633``): the ghosted (g_pad b, A) global product in host memory,
    each rank contracting its own real block-rows of the global band
    ``ind_g`` (int8 or bit-packed; its slab goes to the device of ``x``)
    against its window of ``x``; ghost and pad rows are 0."""
    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    bt, nb, _, g_pad, local_rows = geom
    lrows = local_rows * block
    dev = x.device if isinstance(x, torch.Tensor) else ind_g.device
    ind = ind_g[my * lrows:(my + 1) * lrows].to(dev)
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    xw = _take_window(x, *operand_window(my, geom, block), dev,
                      torch.float32)
    prod = bst.band_matmul(ind, xw, bt=bt, block=block, precision=precision,
                           blocks=(lo, hi), row_block_offset=my * local_rows,
                           x_from_block=lo)
    out = torch.zeros((g_pad * block, xw.shape[1]), dtype=torch.float32,
                      pin_memory=dev.type == "cuda")
    _assemble_host(prod, out[bt * block:(bt + nb) * block],
                   _real_segments(ndev, nb=nb, bt=bt, local_rows=local_rows,
                                  block=block), my, group)
    return out


def _sharded_null(slab, ind, vals, vals_valid, valid, starts, rank,
                  generator, my, group, ndev, geom, *, n, block, score_type,
                  num_permutations, batch_size, w_c, precision, perm_idx):
    """Scores and permutation counts of this rank's real rows, then every
    output assembled in host memory: (dist_g or None, ind_g, obs,
    counts_neg, counts_pos, mean, std), as the quantitative pipelines
    return them, the (n, A) matrices in the node frame. ``slab``: the
    masked distance slab to assemble, or None."""
    bt = geom[0]
    obs, counts_neg, counts_pos = _band_null(
        ind, vals, vals_valid, valid, starts, rank, generator, bt=bt,
        block=block, score_type=score_type,
        num_permutations=num_permutations, batch_size=batch_size, w_c=w_c,
        precision=precision, perm_idx=perm_idx, **_shard_rows(my, geom))
    order = _node_rows(rank)
    obs, counts_neg, counts_pos = (
        _to_node_frame(x, order, x.shape[1], my, group, ndev, geom, block)
        for x in (obs, counts_neg, counts_pos))
    ind_g, dist_g = _assemble_bands(ind, slab, my, group, ndev, geom, block)
    _, mean, std = _band_stats(ind, my, group, ndev, geom, n=n, block=block)
    return dist_g, ind_g, obs, counts_neg, counts_pos, mean, std


def fused_permutation_pipeline_band_sharded(
        u, v, w, vals, vals_valid, valid, starts, rank, generator, radius, *,
        mesh, axis: str = "data", n: int, band: int, block: int = 128,
        score_type: str = "sum", num_permutations: int = 1000,
        batch_size: int = 1000, w_c: int, precision: str = "highest",
        keep_distances: bool = True, perm_idx=None, packed: bool = False):
    """Row-sharded band pipeline (``:419``): init, FW, threshold, scores,
    null, every band-shaped array split over the ranks of ``axis``.

    Inputs and frames as the one-device band front and null
    (``pipeline.band_neighborhoods`` of u/v/w and ``radius``, then
    ``pipeline._band_perm_tail`` of the rest), replicated on every rank:
    ``generator`` must be seeded alike on every rank (or ``perm_idx``
    given), so that every rank draws the same permutations. Returns (dist_g or None, ind_g, obs, counts_neg,
    counts_pos, mean, std) on every rank, in host memory but the stats:
    the bands in the global ghost-padded permuted frame (g_pad b rows), the
    (n, A) matrices in the original node frame. ``keep_distances=False``
    frees each rank's f32 slab after thresholding and returns None for the
    distances; ``packed`` stores the indicator bit-packed (``:477``).
    """
    slab, ind, my, group, ndev, geom = _sharded_front(
        u, v, w, radius, mesh=mesh, axis=axis, n=n, band=band, block=block,
        packed=packed, keep_distances=keep_distances)
    return _sharded_null(
        slab, ind, vals, vals_valid, valid, starts, rank, generator, my,
        group, ndev, geom, n=n, block=block, score_type=score_type,
        num_permutations=num_permutations, batch_size=batch_size, w_c=w_c,
        precision=precision, perm_idx=perm_idx)


def _euclid_local(coords_perm, radius, my, *, n: int, band: int, geom,
                  block: int, keep_distances: bool, packed: bool):
    """(slab or None, ind): rank ``my``'s rows of the euclidean band,
    built straight from the coordinates (``_euclid_band_local`` :362,
    ``_euclid_band_ind_local`` :381) a group of its real block-rows at a
    time with the single-device blocks' arithmetic
    (``ops.apsp_bandstore._euclid_distances``); ghost and pad rows are
    +inf (0 in the indicator). With ``keep_distances`` the f32 slab is
    built, its entries from the radius on set to +inf, and the indicator is
    strict ``dist < radius``; without, the indicator (bit-packed with
    ``packed``) is built directly and no f32 slab exists."""
    bt, nb, width, _, local_rows = geom
    cg, *_ = bst._euclid_ghosted(coords_perm, n=n, band=band, block=block)
    dev = cg.device
    lrows = local_rows * block
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    if keep_distances:
        out = torch.full((lrows, width), _INF, dtype=torch.float32,
                         device=dev)
    else:
        out = torch.zeros((lrows, width // 8 if packed else width),
                          dtype=torch.uint8 if packed else torch.int8,
                          device=dev)
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    off = bt - my * local_rows  # real block-row i is local block-row i + off
    for i0, i1 in bst._groups(lo, hi, block * width):
        d = bst._euclid_distances(cg, i0, i1, n=n, bt=bt, block=block,
                                  width=width).view(-1, width)
        rows = slice((i0 + off) * block, (i1 + off) * block)
        if keep_distances:
            out[rows] = d
        else:
            out[rows] = bst.pack_bits_tile(d < r) if packed else d < r
    if not keep_distances:
        return None, out
    beyond = out >= r
    ind = (~beyond).to(torch.int8)
    out.masked_fill_(beyond, _INF)
    return out, ind


def fused_permutation_pipeline_band_euclid_sharded(
        coords_perm, vals, vals_valid, valid, starts, rank, generator,
        radius, *, mesh, axis: str = "data", n: int, band: int,
        block: int = 128, score_type: str = "sum",
        num_permutations: int = 1000, batch_size: int = 1000, w_c: int,
        precision: str = "highest", keep_distances: bool = True,
        packed: bool = False, perm_idx=None):
    """Row-sharded euclidean band pipeline (``:787``): each rank's rows of
    the banded coordinate distances (strict ``dist < r``, reference
    safe.py:389-399), then the sharded permutation null; no graph
    algorithm, so no FW.

    Inputs as :func:`fused_permutation_pipeline_band_sharded`'s with the
    (n, 2) coordinates in the banded order (those of
    ``pipeline.euclidean_band_neighborhoods``) in place of the edges,
    replicated on every rank; outputs as
    :func:`fused_permutation_pipeline_band_sharded`. ``packed`` needs
    ``keep_distances=False``."""
    if keep_distances and packed:
        raise ValueError("a bit-packed indicator needs keep_distances=False")
    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    slab, ind = _euclid_local(coords_perm, radius, my, n=n, band=band,
                              geom=geom, block=block,
                              keep_distances=keep_distances, packed=packed)
    return _sharded_null(
        slab, ind, vals, vals_valid, valid, starts, rank, generator, my,
        group, ndev, geom, n=n, block=block, score_type=score_type,
        num_permutations=num_permutations, batch_size=batch_size, w_c=w_c,
        precision=precision, perm_idx=perm_idx)


# ---------------------------------------------------------------------------
# Band GO (binary annotations): the class table and the f64 tail loop
# ---------------------------------------------------------------------------

def hypergeom_band_table_sharded(ind_g, nan0, nodes_not_nan, M,
                                 enrichment_threshold, *, mesh,
                                 axis: str = "data", n: int, band: int,
                                 block: int = 128, rank_np,
                                 precision: str = "highest",
                                 chunk_cols: int = 1024, K_np):
    """Sharded counterpart of ``ops.enrich_band.hypergeom_band_table``
    (``:701``), over the global band ``ind_g`` (int8 or bit-packed, host or
    device) of :func:`band_neighborhoods_sharded`: each rank takes its slab
    of it to the device of its operands.

    nsize from one banded product over each rank's real rows and one
    ``all_reduce(MAX)`` for the class table's row bound (``htab.plan``, in
    chunks of ``chunk_cols`` = 1024 as in JAX); then a K-sorted column
    chunk at a time (``_band_table_chunk_sharded`` :659): the rank's
    census of the chunk, the chunk's table (the same on every rank), the
    rank's lookup; each chunk's rows are assembled into the host outputs
    in the node frame (:func:`_to_node_frame`) and its counts reduced over
    the ranks, a chunk's leading ``overlap`` columns dropped from the
    counts. The lookup is the port's one gather (no ``lookup_group``).

    nan0, nodes_not_nan: the rank's window of the int8 or f32 annotations
    with NaN set to 0 and of the row validity, rows in the permuted frame
    (:func:`operand_window`, :func:`band_hyper_operands_sharded`), on its
    device; ``K_np``: the column totals. Returns (log sf f32,
    indicator int8) (n, A) in host memory in the original node frame and
    the enriched counts int32 (A,) on the device, or None when the plan is
    ineligible (the caller takes the f64 tail loop)."""
    from safepy_tpu_torch.ops import hypergeom_table as htab

    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    bt, nb, _, _, local_rows = geom
    lrows = local_rows * block
    dev = nan0.device
    ind = ind_g[my * lrows:(my + 1) * lrows].to(dev)
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    nnn = nodes_not_nan.to(torch.float32)
    kw = dict(bt=bt, block=block, precision=precision, blocks=(lo, hi),
              row_block_offset=my * local_rows, x_from_block=lo)
    K_np = np.asarray(K_np)
    nsize = bst.band_matmul(ind, nnn[:, None], **kw)[:, 0]
    n_max = torch.zeros(1, dtype=torch.float32, device=dev)
    if nsize.numel():
        n_max[0] = nsize.max()
    dist.all_reduce(n_max, op=dist.ReduceOp.MAX, group=group)
    plan = htab.plan(K_np, float(n_max), int(M), chunk_cols=chunk_cols)
    if plan is None:
        return None

    log_thr64 = float(np.log(enrichment_threshold))
    order = _node_rows(rank_np)
    n_attrs = nan0.shape[1]
    logsf = _host_empty((n, n_attrs), torch.float32, dev)
    nbin = _host_empty((n, n_attrs), torch.int8, dev)
    counts = []
    for ch in plan["chunks"]:
        start, width = ch["start"], ch["width"]
        census = bst.band_matmul(
            ind, nan0[:, start:start + width].to(torch.float32), **kw)
        table = htab.build_logsf_table(
            torch.as_tensor(ch["K_dist"], device=dev), M, log_thr64,
            R=ch["R"], S_max=ch["S_max"], C=ch["C"])
        _nes, logsf_c, bin_c = htab.table_lookup(
            table, census, nsize, torch.as_tensor(ch["colc"], device=dev),
            float(np.float32(log_thr64)), S_max=ch["S_max"], R=ch["R"],
            C=ch["C"])
        del census, table, _nes
        counts.append(_column_counts(bin_c, my, geom, n, block,
                                     group)[ch["overlap"]:])
        cols = slice(start, start + width)
        for x, out in ((logsf_c, logsf), (bin_c, nbin)):
            _to_node_frame(x, order, n_attrs, my, group, ndev, geom, block,
                           out=out, cols=cols)
        del logsf_c, bin_c
    return logsf, nbin, torch.cat(counts)


def fused_hypergeom_pipeline_band_sharded(
        u, v, w, nan0, nodes_not_nan, K, lgt, M, radius,
        enrichment_threshold, rank, *, mesh, axis: str = "data", n: int,
        band: int, block: int = 128, iterations: int,
        precision: str = "highest", keep_distances: bool = True,
        packed: bool = False, attr_chunk: int | None = None):
    """Row-sharded band pipeline, f64 tail-loop engine (``:515``): the FW
    front, then each rank's census over its real block-rows against its
    window of the operands (:func:`operand_window`, taken to its device),
    the survival tail and its finalization
    (``ops.enrich_band.hypergeom_core_band`` on the rank's rows, in columns
    of ``attr_chunk`` when given: the tail is elementwise, so the chunking
    changes no bit), the rows assembled in host memory. Operands as
    ``ops.enrich_band.hypergeom_core_band``'s, NaN-zeroed (n, A) and (n,)
    rows in the permuted frame and the totals K (A,), host or device
    arrays, replicated. Returns (dist_g or None, ind_g, log sf f32,
    indicator int8, enriched counts int32 (A,), mean, std): the bands and
    the (n, A) matrices (the original node frame) in host memory, the
    counts and stats on the device; the NES derives from the log sf in the
    facade."""
    from safepy_tpu_torch.ops.enrich_band import hypergeom_core_band

    slab, ind, my, group, ndev, geom = _sharded_front(
        u, v, w, radius, mesh=mesh, axis=axis, n=n, band=band, block=block,
        packed=packed, keep_distances=keep_distances)
    bt, nb, _, _, local_rows = geom
    dev = ind.device
    p0, p1 = operand_window(my, geom, block)
    lo = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)[0]
    log_sf, nbin = hypergeom_core_band(
        ind, _take_window(nan0, p0, p1, dev, torch.float32),
        _take_window(nodes_not_nan, p0, p1, dev, torch.float32), K, lgt, M,
        enrichment_threshold, iterations=iterations, bt=bt, block=block,
        precision=precision, attr_chunk=attr_chunk, x_from_block=lo,
        **_shard_rows(my, geom))
    counts = _column_counts(nbin, my, geom, n, block, group)
    order = _node_rows(rank)
    log_sf, nbin = (_to_node_frame(x, order, x.shape[1], my, group, ndev,
                                   geom, block) for x in (log_sf, nbin))
    ind_g, dist_g = _assemble_bands(ind, slab, my, group, ndev, geom, block)
    _, mean, std = _band_stats(ind, my, group, ndev, geom, n=n, block=block)
    return dist_g, ind_g, log_sf, nbin, counts, mean, std
