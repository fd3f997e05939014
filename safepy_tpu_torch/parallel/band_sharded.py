"""Row-sharded band-STORAGE Floyd-Warshall + banded enrichment over a mesh.

Port of ``safepy_tpu/parallel/band_sharded.py`` (the FW engine and the
quantitative permutation pipeline). The JAX package runs one program over
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

The downstream contractions run on each rank's real block-rows against
replicated (n, A) operands (the row-shard forms of ``ops.apsp_bandstore``'s
``band_matmul``, ``band_matmul_batch``, ``band_count_batch`` and
``apply_compaction``, and of ``ops.enrich_band``'s ``band_score`` and
``scan_counts_band``: ``_band_matmul_local`` :187, ``_band_matmul_batch_local``
:220, ``_band_score_local`` :253 and ``_scan_counts_local`` :278; the ghost
padding of ``_ghost_pad_cols`` :413 is ``band_matmul``'s own). Every rank
draws the same permutations (the same generator seed, or the same
``perm_idx``), so no collective is needed until the outputs are assembled.

Outputs: the JAX functions return global arrays whose rows stay sharded;
these return them assembled on every rank (each rank's rows broadcast to
the others, exact for any dtype), so every rank holds the same global band,
scores and counts. ``all_reduce`` and ``broadcast`` are the only collectives,
so the gloo backend works on CUDA tensors too (two ranks on one card).

Not ported (ROADMAP A10 remainder): the euclidean pipeline (:332-406, :784),
the hypergeometric and class-table engines (:512-580, :656-781) and the
bit-packed indicator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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
    """The (rows, ...) global array whose ``segments[r]`` rows are rank r's
    ``local`` rows, on every rank (``local`` itself on one rank)."""
    if len(segments) == 1:
        return local
    out = torch.zeros((rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    r0, r1 = segments[my]
    out[r0:r1] = local
    _share_rows(out, segments, group)
    return out


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


def _sharded_front(u, v, w, radius, *, mesh, axis, n, band, block):
    """Init -> FW -> indicator on this rank's slab. Returns (slab, ind, my,
    group, ndev, geometry of :func:`sharded_band_geometry`)."""
    group, ndev, my = mesh_axis(mesh, axis)
    geom = sharded_band_geometry(n, band, ndev, block)
    bt, nb, width, g_pad, local_rows = geom
    slab = band_init_local(u, v, w, my, n=n, bt=bt, local_rows=local_rows,
                           width=width, block=block)
    _band_fw_rounds(slab, my, group, nb=nb, bt=bt, local_rows=local_rows,
                    block=block)
    return slab, bst.band_threshold(slab, radius), my, group, ndev, geom


def _band_segments(ndev: int, rows_per_rank: int):
    return [(r * rows_per_rank, (r + 1) * rows_per_rank) for r in range(ndev)]


def band_neighborhoods_sharded(u, v, w, radius, *, mesh, axis: str = "data",
                               n: int, band: int, block: int = 128):
    """Row-sharded band FW front half (``:589``): (dist_g, ind_g, sizes_g,
    mean, std), the bands in the global ghost-padded permuted frame
    (g_pad b rows) on every rank, distances beyond the radius +inf."""
    slab, ind, my, group, ndev, geom = _sharded_front(
        u, v, w, radius, mesh=mesh, axis=axis, n=n, band=band, block=block)
    bt, _, _, g_pad, local_rows = geom
    segs = _band_segments(ndev, local_rows * block)
    slab.masked_fill_(ind == 0, _INF)
    dist_g = _assemble(slab, g_pad * block, segs, my, group)
    ind_g = _assemble(ind, g_pad * block, segs, my, group)
    _, mean, std = bst.band_row_stats(ind_g, n=n, bt=bt, block=block)
    return dist_g, ind_g, bst.band_row_sizes(ind_g), mean, std


def band_matmul_sharded(ind_g, x, *, mesh, axis: str = "data", n: int,
                        band: int, block: int = 128,
                        precision: str = "highest") -> torch.Tensor:
    """(row-sharded banded indicator) @ x for a replicated (n, A) operand
    (``:633``): the ghosted (g_pad b, A) global product on every rank, each
    rank contracting its own real block-rows of the global band ``ind_g``;
    ghost and pad rows are 0."""
    group, ndev, my = mesh_axis(mesh, axis)
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    lrows = local_rows * block
    ind = ind_g[my * lrows:(my + 1) * lrows]
    lo, hi = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    npad = nb * block
    xg = torch.zeros((npad, x.shape[1]), dtype=torch.float32,
                     device=ind.device)
    xg[:x.shape[0]] = x
    prod = bst.band_matmul(ind, xg, bt=bt, block=block, precision=precision,
                           blocks=(lo, hi), row_block_offset=my * local_rows)
    segs = [tuple(b * block for b in real_blocks(r, nb=nb, bt=bt,
                                                 local_rows=local_rows))
            for r in range(ndev)]
    out = torch.zeros((g_pad * block, x.shape[1]), dtype=torch.float32,
                      device=ind.device)
    out[bt * block:bt * block + npad] = _assemble(prod, npad, segs, my,
                                                  group)
    return out


def fused_permutation_pipeline_band_sharded(
        u, v, w, vals, vals_valid, valid, starts, rank, generator, radius, *,
        mesh, axis: str = "data", n: int, band: int, block: int = 128,
        score_type: str = "sum", num_permutations: int = 1000,
        batch_size: int = 1000, w_c: int, precision: str = "highest",
        keep_distances: bool = True, perm_idx=None):
    """Row-sharded band pipeline (``:419``): init, FW, threshold, scores,
    null, every band-shaped array split over the ranks of ``axis``.

    Same inputs and frames as ``pipeline.fused_permutation_pipeline_band``,
    replicated on every rank: ``generator`` must be seeded alike on every
    rank (or ``perm_idx`` given), so that every rank draws the same
    permutations. Returns (dist_g or None, ind_g, obs, counts_neg,
    counts_pos, mean, std) on every rank: the bands in the global
    ghost-padded permuted frame (g_pad b rows), the (n, A) matrices in the
    original node frame. ``keep_distances=False`` frees each rank's f32 slab
    after thresholding and returns None for the distances.
    """
    slab, ind, my, group, ndev, geom = _sharded_front(
        u, v, w, radius, mesh=mesh, axis=axis, n=n, band=band, block=block)
    bt, nb, width, g_pad, local_rows = geom
    if keep_distances:
        slab.masked_fill_(ind == 0, _INF)
    else:
        del slab
    blocks = real_blocks(my, nb=nb, bt=bt, local_rows=local_rows)
    obs, counts_neg, counts_pos = _band_null(
        ind, vals, vals_valid, valid, starts, rank, generator, bt=bt,
        block=block, score_type=score_type,
        num_permutations=num_permutations, batch_size=batch_size, w_c=w_c,
        precision=precision, perm_idx=perm_idx, blocks=blocks,
        row_block_offset=my * local_rows)

    npad = nb * block
    row_segs = [tuple(b * block for b in real_blocks(
        r, nb=nb, bt=bt, local_rows=local_rows)) for r in range(ndev)]
    obs, counts_neg, counts_pos = (
        _assemble(x, npad, row_segs, my, group)[rank]
        for x in (obs, counts_neg, counts_pos))
    band_segs = _band_segments(ndev, local_rows * block)
    ind_g = _assemble(ind, g_pad * block, band_segs, my, group)
    dist_g = (_assemble(slab, g_pad * block, band_segs, my, group)
              if keep_distances else None)
    _, mean, std = bst.band_row_stats(ind_g, n=n, bt=bt, block=block)
    return dist_g, ind_g, obs, counts_neg, counts_pos, mean, std
