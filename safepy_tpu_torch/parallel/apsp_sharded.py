"""Row-sharded blocked Floyd-Warshall over a mesh axis.

Port of ``safepy_tpu/parallel/apsp_sharded.py``. The (N, N) distance matrix
is padded to a multiple of ``block * ndev`` and split into ``ndev`` equal row
slabs, rank r holding rows [r N/ndev, (r + 1) N/ndev). Per pivot round kb
(JAX ``round_body`` :58-71), every rank of the axis:

  1. gets the (T, N) pivot row panel: its owner copies it, the others fill
     +inf, and one ``all_reduce(MIN)`` gives it to every rank (JAX's
     ``pmin``);
  2. closes the diagonal tile (``close_diag``) and relaxes the panel
     against it (``relax_panel``, B2), and relaxes its own slab's pivot
     columns against it into a new (N/ndev, T) panel (``relax_panel``, B4);
  3. relaxes its whole slab, ``min(D, Q (x) P)`` (``relax_full``, B5): the
     O(N^3 / ndev) bulk.

Each step is JAX's, so every rank's rows come out bitwise equal to the
classic single-device FW (``ops.apsp(d0)``): each candidate is one f32 add
and ``min`` is exact. The relaxed slab is then shared: every rank gets the
whole matrix on its device (each rank's rows broadcast to the others).
``all_reduce`` and ``broadcast`` are the only collectives, so gloo carries
CUDA tensors too (several ranks on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from safepy_tpu_torch.ops.apsp import pad_distances
from safepy_tpu_torch.ops.apsp_cuda import close_diag, relax_full, relax_panel
from safepy_tpu_torch.parallel.mesh import mesh_axis

_INF = float("inf")


def gather_blocks(local: torch.Tensor, group, ndev: int, my: int,
                  dim: int) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's equal-shaped
    ``local`` block (rank order of ``group``), on every rank: each rank's
    block is broadcast to the others. ``local`` itself at one rank."""
    if ndev == 1:
        return local
    ranks = dist.get_process_group_ranks(group)
    parts = []
    for r in range(ndev):
        buf = (local.contiguous() if r == my
               else torch.empty_like(local, memory_format=torch.contiguous_format))
        dist.broadcast(buf, src=ranks[r], group=group)
        parts.append(buf)
    return torch.cat(parts, dim=dim)


def pivot_panel(owned, shape, group, like: torch.Tensor) -> torch.Tensor:
    """``owned`` (a view this rank holds) or, where None, +inf of
    ``shape``, MIN-reduced over ``group``: the owner's values on every
    rank (JAX's ``pmin`` of ``where(owner, x, inf)``)."""
    p = (owned.clone(memory_format=torch.contiguous_format)
         if owned is not None
         else torch.full(shape, _INF, dtype=like.dtype, device=like.device))
    dist.all_reduce(p, op=dist.ReduceOp.MIN, group=group)
    return p


def fw_rounds_rows(slab: torch.Tensor, my: int, group, *, ndev: int,
                   block: int) -> torch.Tensor:
    """The pivot loop over rank ``my``'s (npad / ndev, npad) row slab, in
    place (``_apsp_sharded_impl`` :35). Every rank runs every round and
    makes its one ``all_reduce``."""
    rows, npad = slab.shape
    for kb in range(npad // block):
        start = kb * block
        owner = start // rows
        local = start - owner * rows
        p = pivot_panel(slab[local:local + block] if my == owner else None,
                        (block, npad), group, slab)
        diag = close_diag(p[:, start:start + block])
        p = relax_panel(p, diag, p)
        q = slab[:, start:start + block]
        q = relax_panel(q, q, diag)  # a new tensor, apart from the slab
        relax_full(q, p, slab)
    return slab


def apsp_sharded(dist_matrix: torch.Tensor, mesh, *, axis: str = "data",
                 block: int = 128) -> torch.Tensor:
    """All-pairs shortest paths with the distance matrix row-sharded over
    the mesh's ``axis`` (``apsp_sharded.py:75``): every rank of the axis
    passes the same (N, N) matrix and gets the (N, N) f32 distances. The
    padding makes every slab a whole number of blocks (``pad_distances(d,
    block * ndev)``), so no tile straddles two ranks."""
    group, ndev, my = mesh_axis(mesh, axis)
    n = dist_matrix.shape[0]
    d = pad_distances(dist_matrix.to(torch.float32), block * ndev)
    rows = d.shape[0] // ndev
    slab = d[my * rows:(my + 1) * rows].clone()  # the rounds work in place
    fw_rounds_rows(slab, my, group, ndev=ndev, block=block)
    return gather_blocks(slab, group, ndev, my, 0)[:n, :n]
