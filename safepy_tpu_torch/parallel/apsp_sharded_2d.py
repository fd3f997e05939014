"""2-D block-sharded Floyd-Warshall: the (N, N) distance matrix tiled over a
(``row``, ``col``) mesh.

Port of ``safepy_tpu/parallel/apsp_sharded_2d.py``. The matrix is padded to
``unit = lcm(block R, block C)`` and rank (i, j) holds the (N/R, N/C) tile
of row slab i and column slab j. Per pivot round (JAX ``round_body``
:68-109):

  1. the pivot row panel restricted to the rank's column slab is owned by
     one mesh row: ``all_reduce(MIN)`` over the ``row`` axis (the ranks of
     one mesh column) gives it to the others;
  2. the (T, T) diagonal tile lies in the column-owner's slice of that
     panel: ``all_reduce(MIN)`` over the ``col`` axis replicates it, every
     rank closes it (``close_diag``) and relaxes its row panel against it
     (``relax_panel``, B2);
  3. the pivot column panel of the rank's row slab: ``all_reduce(MIN)``
     over the ``col`` axis, then relaxed against the diagonal
     (``relax_panel``, B4);
  4. every rank relaxes its own tile, ``min(D, Q (x) P)`` (``relax_full``,
     B5): the O(N^3 / (R C)) bulk.

The tiles come out bitwise equal to the classic single-device FW. They are
then shared (row slabs within each mesh column, then the column strips
across the mesh row), so every rank returns the whole matrix.
"""

from __future__ import annotations

import math

import torch

from safepy_tpu_torch.ops.apsp import pad_distances
from safepy_tpu_torch.ops.apsp_cuda import close_diag, relax_full, relax_panel
from safepy_tpu_torch.parallel.apsp_sharded import gather_blocks, pivot_panel
from safepy_tpu_torch.parallel.mesh import mesh_axis


def fw_rounds_tile(tile: torch.Tensor, my_row: int, my_col: int, row_group,
                   col_group, *, npad: int, block: int) -> torch.Tensor:
    """The pivot loop over rank (my_row, my_col)'s tile, in place
    (``_apsp_sharded_2d_impl`` :38)."""
    rows, cols = tile.shape
    for kb in range(npad // block):
        start = kb * block
        row_owner, col_owner = start // rows, start // cols
        local_row = start - row_owner * rows
        local_col = start - col_owner * cols
        p = pivot_panel(tile[local_row:local_row + block]
                        if my_row == row_owner else None,
                        (block, cols), row_group, tile)
        diag = pivot_panel(p[:, local_col:local_col + block]
                           if my_col == col_owner else None,
                           (block, block), col_group, tile)
        diag = close_diag(diag)
        p = relax_panel(p, diag, p)
        q = pivot_panel(tile[:, local_col:local_col + block]
                        if my_col == col_owner else None,
                        (rows, block), col_group, tile)
        q = relax_panel(q, q, diag)
        relax_full(q, p, tile)
    return tile


def apsp_sharded_2d(dist_matrix: torch.Tensor, mesh, *,
                    row_axis: str = "row", col_axis: str = "col",
                    block: int = 128) -> torch.Tensor:
    """All-pairs shortest paths with the distance matrix 2-D block-sharded
    (``apsp_sharded_2d.py:112``): every rank passes the same (N, N) matrix
    and gets the (N, N) f32 distances."""
    row_group, n_row, my_row = mesh_axis(mesh, row_axis)
    col_group, n_col, my_col = mesh_axis(mesh, col_axis)
    n = dist_matrix.shape[0]
    # tiles must never straddle a shard boundary on either axis
    d = pad_distances(dist_matrix.to(torch.float32),
                      math.lcm(block * n_row, block * n_col))
    npad = d.shape[0]
    rows, cols = npad // n_row, npad // n_col
    tile = d[my_row * rows:(my_row + 1) * rows,
             my_col * cols:(my_col + 1) * cols].clone()
    fw_rounds_tile(tile, my_row, my_col, row_group, col_group, npad=npad,
                   block=block)
    strip = gather_blocks(tile, row_group, n_row, my_row, 0)
    return gather_blocks(strip, col_group, n_col, my_col, 1)[:n, :n]
