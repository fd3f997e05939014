"""The hypergeometric census and enrichment with attribute columns sharded
over a mesh axis.

Port of ``safepy_tpu/parallel/hypergeom_sharded.py``: the (N, A) annotation
columns are zero-padded to a multiple of the ``attr`` axis and split into
equal slices; each rank computes its slice's census GEMMs (and survival
tail) against the replicated neighborhood indicator, with no traffic
between ranks until the slices are shared (each broadcast to the others,
so every rank returns the (N, A) results; JAX's stay sharded until read).
"""

from __future__ import annotations

import numpy as np
import torch

from safepy_tpu_torch.parallel.apsp_sharded import gather_blocks
from safepy_tpu_torch.parallel.mesh import mesh_axis


def column_slice(n_attrs: int, mesh, axis: str):
    """(group, ndev, my, width): the columns padded to a multiple of the
    axis (``pipeline.py:182-195``) and each rank's slice width; rank ``my``
    holds padded columns [my width, (my + 1) width)."""
    group, ndev, my = mesh_axis(mesh, axis)
    return group, ndev, my, -(-n_attrs // ndev)


def my_columns(x: torch.Tensor, width: int, my: int) -> torch.Tensor:
    """This rank's ``width`` columns of ``x``, zero-padded past its last
    column (JAX's ``jnp.pad`` before the shard)."""
    lo = my * width
    part = x[:, lo:lo + width]
    if part.shape[1] == width:
        return part
    out = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    out[:, :part.shape[1]] = part
    return out


def gather_columns(local: torch.Tensor, n_attrs: int, group, ndev: int,
                   my: int) -> torch.Tensor:
    """Every rank's column slice, joined and cut back to ``n_attrs``."""
    return gather_blocks(local, group, ndev, my, 1)[:, :n_attrs]


def hypergeom_counts_sharded(neighborhoods, node2attribute, *, mesh,
                             axis: str = "attr"):
    """The sharded census (``:38``): (counts (N, A), neighborhood sizes
    (N,)) f32, each rank contracting its column slice at full f32."""
    from safepy_tpu_torch.ops.score import check_fp32_matmul

    check_fp32_matmul("highest")
    nbr = torch.as_tensor(neighborhoods).to(torch.float32)
    n2a = torch.as_tensor(node2attribute, device=nbr.device).to(
        torch.float32)
    finite = torch.isfinite(n2a)
    vals = torch.where(finite, n2a, 0.0)
    nodes_not_nan = finite.any(dim=1).to(torch.float32)
    group, ndev, my, width = column_slice(vals.shape[1], mesh, axis)
    counts = nbr @ my_columns(vals, width, my)
    nsize = nbr @ nodes_not_nan
    return gather_columns(counts, vals.shape[1], group, ndev, my), nsize


def hypergeom_enrichment_sharded(neighborhoods, node2attribute, *, mesh,
                                 axis: str = "attr",
                                 enrichment_threshold: float = 0.05,
                                 node2attribute_device=None):
    """Sharded hypergeometric enrichment for the staged facade path
    (``:78``): each rank runs its column slice's census and f64 survival
    tail (``pipeline._hypergeom_tail``'s ``attr`` branch).
    ``node2attribute`` is the host matrix (the scalars M, K and the tail's
    bound come from it); ``node2attribute_device`` its f32 copy on the
    device, else it is uploaded to the indicator's device.

    Returns (nes f32, log sf f32, indicator int8, enriched counts int32
    (A,)), every rank the same."""
    from safepy_tpu_torch.ops.hypergeom import lgamma_table, tail_iterations
    from safepy_tpu_torch.pipeline import _hypergeom_tail

    n2a = np.asarray(node2attribute, dtype=np.float64)
    M = int(np.any(~np.isnan(n2a), axis=1).sum())
    totals = np.nansum(n2a, axis=0)
    k_max = int(max(1, np.nanmax(totals))) if totals.size else 1
    iterations = tail_iterations(M, min(k_max, max(M, 1)))
    nbr = torch.as_tensor(neighborhoods).to(torch.float32)
    lgt = torch.as_tensor(lgamma_table(max(M, 1)), device=nbr.device)
    vals = (node2attribute_device if node2attribute_device is not None
            else torch.as_tensor(n2a, dtype=torch.float32,
                                 device=nbr.device))
    nes32, log_sf32, nes_binary = _hypergeom_tail(
        nbr, vals, lgt, M, enrichment_threshold, iterations=int(iterations),
        mesh=mesh, attr_axis=axis)
    return nes32, log_sf32, nes_binary, nes_binary.sum(dim=0,
                                                       dtype=torch.int32)
