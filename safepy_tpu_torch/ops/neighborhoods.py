"""Neighborhood indicators, the inclusive radius and the FW initialization.

Port of ``safepy_tpu/ops/neighborhoods.py`` for the shortest-path metrics:
``shortpath_weighted_layout`` keeps ``dist <= r`` (NetworkX's Dijkstra cutoff
keeps paths of length <= cutoff); the diagonal stays 1.
"""

from __future__ import annotations

import numpy as np
import torch

from safepy_tpu_torch.ops._device import on_device


def euclidean_distance_matrix(coords: torch.Tensor) -> torch.Tensor:
    """Dense pairwise Euclidean distances of (N, 2) coordinates (``:27``),
    in their dtype, with an exact zero diagonal despite the cancellation of
    ``|x|^2 + |y|^2 - 2 x.y``."""
    coords, = on_device("euclidean_distance_matrix", coords)
    sq = (coords * coords).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * coords @ coords.T
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    eye = torch.eye(coords.shape[0], dtype=d.dtype, device=d.device)
    return d * (1.0 - eye)


def neighborhoods_from_distances(dist: torch.Tensor, radius,
                                 *, strict: bool) -> torch.Tensor:
    """f32 indicator: ``dist < r`` (strict) or ``dist <= r`` (``:39``)."""
    dist, = on_device("neighborhoods_from_distances", dist)
    r = torch.as_tensor(radius, dtype=dist.dtype, device=dist.device)
    ind = (dist < r) if strict else (dist <= r)
    return ind.to(torch.float32)


def inclusive_radius(nr: float) -> np.float32:
    """The f32 threshold for ``dist <= nr`` on f32 FW distances (``:47``): one
    relative ulp of slack, so f64-exact boundary paths do not fall out to
    f32 rounding."""
    return np.float32(nr) * np.float32(1 + 1e-6)


def threshold_and_stats(dist: torch.Tensor, radius, *, strict: bool):
    """(indicator f32, mean size, std size) as 0-d tensors (``:55``).

    The std is the population one (``jnp.std``'s ddof=0)."""
    nbr = neighborhoods_from_distances(dist, radius, strict=strict)
    sizes = nbr.sum(dim=1)
    return nbr, sizes.mean(), sizes.std(correction=0)


def _initial_distances(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       *, num_nodes: int, size: int | None = None
                       ) -> torch.Tensor:
    """Dense (size, size) f32 FW initialization from edge arrays on their
    device (``_initial_distances_jit`` :66): 0 diagonal, inf elsewhere, then a
    scatter-min of the edge lengths in both directions. ``size > num_nodes``
    yields :func:`ops.apsp.pad_distances` of the (num_nodes, num_nodes)
    matrix directly, without building it first."""
    size = num_nodes if size is None else size
    d = torch.full((size, size), float("inf"), dtype=torch.float32,
                   device=w.device)
    d.diagonal().zero_()
    flat = d.view(-1)
    u = u.to(torch.int64)
    v = v.to(torch.int64)
    w = w.to(torch.float32)
    flat.scatter_reduce_(0, u * size + v, w, reduce="amin")
    flat.scatter_reduce_(0, v * size + u, w, reduce="amin")
    return d


def initial_distances_device(num_nodes: int, edges, weights=None, *,
                             device=None) -> torch.Tensor:
    """Device-resident dense (N, N) initialization from an undirected edge
    list (``:73``); only the O(E) edge arrays are copied to the device.

    device: None means "cuda", as the JAX function builds on the
    accelerator, and raises where torch sees no card; the caller asks for
    the host by name with ``device="cpu"``, as ``SAFE(device="cpu")``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initial_distances_device(device='cuda') needs a "
                           "CUDA device and none is available; pass "
                           "device='cpu' to build it on the host")
    edges = np.asarray(edges).reshape(-1, 2)
    w = (np.ones(len(edges), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    return _initial_distances(
        torch.as_tensor(edges[:, 0], dtype=torch.int64, device=device),
        torch.as_tensor(edges[:, 1], dtype=torch.int64, device=device),
        torch.as_tensor(w, device=device), num_nodes=num_nodes)


def dense_initial_distances(num_nodes: int, edges, weights=None,
                            dtype=np.float32) -> np.ndarray:
    """Host-side dense (N, N) initialization (``:94``): inf off-edge, 0
    diagonal, the minimum weight (or 1.0) on edges; symmetric."""
    d = np.empty((num_nodes, num_nodes), dtype=dtype)
    d[:] = np.inf
    np.fill_diagonal(d, 0.0)
    edges = np.asarray(edges)
    if edges.size:
        u, v = edges[:, 0].astype(np.intp), edges[:, 1].astype(np.intp)
        w = (np.ones(len(u), dtype=dtype) if weights is None
             else np.asarray(weights, dtype=dtype))
        np.minimum.at(d, (u, v), w)
        np.minimum.at(d, (v, u), w)
    return d
