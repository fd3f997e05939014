"""``shortpath_weighted_layout``: shortest-path distances over the edges'
layout lengths, within a radius, by Bellman-Ford on row blocks.

A distance module of the reference (``reference/<node_distance_metric>.py``)
gives ``radius(net, settings)`` and ``distances(net, sources, cutoff,
lowered=...)``; ``net`` holds the benchmark's own arrays."""

from __future__ import annotations

import torch


def to_bfloat16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest even), kept in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def distances_within(n: int, edges: torch.Tensor, lengths: torch.Tensor,
                     sources: torch.Tensor, cutoff: float, *,
                     lowered: bool = False) -> torch.Tensor:
    """(S, n) shortest-path distances from ``sources`` over an undirected
    graph, exact where at most ``cutoff`` and +inf elsewhere.

    Bellman-Ford: every round relaxes every edge in both directions
    (``d[:, v] = min(d[:, v], d[:, u] + w)``) until no distance changes.
    Distances past ``cutoff`` are dropped each round; no path within the
    cutoff passes through one, as lengths are positive. f64, or with
    ``lowered`` every sum rounded to bfloat16 (the control)."""
    dtype = torch.float32 if lowered else torch.float64
    dev = sources.device
    u = torch.cat([edges[:, 0], edges[:, 1]]).to(dev)
    v = torch.cat([edges[:, 1], edges[:, 0]]).to(dev)
    w = torch.cat([lengths, lengths]).to(device=dev, dtype=dtype)
    if lowered:
        w = to_bfloat16(w)
    s = sources.numel()
    d = torch.full((s, n), float("inf"), dtype=dtype, device=dev)
    d[torch.arange(s, device=dev), sources] = 0.0
    index = v.expand(s, -1)
    while True:
        cand = d[:, u] + w
        if lowered:
            cand = to_bfloat16(cand)
        new = d.scatter_reduce(1, index, cand, reduce="amin")
        new.masked_fill_(new > cutoff, float("inf"))
        if torch.equal(new, d):
            return d
        d = new


def radius_of(coords_x: torch.Tensor, fraction: float) -> float:
    """SAFE's ``shortpath_weighted_layout`` radius: ``fraction`` of the
    layout's extent along x (safepy ``neighborhood_radius`` x
    ``(max(x) - min(x))``), in f64."""
    x = coords_x.to(torch.float64)
    return float(fraction * (x.max() - x.min()))


def radius(net, settings: dict) -> float:
    """The configuration's neighborhood radius in layout units."""
    if settings.get("neighborhood_radius_type", "diameter") != "diameter":
        raise ValueError("the reference knows the 'diameter' radius only")
    return radius_of(torch.as_tensor(net.coords[:, 0]),
                     float(settings["neighborhood_radius"]))


def distances(net, sources: torch.Tensor, cutoff: float, *,
              lowered: bool = False) -> torch.Tensor:
    """(S, n) distances from ``sources``, exact within ``cutoff``, +inf
    past it (``distances_within`` over the network's edges)."""
    dev = sources.device
    return distances_within(len(net.coords),
                            torch.as_tensor(net.edges, device=dev),
                            torch.as_tensor(net.lengths, device=dev),
                            sources, cutoff, lowered=lowered)
