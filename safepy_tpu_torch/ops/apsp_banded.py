"""Radius-bounded banded Floyd-Warshall: the neighborhood APSP of the main path.

Port of ``safepy_tpu/ops/apsp_banded.py``. When edge lengths are the
Euclidean distances of their endpoints, every node on a path of length
<= nr lies within nr of both ends. Sort the nodes by a spatial order and let B
be the largest index separation of any Euclidean nr-pair: then each FW round
only needs the (2B + block)-wide window around its pivot block. Entries of
pairs within the radius come out exact, all others are upper bounds, so
thresholding at the radius is exact everywhere.

The host certificates (:func:`banded_order`, :func:`window_width` and their
helpers, and :func:`graph_banded_order`, the landmark certificate that band
storage also uses) are numpy and scipy, copied from the JAX package; the
rounds run on the kernels of :mod:`.apsp_cuda`.
"""

from __future__ import annotations

import numpy as np
import torch

from safepy_tpu_torch.ops.apsp import pad_distances
from safepy_tpu_torch.ops.apsp_cuda import fw_round
from safepy_tpu_torch.ops.neighborhoods import _initial_distances
from safepy_tpu_torch.profiling import span


def hilbert_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting 2-D points along a Hilbert curve (``:44``)."""
    xy = np.asarray(coords, dtype=np.float64)
    lo = xy.min(axis=0)
    span = np.maximum(xy.max(axis=0) - lo, 1e-12)
    side = (1 << bits) - 1
    x = np.minimum((xy[:, 0] - lo[0]) / span[0] * side, side).astype(np.uint64)
    y = np.minimum((xy[:, 1] - lo[1]) / span[1] * side, side).astype(np.uint64)

    d = np.zeros_like(x)
    s = np.uint64(1) << np.uint64(bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x[flip] = s - np.uint64(1) - x_f[flip]
        y[flip] = s - np.uint64(1) - y_f[flip]
        x_s = x.copy()
        x[swap] = y[swap]
        y[swap] = x_s[swap]
        s >>= np.uint64(1)
    return np.argsort(d, kind="stable")


def radius_pairs(coords: np.ndarray, radius: float) -> np.ndarray:
    """All index pairs within Euclidean ``radius`` (``:74``)."""
    from scipy.spatial import cKDTree

    return cKDTree(coords).query_pairs(float(radius), output_type="ndarray")


def band_halfwidth(coords: np.ndarray, order: np.ndarray, radius: float,
                   pairs: np.ndarray | None = None) -> int:
    """Certified band: max index separation over all radius pairs (``:81``)."""
    if pairs is None:
        pairs = radius_pairs(coords, radius)
    if len(pairs) == 0:
        return 1
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return int(np.abs(rank[pairs[:, 0]] - rank[pairs[:, 1]]).max())


def window_halfwidth(values: np.ndarray, radius: float) -> int:
    """Certified half-width of the sort-by-``values`` order (``:93``): the most
    OTHER nodes in any closed window of width ``radius``."""
    s = np.sort(np.asarray(values, dtype=np.float64), kind="stable")
    if len(s) == 0:
        return 1
    hi = np.searchsorted(s, s + radius, side="right")
    return max(1, int((hi - np.arange(len(s))).max()) - 1)


def banded_order(coords: np.ndarray, radius: float,
                 exact_below: int = 50_000):
    """Best (order, half-width B) among Hilbert, x-sort and y-sort (``:110``).

    Above ``exact_below`` nodes the x/y sorts are certified by
    :func:`window_halfwidth`; otherwise the band is measured over the actual
    radius pairs, shared across candidates."""
    n = len(coords)
    if n > exact_below:
        bx = window_halfwidth(coords[:, 0], radius)
        by = window_halfwidth(coords[:, 1], radius)
        if min(bx, by) <= n // 8:
            axis = 0 if bx <= by else 1
            return (np.argsort(coords[:, axis], kind="stable"), min(bx, by))
    pairs = radius_pairs(coords, radius)
    candidates = [hilbert_order(coords),
                  np.argsort(coords[:, 0], kind="stable"),
                  np.argsort(coords[:, 1], kind="stable")]
    best = None
    for order in candidates:
        width = band_halfwidth(coords, order, radius, pairs)
        if best is None or width < best[1]:
            best = (order, width)
    return best


def graph_banded_order(n: int, edges: np.ndarray, weights: np.ndarray,
                       radius: float):
    """(order, half-width B) certified without coordinates, for any metric
    (``:146``).

    With ``ds`` the shortest-path distance from a fixed source,
    d(u, v) <= r implies |ds(u) - ds(v)| <= r, so ordering the nodes by
    (component, ds) bounds the rank separation of every within-radius pair,
    and of every node on a within-radius path, by the most nodes in any
    closed ds-window of width r. The source is peripheral per component
    (double sweep).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra

    edges = np.asarray(edges)
    if len(edges) == 0:
        return np.arange(n), max(1, n - 1)
    w = np.asarray(weights, np.float64)
    u2 = np.concatenate([edges[:, 0], edges[:, 1]])
    v2 = np.concatenate([edges[:, 1], edges[:, 0]])
    g = coo_matrix((np.concatenate([w, w]), (u2, v2)), shape=(n, n)).tocsr()

    ncomp, labels = connected_components(g, directed=False)
    # one seed per component -> distances to the nearest seed; the
    # per-component argmax of that sweep is a peripheral node
    seeds = np.unique(labels, return_index=True)[1]
    d0 = dijkstra(g, indices=seeds, min_only=True)
    d0 = np.where(np.isfinite(d0), d0, 0.0)
    by_comp = np.lexsort((d0, labels))
    far = by_comp[np.searchsorted(labels[by_comp], np.arange(ncomp),
                                  side="right") - 1]
    ds = dijkstra(g, indices=far, min_only=True)
    ds = np.where(np.isfinite(ds), ds, 0.0)

    order = np.lexsort((ds, labels))
    # shift each component's ds range into a disjoint block so that one
    # two-pointer count covers them all
    span = float(ds.max()) + float(radius) + 1.0
    keys = labels[order] * (2.0 * span) + ds[order]
    band = window_halfwidth(keys, float(radius))
    return order, band


def window_width(n: int, band: int, block: int = 128) -> int:
    """Window span covering [pivot - B, pivot + block + B), padded to a block
    multiple and capped at the padded matrix size (``:201``)."""
    npad = -(-n // block) * block
    w = -(-(2 * band + block) // block) * block
    return min(w, npad)


def apsp_banded_fw(dist: torch.Tensor, *, window: int, block: int = 128,
                   symmetric: bool = True) -> torch.Tensor:
    """Blocked FW restricted to a ``window``-wide band around each pivot block
    (``:211``), IN PLACE on ``dist``, which is returned.

    ``dist`` must be float32, in the banded order and padded to a block
    multiple (diagonal 0, inf elsewhere). Updating it in place saves the
    (npad, npad) copy a functional round would make. Entries are exact for
    pairs within the certified radius, upper bounds elsewhere.
    ``symmetric`` (the default) promises a symmetric ``dist`` (undirected
    graph) and relaxes each window's upper tiles plus mirror; ``False`` is
    the classic round (``relax_full`` with a tile band), which directed
    matrices need.
    """
    npad = dist.shape[0]
    nb = npad // block
    w = window
    half = (w - block) // 2
    # corner tiles with |i - j| beyond this are never read back as part of a
    # pivot panel and lie beyond the radius in the output (apsp_banded.py:237)
    band_tiles = half // block + 3
    with span("neighborhoods.relax", engine="window", rounds=nb):
        for kb in range(nb):
            start = kb * block
            lo = min(max(start - half, 0), npad - w)
            fw_round(dist, start, lo, w, block, band_tiles,
                     symmetric=symmetric)
    return dist


def apsp_banded_unpermuted(d0_permuted, inv_rank: torch.Tensor, radius, *,
                           window: int, block: int = 128) -> torch.Tensor:
    """Banded FW -> original node frame -> radius mask (``:280``).

    ``d0_permuted`` is the dense (N, N) initialization in banded order, or the
    tuple ``(u, v, w)`` of permuted edge arrays on the device, from which the
    padded matrix is built directly. Entries beyond ``radius`` become inf.
    """
    n = inv_rank.shape[0]
    npad = -(-n // block) * block
    if isinstance(d0_permuted, tuple):
        u, v, w = d0_permuted
        d = _initial_distances(u, v, w, num_nodes=n, size=npad)
    else:
        d = pad_distances(d0_permuted.to(torch.float32), block)
        if d.data_ptr() == d0_permuted.data_ptr():
            d = d.clone()  # the rounds run in place
    apsp_banded_fw(d, window=window, block=block)
    inv = inv_rank.to(device=d.device, dtype=torch.int64)
    out = d[:n, :n].index_select(0, inv).index_select(1, inv)
    r = torch.as_tensor(radius, dtype=torch.float32, device=out.device)
    # in place on the fresh un-permuted copy: beyond the radius the entries
    # are upper bounds, and the reference's Dijkstra cutoff keeps none of them
    out.masked_fill_(~(out <= r), float("inf"))
    return out
