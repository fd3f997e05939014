"""Frozen input generators: the networks and attribute sets of the cells.

Copies of ``chip_smoke.py``'s generators (``build_network`` :379,
``build_attribute`` :400, ``build_band_attribute`` :408, ``build_go_matrix``
and ``go_matrices`` :1639-1670), which follow ``bench.py:60,145-147,457-458``.
They are kept here so that the yardstick does not move when the program's
scripts do. Everything is drawn from one ``numpy`` generator per call, so one
seed gives the same inputs on every machine.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def edge_lengths(coords: np.ndarray, edges: np.ndarray,
                 weights: np.ndarray | None = None) -> np.ndarray:
    """Layout distance of each edge's endpoints times its weight, f64: the
    ``shortpath_weighted_layout`` edge length of SAFE (safepy's
    ``calculate_edge_lengths``)."""
    coords = np.asarray(coords, np.float64)
    u, v = edges[:, 0], edges[:, 1]
    dist = np.hypot(coords[u, 0] - coords[v, 0], coords[u, 1] - coords[v, 1])
    return dist if weights is None else dist * np.asarray(weights, np.float64)


def build_network(n: int, k: int, edge_budget: int | None, seed: int):
    """A geometric stand-in for a biological network: ``n`` uniform points in
    [-1, 1]^2, the edges to each point's ``k - 1`` nearest neighbours taken
    point by point until ``edge_budget`` edges exist (None: all of them),
    unit weights and Euclidean edge lengths. Returns (coords (n, 2) f64,
    edges (E, 2) int64 sorted, lengths (E,) f64, weights (E,) f64)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = set()
    for i in range(n):
        for j in nn[i, 1:]:
            edges.add((min(i, int(j)), max(i, int(j))))
            if edge_budget and len(edges) >= edge_budget:
                break
        if edge_budget and len(edges) >= edge_budget:
            break
    edges = np.array(sorted(edges), dtype=np.int64)
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def build_attribute(n: int, nan_share: float, seed: int) -> np.ndarray:
    """One normal attribute, (n, 1), with a share ``nan_share`` of NaN rows
    (``chip_smoke.build_attribute``: 0.33, ``build_band_attribute``: 0.3)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < nan_share, 0] = np.nan
    return vals


def quantitative_pool(n: int, count: int, nan_share: float, seed: int,
                      attributes: int = 1) -> list[np.ndarray]:
    """``count`` quantitative attribute sets, (n, attributes) each, that
    share one NaN mask: the conditions of one screen, which all miss the
    same genes. The mask is drawn as ``build_attribute`` draws it; each
    set's values are drawn after it from the same generator."""
    rng = np.random.default_rng(seed)
    nan_rows = rng.random(n) < nan_share
    pool = []
    for _ in range(count):
        vals = rng.normal(size=(n, attributes))
        vals[nan_rows] = np.nan
        pool.append(vals)
    return pool


def build_go_matrix(coords: np.ndarray, sizes, seed: int,
                    nan_share: float = 0.1) -> np.ndarray:
    """A binary (n, len(sizes)) GO-like annotation matrix: term j has
    ``sizes[j]`` members, drawn among the 2 sizes[j] annotated nodes nearest
    a random centre, so that domains of enrichment exist; the rows of
    unannotated genes (a share ``nan_share``) are NaN."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    nan_rows = rng.random(n) < nan_share
    ann = np.flatnonzero(~nan_rows)
    tree = cKDTree(coords[ann])
    out = np.zeros((n, len(sizes)))
    for j, s in enumerate(sizes):
        _, near = tree.query(rng.uniform(-0.8, 0.8, 2),
                             k=min(2 * int(s), len(ann)))
        out[ann[rng.choice(near, int(s), replace=False)], j] = 1.0
    out[nan_rows] = np.nan
    return out


def go_sizes_loguniform(terms: int, low: float, high: float,
                        seed: int) -> np.ndarray:
    """Term sizes log-uniform on [low, high], rounded (``go_matrices``'
    matrix A: 3-300)."""
    rng = np.random.default_rng(seed)
    return np.rint(np.exp(rng.uniform(np.log(low), np.log(high), terms)))
