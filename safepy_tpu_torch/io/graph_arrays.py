"""Graph to the arrays the device core consumes, and the domain-label
heuristic.

Port of ``safepy_tpu/io/graph_arrays.py:20`` and ``:77``. networkx is
imported only by :func:`graph_to_arrays`, when a caller hands in a graph; the
main path can start from arrays instead (see ``SAFE.load_network``).
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np


def graph_to_arrays(G):
    """(coords[N,2] f64, edges[E,2] int64, lengths[E] f64 or None, weights[E]
    f64) of a networkx graph whose nodes are labelled 0..N-1.

    Lengths come from the 'length' edge attribute when every edge has one;
    weights from 'weight', 1 where absent.
    """
    n = G.number_of_nodes()
    xs = dict(G.nodes.data("x"))
    ys = dict(G.nodes.data("y"))
    has_coords = all(xs.get(i) is not None for i in range(n)) and len(xs) == n
    coords = None
    if has_coords:
        coords = np.empty((n, 2), np.float64)
        for i in range(n):
            coords[i, 0] = xs[i]
            coords[i, 1] = ys[i]

    edges = np.asarray(list(G.edges()), dtype=np.int64).reshape(-1, 2)
    lengths = None
    weights = np.ones(len(edges), np.float64)
    if G.number_of_edges():
        raw = [d.get("length") for _, _, d in G.edges(data=True)]
        if all(v is not None for v in raw):
            lengths = np.asarray(raw, np.float64)
        weights = np.asarray(
            [float(d.get("weight", 1)) for _, _, d in G.edges(data=True)],
            np.float64)
    return coords, edges, lengths, weights


def edge_lengths(coords: np.ndarray, edges: np.ndarray,
                 weights: np.ndarray | None = None) -> np.ndarray:
    """Layout distance x edge weight per edge, f64: the array form of
    ``safepy_tpu/io/layout.py:286`` ``calculate_edge_lengths``."""
    coords = np.asarray(coords, np.float64)
    edges = np.asarray(edges).reshape(-1, 2)
    u, v = edges[:, 0], edges[:, 1]
    dist = np.hypot(coords[u, 0] - coords[v, 0], coords[u, 1] - coords[v, 1])
    if weights is None:
        return dist
    return dist * np.asarray(weights, np.float64)


def chop_and_filter(names) -> str:
    """The five most frequent words of a list of names, minus stopwords: the
    domain label heuristic (``safepy_tpu/io/graph_arrays.py:77-86``, which
    takes a pandas Series)."""
    words = re.findall(r"[\w']+", " ".join(str(n) for n in names))
    counts = Counter(words)
    ranked = sorted(counts, key=counts.get, reverse=True)
    stop = {"of", "a", "the", "an", ",", "via", "to", "into", "from"}
    return ", ".join([w for w in ranked if w not in stop][:5])
