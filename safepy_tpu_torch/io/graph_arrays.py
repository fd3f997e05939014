"""Graph to the arrays the device core consumes, node coordinates, and the
domain-label heuristic.

Port of ``safepy_tpu/io/graph_arrays.py:20``, ``:53`` and ``:77``. The
functions take the port's :class:`~safepy_tpu_torch.io.record.NetworkRecord`
or a networkx graph; networkx is never imported here.
"""

from __future__ import annotations

import logging
import re
from collections import Counter

import numpy as np

from safepy_tpu_torch.io.record import NetworkRecord


def _record_coords(G: NetworkRecord):
    """(N, 2) f64 coordinates of a record, or None where a node lacks one."""
    x, y = G.node_attribute("x"), G.node_attribute("y")
    if x is None or y is None or any(v is None for v in x) or any(
            v is None for v in y):
        return None
    return np.column_stack([np.asarray(x, np.float64),
                            np.asarray(y, np.float64)])


def graph_to_arrays(G):
    """(coords[N,2] f64, edges[E,2] int64, lengths[E] f64 or None, weights[E]
    f64) of a network record, or of a networkx graph whose nodes are
    labelled 0..N-1.

    Lengths come from the 'length' edge data when every edge has one;
    weights from 'weight', 1 where absent.
    """
    if isinstance(G, NetworkRecord):
        length = G.edge_data.get("length")
        return (_record_coords(G), G.edges.copy(),
                None if length is None else np.asarray(length, np.float64),
                np.asarray(G.edge_data["weight"], np.float64))
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


def get_node_coordinates(graph, labels=()):
    """(N, 2) layout coordinates; with labels, also which labels were found
    (``graph_arrays.py:53-74``, with its warning for missing labels)."""
    if isinstance(graph, NetworkRecord):
        node_xy = np.column_stack([np.asarray(graph.nodes["x"], float),
                                   np.asarray(graph.nodes["y"], float)])
        node_labels = dict(enumerate(graph.nodes.get("label", ())))
    else:
        x = dict(graph.nodes.data("x"))
        y = dict(graph.nodes.data("y"))
        node_xy = np.column_stack([np.asarray(list(x.values()), float),
                                   np.asarray(list(y.values()), float)])
        node_labels = {u: d["label"] for u, d in graph.nodes(data=True)
                       if "label" in d}
    if len(labels) == 0:
        return node_xy
    label2node = {v: k for k, v in node_labels.items()}
    found = [lb for lb in labels if lb in label2node]
    missing = [lb for lb in labels if lb not in label2node]
    if missing:
        logging.warning("These labels are missing from the network (case "
                        "sensitive): %s" % ", ".join(missing))
    idx = [label2node[lb] for lb in found]
    return node_xy[idx, :], found


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
