"""The loaded network without networkx.

The JAX package's loaders return a ``networkx.Graph``; the card's machine
has no networkx, so the port's loaders return a :class:`NetworkRecord`
holding what the analysis reads from that graph, in the graph's own order:

- nodes 0..N-1 with per-node columns (``label``, the node key attribute,
  ``key`` once the facade has copied it, ``x``, ``y`` and any table columns
  of a ``.cys`` file), each an array of N values (None where a node has no
  value);
- the (E, 2) int64 edge list in ``Graph.edges()`` order;
- per-edge columns ``weight`` (1 where the source has none) and ``length``
  (once the layout exists).

:func:`graph_edges` gives the edge list a ``networkx.Graph`` builds from a
sequence of endpoint pairs: duplicate and reversed pairs collapse, a
self-loop stays, and ``Graph.edges()`` lists each edge once from its
smaller node, the nodes in order and each node's neighbours in the order
they were first added.
"""

from __future__ import annotations

import numpy as np


def graph_edges(pairs, num_nodes=None):
    """(edges (E, 2) int64, first (E,), last (E,)) of the graph built by
    adding ``pairs`` (P, 2) in order to a graph whose nodes are 0..N-1 in
    order: the edges in ``Graph.edges()`` order, and for each the index in
    ``pairs`` of its first and of its last occurrence (a later pair of the
    same edge overwrites its data in networkx)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if not len(pairs):
        empty = np.zeros(0, np.int64)
        return np.zeros((0, 2), np.int64), empty, empty
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    n = int(num_nodes if num_nodes is not None else hi.max() + 1)
    key = lo * n + hi
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    last = np.zeros(len(first), np.int64)
    np.maximum.at(last, inverse, np.arange(len(key)))
    # Graph.edges(): node by node, each node's neighbours in insertion
    # order; an edge's insertion into its smaller node's neighbours is its
    # first occurrence
    order = np.lexsort((first, lo[first]))
    first, last = first[order], last[order]
    return np.stack([lo[first], hi[first]], axis=1), first, last


def column(values):
    """One per-node column as an array: numeric where every value is a
    number (its numpy dtype kept: float32 layout coordinates stay float32),
    else an object array."""
    values = list(values)
    if values and all(isinstance(v, (int, float, np.integer, np.floating))
                      and not isinstance(v, (bool, np.bool_))
                      for v in values):
        return np.asarray(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


class NetworkRecord:
    """Nodes 0..N-1 with per-node columns, and an edge list with per-edge
    columns (see the module docstring)."""

    def __init__(self, num_nodes, edges=None, nodes=None, edge_data=None):
        self.num_nodes = int(num_nodes)
        self.edges = (np.zeros((0, 2), np.int64) if edges is None
                      else np.asarray(edges, np.int64).reshape(-1, 2))
        self.nodes = dict(nodes or {})
        self.edge_data = dict(edge_data or {})
        self.edge_data.setdefault("weight",
                                  np.ones(len(self.edges), np.float64))

    def number_of_nodes(self) -> int:
        return self.num_nodes

    def number_of_edges(self) -> int:
        return len(self.edges)

    def node_attribute(self, name):
        """The column ``name``, or None where no node has a value."""
        col = self.nodes.get(name)
        if col is None or all(v is None for v in col):
            return None
        return col

    def __repr__(self):
        return (f"NetworkRecord({self.num_nodes} nodes, {len(self.edges)} "
                f"edges, node columns {list(self.nodes)}, edge columns "
                f"{list(self.edge_data)})")

    @classmethod
    def from_networkx(cls, G):
        """The record of a networkx graph whose nodes are 0..N-1: every
        node attribute a column, ``weight`` (1 where absent) and, when
        every edge has one, ``length``, in ``G.edges()`` order."""
        n = G.number_of_nodes()
        names = list(dict.fromkeys(k for _, d in G.nodes(data=True)
                                   for k in d))
        nodes = {k: column(G.nodes[i].get(k) for i in range(n))
                 for k in names}
        data = [d for _, _, d in G.edges(data=True)]
        edges = np.asarray(list(G.edges()), np.int64).reshape(-1, 2)
        edge_data = {"weight": np.asarray(
            [float(d.get("weight", 1)) for d in data], np.float64)}
        if data and all(d.get("length") is not None for d in data):
            edge_data["length"] = np.asarray([d["length"] for d in data],
                                             np.float64)
        return cls(n, edges, nodes, edge_data)
