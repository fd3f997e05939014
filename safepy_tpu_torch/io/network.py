"""Network loaders: tab text, gpickle, MATLAB sessions, Cytoscape bundles,
scatter tables.

Port of ``safepy_tpu/io/network.py``. Each loader returns a
:class:`~safepy_tpu_torch.io.record.NetworkRecord` with the nodes, node
columns, edges and edge data, in the order, that the JAX loader's
``networkx.Graph`` holds them:

- ``load_network_from_txt`` (``:97``): 3-column (key1, key2, weight) or
  5-column (label1, key1, label2, key2, weight) tab files, ``.gz`` read
  transparently, ``.txt`` without and ``.tsv`` with a header line. Nodes
  are numbered by first appearance, every first-column endpoint before
  every second-column one; edges are resolved by label, duplicate and
  reversed ones collapse and self-loops stay. ``engine='native'`` is the
  C++ parser (:mod:`.edgelist`), ``'python'`` the Python one, ``'auto'``
  the native one where it builds. Then the layout and the edge lengths;
- ``load_network_from_gpickle`` (``:149``): a pickled networkx graph
  (networkx needed) or a pickled record;
- ``load_network_from_mat`` (``:158``): a legacy MATLAB session, its
  adjacency values the edge weights, its coordinates fixed;
- ``load_network_from_cys`` (``:227``): a Cytoscape bundle read from the
  archive: coordinates from the view, edges from the network, node columns
  from the SHARED_ATTRS node table, nodes renumbered in graph order;
- ``load_network_from_scatter`` (``:282``): a table of (key, x, y, label),
  a network of positioned nodes without edges.
"""

from __future__ import annotations

import csv
import gzip
import io as _io
import logging
import pickle
import zipfile
from os.path import expanduser
from pathlib import Path
from xml.dom import minidom

import numpy as np

from safepy_tpu_torch.io import table as _table
from safepy_tpu_torch.io.layout import (apply_network_layout,
                                        calculate_edge_lengths)
from safepy_tpu_torch.io.matlab import load_mat
from safepy_tpu_torch.io.record import NetworkRecord, column, graph_edges

# ------------------------------------------------------------------ tab text


def _open_text(filename):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename, "rt")


def _sniff_format(filename):
    """(columns, has_header): the first suffix decides, so 'net.txt.gz'
    reads as .txt."""
    kind = Path(filename).suffixes[0]
    if kind not in (".txt", ".tsv"):
        raise ValueError(f"extension {kind} not supported")
    with _open_text(filename) as fh:
        num_cols = len(fh.readline().rstrip("\n").split("\t"))
    if num_cols not in (3, 5):
        raise ValueError("Unknown network file format. 3 or 5 columns are "
                         "expected.")
    return num_cols, kind == ".tsv"


def _coerce_column(values):
    """Whole-column type of a 5-column file's endpoint columns
    (``network.py:66-74``): all int -> ints, all float -> floats, else the
    strings."""
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            break
    return values


def _record_from_endpoints(labels1, keys1, labels2, keys2,
                           node_key_attribute):
    """Nodes numbered by first appearance of their (label, key) pair,
    edges resolved by label (``network.py:77-94``)."""
    index_by_pair: dict = {}
    for pair in zip(labels1, keys1):
        index_by_pair.setdefault(pair, len(index_by_pair))
    for pair in zip(labels2, keys2):
        index_by_pair.setdefault(pair, len(index_by_pair))
    index_by_label: dict = {}
    for (label, _key), idx in index_by_pair.items():
        index_by_label.setdefault(label, idx)
    pairs = [(index_by_label[a], index_by_label[b])
             for a, b in zip(labels1, labels2)]
    n = len(index_by_pair)
    edges, _, _ = graph_edges(pairs, n)
    return NetworkRecord(n, edges, {
        "label": column(label for label, _ in index_by_pair),
        node_key_attribute: column(key for _, key in index_by_pair)})


def load_network_from_txt(filename, layout="spring_embedded",
                          node_key_attribute="key", seed=None, verbose=True,
                          engine="auto", device="cuda"):
    """Load a tab edge list and lay it out (``layout`` on ``device`` for
    'spring_tpu'). Every engine gives the same record, node order
    included."""
    filename = filename.replace("~", expanduser("~"))
    num_cols, has_header = _sniff_format(filename)
    graph = None

    if engine in ("auto", "native"):
        from safepy_tpu_torch.io import edgelist

        parsed = edgelist.parse_edgelist(filename, num_cols,
                                         skip_header=has_header)
        if parsed is not None:
            labels, keys, edge_idx, _weights = parsed
            n = len(labels)
            edges, _, _ = graph_edges(edge_idx, n)
            graph = NetworkRecord(n, edges, {
                "label": column(labels), node_key_attribute: column(keys)})
        elif engine == "native":
            raise RuntimeError("native edge-list parser unavailable "
                               "(g++ build failed?)")

    if graph is None:
        with _open_text(filename) as fh:
            lines = fh.read().splitlines()
        if has_header:
            lines = lines[1:]
        cells = [line.split("\t") for line in lines if line.strip()]
        columns = [list(col) for col in zip(*cells)]
        if num_cols == 3:
            # keys double as labels and stay strings (network.py:131-134)
            labels1 = keys1 = columns[0]
            labels2 = keys2 = columns[1]
        else:
            labels1, keys1, labels2, keys2 = map(_coerce_column, columns[:4])
        graph = _record_from_endpoints(labels1, keys1, labels2, keys2,
                                       node_key_attribute)

    graph = apply_network_layout(graph, layout=layout, seed=seed,
                                 verbose=verbose, device=device)
    return calculate_edge_lengths(graph, verbose=verbose)


# ------------------------------------------------------------------ gpickle


def load_network_from_gpickle(filename, verbose=True):
    """A pickled graph: a networkx graph (nodes 0..N-1) becomes a record,
    which needs networkx; a pickled record is returned as it is."""
    filename = filename.replace("~", expanduser("~"))
    with open(filename, "rb") as f:
        try:
            obj = pickle.load(f)
        except ModuleNotFoundError as e:
            raise ImportError(f"{filename} holds a pickled networkx graph and "
                              "networkx is not installed") from e
    if isinstance(obj, NetworkRecord):
        return obj
    return NetworkRecord.from_networkx(obj)


# ------------------------------------------------------------------ MATLAB


def _adjacency_triples(edges):
    """(rows, cols, values) of an adjacency matrix in the order networkx
    walks it: a dense array's nonzeros row by row
    (``from_numpy_array``), a sparse one's stored entries in its format's
    order (``from_scipy_sparse_array``: csr by rows, csc by columns, any
    other format as coo)."""
    if not (hasattr(edges, "toarray") or hasattr(edges, "tocoo")):
        a = np.asarray(edges)
        rows, cols = np.nonzero(a)
        return a.shape[0], rows, cols, a[rows, cols]
    fmt = edges.format
    if fmt in ("csr", "csc"):
        major = np.repeat(np.arange(len(edges.indptr) - 1),
                          np.diff(edges.indptr))
        minor = edges.indices
        rows, cols = (major, minor) if fmt == "csr" else (minor, major)
        return edges.shape[0], rows, cols, edges.data
    coo = edges.tocoo()
    return edges.shape[0], coo.row, coo.col, coo.data


def load_network_from_mat(filename, verbose=True):
    """A legacy MATLAB SAFE session (``layout.edges/label/label_orf/x/y``),
    its coordinates fixed; an adjacency value is the edge's weight (the
    last of an edge's two entries, as networkx keeps it)."""
    filename = filename.replace("~", expanduser("~"))
    if verbose:
        logging.info("Loading the mat file...")
    layout = load_mat(filename)["layout"]
    n, rows, cols, values = _adjacency_triples(layout["edges"])
    edges, _, last = graph_edges(np.stack([rows, cols], axis=1), n)
    weights = np.asarray(values, np.float64)[last]
    graph = NetworkRecord(n, edges, {
        "label": column(layout["label"][i] for i in range(n)),
        "key": column(layout["label_orf"][i] for i in range(n)),
        "x": np.asarray(layout["x"])[:n], "y": np.asarray(layout["y"])[:n]},
        {"weight": weights})
    return calculate_edge_lengths(graph, verbose=verbose)


# ---------------------------------------------------------------- Cytoscape


def _xgmml_view_nodes(stream):
    """XGMML view -> {cy:nodeId: (label, x, y)} of the nodes with
    graphics."""
    doc = minidom.parse(stream)
    placed = {}
    for node in doc.getElementsByTagName("node"):
        try:
            node_id = int(node.attributes["cy:nodeId"].value)
            label = node.attributes["label"].value
        except KeyError:
            continue
        graphics = [child for child in node.childNodes
                    if child.nodeType == child.ELEMENT_NODE
                    and child.tagName == "graphics"]
        if graphics:
            placed[node_id] = (label,
                               float(graphics[0].attributes["x"].value),
                               float(graphics[0].attributes["y"].value))
    return placed


def _xgmml_network_edges(stream):
    """Network XML -> [(source_id, target_id), ...]."""
    doc = minidom.parse(stream)
    edges = []
    for edge in doc.getElementsByTagName("edge"):
        attrs = edge.attributes
        if attrs.get("source") is not None and attrs.get("target") is not None:
            edges.append((int(attrs["source"].value),
                          int(attrs["target"].value)))
    return edges


def _cytable_rows(text):
    """node.cytable CSV -> (column names, [(SUID, row), ...]): a header row
    whose first cell is 'SUID' among the first rows, data rows from the
    first whose first cell is an integer."""
    rows = list(csv.reader(_io.StringIO(text)))
    header = next((row for row in rows[:7] if row and row[0] == "SUID"), None)
    if header is None:
        return None, []
    data = [(int(row[0]), row) for row in rows
            if row and row[0].isdigit() and len(row) == len(header)]
    return header, data


def load_network_from_cys(filename, view_name=None, verbose=True):
    """A Cytoscape session bundle, read from the archive's streams."""
    filename = filename.replace("~", expanduser("~"))
    if verbose:
        logging.info("Loading the cys file %s..." % filename)

    with zipfile.ZipFile(filename, "r") as bundle:
        members = bundle.namelist()

        views = [m for m in members if "/views/" in m]
        if view_name:
            views = [m for m in views if m.endswith(view_name + ".xgmml")]
        if not views:
            raise ValueError(f"no matching view in {filename}")
        if verbose:
            logging.info("Loading the view: %s" % views[0])
        with bundle.open(views[0]) as stream:
            placed = _xgmml_view_nodes(stream)

        network = next(m for m in members if "/networks/" in m)
        if verbose:
            logging.info("Loading the first network: %s" % network)
        with bundle.open(network) as stream:
            edge_list = _xgmml_network_edges(stream)

        # the graph's nodes: every endpoint in order of first appearance,
        # less those the view does not place
        ids = [s for s in dict.fromkeys(x for e in edge_list for x in e)
               if s in placed]
        index = {s: i for i, s in enumerate(ids)}
        data = [dict(zip(("label", "x", "y"), placed[s])) for s in ids]

        network_name = Path(network).stem
        tables = [m for m in members
                  if "/tables/" in m and network_name in m
                  and "SHARED_ATTRS" in m and "node.cytable" in m]
        if tables:
            text = bundle.read(tables[0]).decode("utf-8", errors="replace")
            header, rows = _cytable_rows(text)
            if header:
                for suid, row in rows:
                    if suid in index:
                        data[index[suid]].update(zip(header[1:], row[1:]))

    pairs = [(index[a], index[b]) for a, b in edge_list
             if a in index and b in index]
    edges, _, _ = graph_edges(pairs, len(ids))
    names = list(dict.fromkeys(k for d in data for k in d))
    graph = NetworkRecord(len(ids), edges,
                          {k: column(d.get(k) for d in data) for k in names})
    return calculate_edge_lengths(graph, verbose=verbose)


# ------------------------------------------------------------------ scatter


def load_network_from_scatter(filename, node_key_attribute="key",
                              verbose=True):
    """A tab table of (key, x, y, label) with a header line, its columns
    typed as ``read_csv`` types them: positioned nodes, no edges."""
    filename = filename.replace("~", expanduser("~"))
    if verbose:
        logging.info("Loading the file of node coordinates...")
    rows = _table.read_rows(filename)
    width = len(rows[0])
    if width != 4:
        raise ValueError(f"Length mismatch: Expected axis has {width} "
                         "elements, new values have 4 elements")
    body = [r + [""] * (width - len(r)) for r in rows[1:]]
    cols = [_table.infer_column([r[j] for r in body]) for j in range(width)]
    return NetworkRecord(len(body), None,
                         dict(zip(("key", "x", "y", "label"), cols)))
