"""The GO annotation matrix: an OBO ontology and a GAF annotation file to a
gene x term binary matrix, each annotation propagated to its term's
ancestors.

Port of ``safepy_tpu/utils/make_go.py:34-187`` without networkx or pandas,
on the host:

- the OBO v1.2 dump is stream-parsed into term records; the term before
  the first ``[Typedef]`` is kept (JAX's fix of the reference,
  ``make_go.py:45-50``);
- the ``is_a`` DAG (parent -> child) skips obsolete terms; a parent is
  added, under its child's namespace, before its own stanza; the branch
  (p / c / f) is the subgraph of the nodes of that namespace, in the
  graph's insertion order;
- every term's closure (itself and its ancestors) in one pass in
  topological order;
- the GAF is read as ``read_csv(sep="\\t", header=None, comment="!")``
  reads it (the rest of a line after ``!`` dropped, empty lines skipped),
  column 1 the gene and column 4 the term, duplicate pairs dropped;
- terms with no annotated gene are dropped; genes left with none go to
  the branch root, the first node of the branch (in insertion order) with
  no parent in it. Where the root's own column was dropped, JAX's
  ``df.loc[orphans, root] = 1`` appends it as the last column when every
  gene is an orphan, and otherwise leaves NaN that ``astype(int)`` refuses:
  the same ``ValueError`` is raised here.

:func:`make_go_matrix` writes ``go_<branch>_matrix.txt`` beside the GAF,
byte for byte what JAX's ``DataFrame.to_csv(sep="\\t")`` writes, and
``go_<branch>.p``, a pickle of numpy arrays, lists and dicts (JAX's holds
DataFrames and a networkx graph, which a machine without pandas and
networkx cannot load; neither package reads the other's pickle).

CLI::

    python -m safepy_tpu_torch.utils.make_go --path-to-obo go-basic.obo \\
        --path-to-annotations sgd.gaf --go-branch p
"""

from __future__ import annotations

import argparse
import csv
import io as _io
import os
import pickle
from collections import defaultdict
from typing import NamedTuple

import numpy as np

from safepy_tpu_torch.io.table import NA_STRINGS

NAMESPACES = {"p": "biological_process", "c": "cellular_component",
              "f": "molecular_function"}


def parse_go_obo(path_to_obo):
    """Yield one dict per [Term] stanza of an OBO v1.2 file
    (``make_go.py:34-60``)."""
    with open(path_to_obo, "r") as infile:
        current = None
        for line in infile:
            line = line.strip()
            if not line:
                continue
            if line == "[Term]":
                if current:
                    yield _finish_term(current)
                current = defaultdict(list)
            elif line == "[Typedef]":
                # the pending term first (the reference drops the term
                # before the first [Typedef], make_go.py:111-113)
                if current:
                    yield _finish_term(current)
                current = None
            elif current is not None:
                key, _, val = line.partition(":")
                val_id, _, _ = val.partition("!")
                current[key].append(val_id.strip())
        if current:
            yield _finish_term(current)


def _finish_term(term):
    out = dict(term)
    for key, value in out.items():
        if key != "is_a" and len(value) == 1:
            out[key] = value[0]
    return out


class GoGraph:
    """The ``is_a`` DAG as networkx's DiGraph holds what JAX reads of it:
    the nodes in insertion order with their namespace, and each node's
    parents in edge insertion order."""

    def __init__(self):
        self.namespace: dict[str, str] = {}
        self.parents: dict[str, list[str]] = {}

    def __contains__(self, node):
        return node in self.namespace

    def __iter__(self):
        return iter(self.namespace)

    def __len__(self):
        return len(self.namespace)

    def add_node(self, node, namespace=""):
        """Add a node, or set an existing one's namespace (it keeps its
        place)."""
        self.namespace[node] = namespace
        self.parents.setdefault(node, [])

    def add_edge(self, parent, child):
        for node in (parent, child):
            if node not in self.namespace:
                self.add_node(node)
        if parent not in self.parents[child]:
            self.parents[child].append(parent)

    def has_edge(self, parent, child) -> bool:
        return child in self.parents and parent in self.parents[child]

    def subgraph(self, nodes) -> "GoGraph":
        """The induced subgraph, its nodes in this graph's order."""
        keep = set(nodes)
        sub = GoGraph()
        for node, ns in self.namespace.items():
            if node in keep:
                sub.namespace[node] = ns
                sub.parents[node] = [p for p in self.parents[node]
                                     if p in keep]
        return sub

    def roots(self) -> list[str]:
        """The nodes with no parent, in node order (``in_degree() == 0``)."""
        return [n for n in self.namespace if not self.parents[n]]


def get_go_graph(path_to_obo):
    """OBO -> ``{"go_graph": GoGraph, "go_details": {"id", "name",
    "namespace"}}`` (``make_go.py:70-91``); a ``.p`` path is unpickled as
    the port's own pickle of that dict."""
    if os.path.splitext(path_to_obo)[1] == ".p":
        with open(path_to_obo, "rb") as f:
            return pickle.load(f)

    go_graph = GoGraph()
    details = {"id": [], "name": [], "namespace": []}
    for go_term in parse_go_obo(path_to_obo):
        name = go_term.get("name", "")
        if isinstance(name, str) and name.startswith("obsolete"):
            continue
        for k in details:
            details[k].append(go_term.get(k, ""))
        namespace = go_term.get("namespace", "")
        go_graph.add_node(go_term["id"], namespace=namespace)
        for parent in go_term.get("is_a", []):
            if parent not in go_graph:
                go_graph.add_node(parent, namespace=namespace)
            go_graph.add_edge(parent, go_term["id"])
    return {"go_graph": go_graph, "go_details": details}


def ancestors_closure(graph: GoGraph) -> dict:
    """{term: set of the term and all its ``is_a`` ancestors}, one pass in
    topological order (``make_go.py:94-102``)."""
    children = defaultdict(list)
    pending = {}
    for node, parents in graph.parents.items():
        pending[node] = len(parents)
        for p in parents:
            children[p].append(node)
    ready = [n for n in graph.namespace if pending[n] == 0]
    closure = {}
    while ready:
        node = ready.pop()
        s = {node}
        for parent in graph.parents[node]:
            s |= closure[parent]
        closure[node] = s
        for child in children[node]:
            pending[child] -= 1
            if pending[child] == 0:
                ready.append(child)
    if len(closure) != len(graph):
        raise ValueError("the is_a graph has a cycle")
    return closure


def _gaf_rows(path):
    """The rows of a GAF as ``read_csv(delimiter="\\t", header=None,
    comment="!")`` splits them: text from ``!`` on dropped, empty lines
    skipped, quoted fields read as the csv module reads them, short rows
    padded, a row longer than the first refused."""
    rows = []
    with open(path, encoding="utf-8", newline="") as f:
        for line in f:
            line = line.rstrip("\r\n")
            cut = line.find("!")
            if cut >= 0:
                line = line[:cut]
            if not line:
                continue
            rows.append(next(csv.reader([line], delimiter="\t"))
                        if '"' in line else line.split("\t"))
    width = len(rows[0]) if rows else 0
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"Expected {width} fields in line {i + 1}, "
                             f"saw {len(r)}")
        r.extend([""] * (width - len(r)))
    return rows


def read_annotations(path_to_annotations) -> dict:
    """GAF -> its columns ``{j: list}`` (``make_go.py:105-110``); pandas'
    NA strings read as NaN."""
    rows = _gaf_rows(path_to_annotations)
    width = len(rows[0]) if rows else 0
    return {j: [np.nan if r[j] in NA_STRINGS else r[j] for r in rows]
            for j in range(width)}


class GoMatrix(NamedTuple):
    """The gene x term matrix: int64 ``values`` (loci, terms), ``index``
    the loci, ``columns`` the terms (JAX: a DataFrame)."""
    values: np.ndarray
    index: list
    columns: list


def make_locus2term(go_graph: GoGraph, go_annotations: dict) -> GoMatrix:
    """Binary (loci x terms) matrix with ancestor propagation
    (``make_go.py:113-140``)."""
    go_terms = sorted(go_graph)
    genes, terms = go_annotations[1], go_annotations[4]
    loci = sorted(set(genes))
    term_index = {t: i for i, t in enumerate(go_terms)}
    locus_index = {g: i for i, g in enumerate(loci)}
    closure = {t: np.fromiter((term_index[a] for a in s), np.int64,
                              count=len(s))
               for t, s in ancestors_closure(go_graph).items()}

    locus2term = np.zeros((len(loci), len(go_terms)), dtype=np.int8)
    rows, cols = [], []
    for gene, term in dict.fromkeys(zip(genes, terms)):
        if term not in closure:
            continue
        c = closure[term]
        rows.append(np.full(len(c), locus_index[gene]))
        cols.append(c)
    if rows:
        locus2term[np.concatenate(rows), np.concatenate(cols)] = 1

    # drop empty terms; orphan loci get the branch root
    keep = locus2term.sum(axis=0) > 0
    columns = [t for t, k in zip(go_terms, keep) if k]
    values = locus2term[:, keep].astype(np.int64)
    roots = go_graph.roots()
    orphans = values.sum(axis=1) == 0
    refuse = False
    if roots:
        if roots[0] in columns:
            values[orphans, columns.index(roots[0])] = 1
        elif orphans.all():
            values = np.concatenate(
                [values, np.ones((len(loci), 1), np.int64)], axis=1)
            columns.append(roots[0])
        else:
            # pandas appends the column with NaN off the orphan rows
            refuse = True
    print("%d loci had 0 terms and were assigned to the root."
          % int(orphans.sum()))
    if refuse:
        raise ValueError(
            "Cannot convert non-finite values (NA or inf) to integer."
            "Replace or remove non-finite values or cast to an integer type"
            "that supports these values (e.g. 'Int64')")
    return GoMatrix(values, loci, columns)


def write_matrix_tsv(path: str, matrix: GoMatrix) -> None:
    """The matrix as ``DataFrame.to_csv(path, sep="\\t")`` writes it: a
    header of an empty index name and the terms, then one line a locus
    (fields quoted where the csv module quotes them, ``\\n`` line ends)."""
    def fields(values):
        buf = _io.StringIO()
        csv.writer(buf, delimiter="\t", lineterminator="\n").writerow(values)
        return buf.getvalue()

    values = matrix.values
    loci, terms = len(matrix.index), len(matrix.columns)
    with open(path, "wb") as f:
        f.write(fields([""] + list(matrix.columns)).encode("utf-8"))
        if terms:
            body = np.full((loci, 2 * terms), ord("\t"), np.uint8)
            body[:, 0::2] = values + ord("0")  # 0/1 digits
            body[:, -1] = ord("\n")
        for i, locus in enumerate(matrix.index):
            head = fields([locus]).encode("utf-8")
            f.write(head[:-1] + (b"\t" + body[i].tobytes() if terms
                                 else b"\n"))


def make_go_matrix(path_to_obo="", path_to_annotations="", go_branch="p"):
    """OBO + GAF -> the propagated matrix, written beside the GAF as a TSV
    and a pickle (``make_go.py:143-172``). Returns a :class:`GoMatrix`."""
    dirname = os.path.dirname(path_to_annotations)

    go = get_go_graph(path_to_obo)
    go_graph = go["go_graph"]
    go_annotations = read_annotations(path_to_annotations)

    branch_nodes = [n for n in go_graph
                    if go_graph.namespace[n] == NAMESPACES[go_branch]]
    go_graph_branch = go_graph.subgraph(branch_nodes)

    go_matrix = make_locus2term(go_graph_branch, go_annotations)

    output = {"go_matrix": go_matrix._asdict(),
              "go_details": go["go_details"],
              "locus_details": go_annotations,
              "tree_path": path_to_obo,
              "annotations_path": path_to_annotations}

    pickle_path = os.path.join(dirname, "go_" + go_branch + ".p")
    print("Saving the results at %s" % pickle_path)
    with open(pickle_path, "wb") as handle:
        pickle.dump(output, handle)

    txt_path = os.path.join(dirname, "go_" + go_branch + "_matrix.txt")
    print("Printing the gene-to-term matrix at %s" % txt_path)
    write_matrix_tsv(txt_path, go_matrix)
    return go_matrix


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate a matrix of gene (locus) to GO term "
                    "associations.")
    parser.add_argument("--path-to-obo", type=str,
                        help="Path to file containing the GO tree")
    parser.add_argument("--path-to-annotations", type=str,
                        help="Path to gene-to-term annotation file")
    parser.add_argument("--go-branch", default="p", type=str,
                        help="p, c or f")
    args = parser.parse_args(argv)
    make_go_matrix(path_to_obo=args.path_to_obo,
                   path_to_annotations=args.path_to_annotations,
                   go_branch=args.go_branch)


if __name__ == "__main__":
    main()
