"""The three TSV reports of a session, without pandas.

Port of ``safepy_tpu/output.py:21-61``: into ``output_dir``, the domain
properties, the attribute properties, and the node properties (key, label,
primary domain, its NES and the number of domains; or the full NES matrix
when no domains exist). The files are those ``DataFrame.to_csv(sep="\\t")``
writes from the JAX package's tables: an index column first (the row
number; the domain id, headed ``domain``, for the domains), floats as
numpy's shortest repr, NaN and None empty, booleans ``True`` / ``False``,
a one-element array as its element, and fields quoted where the csv module
quotes them.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np


def _cells(values) -> list[str]:
    """One column's cells as ``to_csv`` writes them."""
    arr = np.asarray(values) if not isinstance(values, list) else None
    if arr is not None and arr.dtype.kind == "f":
        out = arr.astype(str)
        out[np.isnan(arr)] = ""
        return out.tolist()
    if arr is not None and arr.dtype.kind in "iub":
        return [str(v) for v in arr.tolist()]
    cells = []
    for v in values:
        if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
            cells.append("")
        elif isinstance(v, np.ndarray):
            # pandas stores a one-element array set with .at as 0-d
            cells.append(str(v.reshape(()) if v.size == 1 else v))
        else:
            cells.append(str(v))
    return cells


def _write_table(path, columns: dict, index, index_name=""):
    """A table of named columns with its index column, tab-separated."""
    names = list(columns)
    body = [_cells(index)] + [_cells(columns[k]) for k in names]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow([index_name] + [str(k) for k in names])
        writer.writerows(zip(*body))


def _node_table(sf) -> dict:
    """The node-properties columns: the domain summary when domains exist,
    the full NES matrix otherwise (``output.py:21-43``)."""
    graph = sf.graph
    keys, labels = graph.nodes["key"], graph.nodes["label"]
    if sf.node2domain is None:
        nes = np.asarray(sf.nes)
        table = {"key": keys, "label": labels}
        for j, name in enumerate(sf.attributes["name"]):
            table[name] = nes[:, j]
        return table
    n2d = sf.node2domain
    surviving = np.asarray(sf.domains["id"])
    num_domains = np.zeros(graph.num_nodes, np.float64)
    for d in surviving:
        num_domains = num_domains + n2d[d]
    return {"id": np.arange(graph.num_nodes), "key": keys, "label": labels,
            "domain": n2d["primary_domain"], "nes": n2d["primary_nes"],
            "num_domains": num_domains}


def print_output_files(sf, **kwargs):
    """Write the three reports into ``sf.output_dir`` (or ``output_dir=``).
    The unassigned domain 0 is dropped from ``sf.domains`` in place, and
    ``sf.nodes`` becomes the node-properties table."""
    if "output_dir" in kwargs:
        sf.output_dir = kwargs["output_dir"]

    def emit(columns, filename, index, index_name=""):
        path = os.path.join(sf.output_dir, filename)
        _write_table(path, columns, index, index_name)
        logging.info(path)

    if sf.domains is not None:
        # the unassigned pseudo-domain (id 0) is not a reportable domain
        keep = np.asarray(sf.domains["id"]) != 0
        sf.domains["id"] = np.asarray(sf.domains["id"])[keep]
        sf.domains["label"] = [lab for lab, k in zip(sf.domains["label"],
                                                     keep) if k]
        emit(sf.domains, "domain_properties_annotation.txt",
             sf.domains["id"], "domain")

    emit(sf.attributes, "attribute_properties_annotation.txt",
         np.arange(len(sf.attributes["name"])))

    sf.nodes = _node_table(sf)
    emit(sf.nodes, "node_properties_annotation.txt",
         np.arange(sf.graph.num_nodes))
