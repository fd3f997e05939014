"""The attribute matrix: loading and alignment to the network's node order.

Port of ``safepy_tpu/io/attributes.py:29-142`` without pandas (the card's
machine has none): a tab ``.txt`` / ``.tsv`` / ``.gz`` file (first column
the node label, the rest attributes), a GO ``.mat`` (``go.term2orf``,
orfs x terms after transposing), or a pandas DataFrame the caller hands in.
The values and their dtype are those the JAX package's pandas calls give
(:mod:`.table`): a text column whose float32 copy is within 5e-4 stays
float32, and the matrix is float32 only when every column is.

Then, as in JAX: duplicate labels are averaged (pandas' compensated group
mean, labels sorted, NA labels dropped), the rows are reindexed to the node
order with the fill value, ``mask_duplicates`` keeps one random node per
duplicated label with the caller's generator, and the census is logged.
"""

from __future__ import annotations

import logging
import os
import sys
from os.path import expanduser

import numpy as np

from safepy_tpu_torch.io import table as _table
from safepy_tpu_torch.io.matlab import load_mat


class _Columns:
    """The attribute table between loading and alignment: row labels (None
    for an NA label) and one 1-D array per column."""

    def __init__(self, labels, columns):
        self.labels = list(labels)
        self.columns = list(columns)

    def dtypes(self):
        return [c.dtype for c in self.columns]


def _from_text(file_name):
    """``read_csv(sep="\\t", dtype={0: str})`` with the first column as the
    index, then ``to_numeric(downcast="float", errors="coerce")`` of each
    column (``attributes.py:54-61``)."""
    rows = _table.read_rows(file_name)
    if not rows:
        raise ValueError(f"{file_name}: no header")
    header = _table.dedup_header(rows[0])
    body = rows[1:]
    labels = [None if (r[0] if r else "") in _table.NA_STRINGS else r[0]
              for r in body]
    _, vals = _table.cells_matrix(body, 1, len(header))
    columns = []
    for j in range(vals.shape[1]):
        col = vals[:, j]
        columns.append(col.astype(_table.downcast_float(col)))
    return _Columns(labels, columns), header[1:]


def _downcast_unsigned(col):
    """``to_numeric(col, downcast="unsigned")`` of a numeric column: the
    smallest unsigned type that holds it exactly when it is non-negative
    and has no NaN, else the column as it is."""
    col = np.asarray(col)
    if col.dtype.kind not in "iuf" or not len(col):
        return col
    if col.dtype.kind == "f" and np.isnan(col).any():
        return col
    if col.min() < 0:
        return col
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if np.dtype(dt).itemsize > col.dtype.itemsize:
            break
        with np.errstate(invalid="ignore", over="ignore"):
            cast = col.astype(dt)
        if np.allclose(cast, col, rtol=0):
            return cast
    return col


def _from_mat(file_name):
    """The GO matrix of a MATLAB session (``attributes.py:44-51``)."""
    go = load_mat(file_name)["go"]
    data = np.transpose(np.asarray(go["term2orf"]))
    if data.ndim == 1:
        data = data[:, None]
    columns = [_downcast_unsigned(data[:, j]) for j in range(data.shape[1])]
    ids = np.atleast_1d(go["term_ids"])
    attributes = {"id": ids,
                  "name": [str(n) for n in np.atleast_1d(go["term_names"])]}
    return _Columns(np.atleast_1d(go["orfs"]), columns), attributes


def _from_dataframe(df):
    """A caller's DataFrame: numeric as it is, else ``to_numeric(errors=
    "coerce")`` column by column (``attributes.py:81-82``)."""
    pd = sys.modules["pandas"]
    if not all(pd.api.types.is_numeric_dtype(t) for t in df.dtypes):
        df = df.apply(pd.to_numeric, errors="coerce")
    labels = [None if (not isinstance(x, str) and pd.isna(x)) else x
              for x in df.index]
    return _Columns(labels, [df.iloc[:, j].to_numpy()
                             for j in range(df.shape[1])])


def _group_mean(table: _Columns) -> _Columns:
    """``groupby(index).mean()``: one row per label, sorted, NA labels
    dropped; each column's mean in its float type (float64 for integers),
    summed with pandas' Kahan compensation over the non-NaN values."""
    keep = [i for i, lab in enumerate(table.labels) if lab is not None]
    groups: dict = {}
    for i in keep:
        groups.setdefault(table.labels[i], []).append(i)
    order = sorted(groups)
    members = [groups[lab] for lab in order]
    depth = max(len(m) for m in members)
    # (G, depth) row indices, -1 past a group's end
    idx = np.full((len(order), depth), -1, np.int64)
    for g, m in enumerate(members):
        idx[g, :len(m)] = m
    columns = []
    for col in table.columns:
        dt = col.dtype if col.dtype.kind == "f" else np.dtype(np.float64)
        col = col.astype(dt)
        total = np.zeros(len(order), dt)
        comp = np.zeros(len(order), dt)
        count = np.zeros(len(order), np.int64)
        for r in range(depth):
            x = np.where(idx[:, r] >= 0, col[idx[:, r]], dt.type(np.nan))
            ok = ~np.isnan(x)
            y = x - comp
            t = total + y
            # an infinite value makes the compensation NaN: pandas resets
            # it to 0 (GH#50367)
            c = (t - total) - y
            comp = np.where(ok, np.where(np.isnan(c), dt.type(0), c), comp)
            total = np.where(ok, t, total)
            count += ok
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = total / count.astype(dt)
        columns.append(np.where(count > 0, mean, dt.type(np.nan)).astype(dt))
    return _Columns(order, columns)


def _reindex(table: _Columns, order, fill_value) -> _Columns:
    """``reindex(index=order, fill_value=...)``: the rows in ``order``;
    a label the table lacks gets ``fill_value``, and its integer column
    turns float64."""
    row_of = {lab: i for i, lab in enumerate(table.labels) if lab is not None}
    src = np.array([row_of.get(lab, -1) for lab in order], np.int64)
    missing = src < 0
    columns = []
    for col in table.columns:
        out = col[np.maximum(src, 0)]
        if missing.any():
            if out.dtype.kind != "f":
                out = out.astype(np.float64)
            out[missing] = fill_value
        columns.append(out)
    return _Columns(list(order), columns)


def read_attributes(attribute_file="", node_label_order=None,
                    mask_duplicates=False, fill_value=np.nan, verbose=True,
                    rng=None):
    """Load and align an attribute matrix.

    Returns ``(attributes, node_label_order, node2attribute)``:
    ``attributes`` a dict of the ``id`` and ``name`` arrays (JAX: a
    DataFrame), and ``node2attribute`` the (N, A) float32 or float64 matrix
    in ``node_label_order``."""
    pd = sys.modules.get("pandas")
    if isinstance(attribute_file, str):
        file_name = attribute_file.replace("~", expanduser("~"))
        _, ext = os.path.splitext(file_name)
        if ext == ".mat":
            table, attributes = _from_mat(file_name)
        elif ext in (".txt", ".gz", ".tsv"):
            table, names = _from_text(file_name)
            attributes = {"id": np.arange(len(names)), "name": names}
        else:
            raise ValueError("Only attribute files with the following "
                             "extensions are accepted: .mat, .txt, .gz.")
    elif pd is not None and isinstance(attribute_file, pd.DataFrame):
        table = _from_dataframe(attribute_file)
        attributes = {"id": np.arange(attribute_file.shape[1]),
                      "name": list(attribute_file.columns)}
    else:
        raise ValueError(type(attribute_file))
    attributes["name"] = [str(n) for n in attributes["name"]]

    labels = table.labels
    if len(set(labels)) != len(labels):
        logging.info("\nThe attribute file contains multiple values for the "
                     "same labels. Their values will be averaged.")
        table = _group_mean(table)

    if node_label_order is None or len(node_label_order) == 0:
        node_label_order = list(table.labels)

    node_label_in_file = table.labels
    known_labels = set(node_label_order)
    node_label_not_mapped = [x for x in node_label_in_file
                             if x is None or x not in known_labels]

    table = _reindex(table, node_label_order, fill_value)
    dts = table.dtypes()
    dt = (dts[0] if dts and all(d == dts[0] for d in dts)
          and dts[0] in (np.float32, np.float64) else np.float64)
    values = (np.stack([c.astype(dt) for c in table.columns], axis=1)
              if table.columns else np.zeros((len(node_label_order), 0), dt))

    if mask_duplicates:
        rng = np.random.default_rng() if rng is None else rng
        idx = rng.permutation(np.arange(len(values)))
        seen: set = set()
        mask_dups = np.zeros(len(idx), bool)
        for k, i in enumerate(idx):
            lab = node_label_order[i]
            mask_dups[k] = lab in seen
            seen.add(lab)
        num_dups = int(mask_dups.sum())
        logging.info("\nThe network contains %d nodes with duplicate labels. "
                     "Only one random node per label will be considered. "
                     "The attribute values of all other nodes will be set to "
                     "NaN." % num_dups)
        if num_dups:
            if values.dtype.kind != "f":
                values = values.astype(np.float64)
            values[idx[mask_dups], :] = np.nan

    if verbose:
        logging.info("\nAttribute data provided: %d labels x %d attributes"
                     % (len(node_label_in_file), len(attributes["name"])))
        n_show = min(len(node_label_not_mapped), 3)
        if n_show > 0:
            m = len(node_label_not_mapped) - n_show
            shown = [np.nan if x is None else x
                     for x in node_label_not_mapped[:n_show]]
            logging.info(", ".join(map(str, shown))
                         + " and %d other labels in the attribute file were "
                           "not found in the network." % m)
        n_mapped = len(node_label_in_file) - len(node_label_not_mapped)
        logging.info("\nAttribute data mapped onto the network: %d labels x "
                     "%d attributes" % (n_mapped, len(attributes["name"])))
        finite = ~np.isnan(values)
        logging.info("Values: %d NaNs" % int(np.sum(~finite)))
        logging.info("Values: %d zeros" % int(np.sum(values[finite] == 0)))
        logging.info("Values: %d positives" % int(np.sum(values[finite] > 0)))
        logging.info("Values: %d negatives" % int(np.sum(values[finite] < 0)))

    return attributes, node_label_order, values
