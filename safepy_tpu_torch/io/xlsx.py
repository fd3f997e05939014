"""A dependency-free reader of one .xlsx worksheet.

Port of ``safepy_tpu/io/xlsx.py:36-135`` without pandas. The published
Costanzo-2016 cluster table that the plot overlay reads ships as an Excel
workbook (reference ``safe_io.py:549-551``); an .xlsx file is a zip of
SpreadsheetML parts, and the subset SAFE needs (one sheet chosen by name,
shared and inline strings, numbers, booleans, blanks) is read here with
``zipfile`` and ``xml.etree``, by JAX's rules:

- the first row is the header (a blank header cell is ``Unnamed: j``);
- a cell's ``r=`` reference places it, and a row's ``r=`` index places the
  row: rows a writer left out read as all-NaN rows;
- a relationship target may be rooted (``/xl/...``) or relative to ``xl/``;
- numbers read as int where integral (below 2^53), else float.

:func:`read_xlsx` returns the port's column table, a dict of the columns
by header name as :mod:`.table` types them: int64 where every cell is an
int, float64 where every cell is a number or blank (NaN), bool where every
cell is a boolean, else an object array with NaN for blanks. Repeated
header names take pandas' ``.1``, ``.2`` suffixes (:func:`.table.dedup_header`).
"""

from __future__ import annotations

import zipfile
import xml.etree.ElementTree as ET

import numpy as np

from safepy_tpu_torch.io.table import dedup_header

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_REL_NS = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships}")
_PKG_REL_NS = ("{http://schemas.openxmlformats.org/package/2006/"
               "relationships}")


def _cell_column(ref: str) -> int:
    """'BC12' -> 0-based column index 54."""
    col = 0
    for ch in ref:
        if not ch.isalpha():
            break
        col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
    return col - 1


def _shared_strings(zf: zipfile.ZipFile) -> list[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    # plain <t> or rich-text runs <r><t>: every text node, concatenated
    return ["".join(t.text or "" for t in si.iter(f"{_NS}t"))
            for si in ET.fromstring(data).iter(f"{_NS}si")]


def _sheet_path(zf: zipfile.ZipFile, sheet_name: str) -> str:
    wb = ET.fromstring(zf.read("xl/workbook.xml"))
    rid = None
    for sheet in wb.iter(f"{_NS}sheet"):
        if sheet.get("name") == sheet_name:
            rid = sheet.get(f"{_REL_NS}id")
            break
    if rid is None:
        names = [s.get("name") for s in wb.iter(f"{_NS}sheet")]
        raise ValueError(f"sheet {sheet_name!r} not in workbook "
                         f"(sheets: {names})")
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    for rel in rels.iter(f"{_PKG_REL_NS}Relationship"):
        if rel.get("Id") == rid:
            target = rel.get("Target")
            if target.startswith("/"):
                return target.lstrip("/")
            return target if target.startswith("xl/") else "xl/" + target
    raise ValueError(f"workbook relationship {rid!r} missing")


def _cell_value(c, strings):
    t = c.get("t", "n")
    if t == "inlineStr":
        return "".join(x.text or "" for x in c.iter(f"{_NS}t"))
    v = c.find(f"{_NS}v")
    if v is None or v.text is None:
        return np.nan
    if t == "s":
        return strings[int(v.text)]
    if t == "str":  # a formula's cached result
        return v.text
    if t == "b":
        return bool(int(v.text))
    try:
        f = float(v.text)
    except ValueError:  # a malformed numeric cell keeps its text
        return v.text
    return int(f) if f.is_integer() and abs(f) < 2 ** 53 else f


def _column(values: list) -> np.ndarray:
    """One column as a DataFrame built from these Python values types it."""
    def is_num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    if values and all(isinstance(v, bool) for v in values):
        return np.array(values, dtype=bool)
    if values and all(isinstance(v, int) and not isinstance(v, bool)
                      for v in values):
        return np.array(values, dtype=np.int64)
    if all(is_num(v) for v in values):
        return np.array(values, dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def read_xlsx(path, sheet_name: str) -> dict:
    """One worksheet as the port's column table, the first row as the
    header (``xlsx.py:102-135``)."""
    with zipfile.ZipFile(path) as zf:
        strings = _shared_strings(zf)
        root = ET.fromstring(zf.read(_sheet_path(zf, sheet_name)))
        rows: list[dict[int, object]] = []
        width = 0
        auto_row = 0
        for row in root.iter(f"{_NS}row"):
            r_attr = row.get("r")
            r_idx = int(r_attr) - 1 if r_attr else auto_row
            while len(rows) < r_idx:
                rows.append({})
            auto_row = r_idx + 1
            cells: dict[int, object] = {}
            auto_col = 0
            for c in row.iter(f"{_NS}c"):
                ref = c.get("r")
                col = _cell_column(ref) if ref else auto_col
                auto_col = col + 1
                cells[col] = _cell_value(c, strings)
            rows.append(cells)
            if cells:
                width = max(width, max(cells) + 1)
    if not rows:
        return {}
    grid = [[r.get(j, np.nan) for j in range(width)] for r in rows]
    header = [str(h) if not (isinstance(h, float) and np.isnan(h))
              else f"Unnamed: {j}" for j, h in enumerate(grid[0])]
    return {name: _column([r[j] for r in grid[1:]])
            for j, name in enumerate(dedup_header(header))}
