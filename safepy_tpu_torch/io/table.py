"""Tab-separated tables read as ``pandas.read_csv(sep="\\t")`` reads them,
without pandas.

The JAX package reads its attribute and scatter files with pandas
(``safepy_tpu/io/attributes.py:54-55``, ``io/network.py:287``); the card's
machine has no pandas, so the port parses them here with the rules those
calls apply, which decide the values and dtypes the analysis gets:

- the default NA strings (:data:`NA_STRINGS`) read as NaN in every column,
  the label column included;
- a column of integers is int64, one of numbers float64 (NaN where NA), and
  one holding any other string is text; a text column given to
  ``to_numeric(errors="coerce")`` turns its other strings to NaN;
- numbers are parsed by pandas' C parser (:func:`parse_float`): at most 17
  significant digits are accumulated, then scaled by one power of ten, which
  is not always the correctly rounded value Python's ``float`` gives;
- ``to_numeric(downcast="float")`` keeps a column float32 when its float32
  copy is within 5e-4 of it (``maybe_downcast_numeric``), else float64;
- duplicate header names take pandas' ``.1``, ``.2`` suffixes and empty ones
  ``Unnamed: i``.
"""

from __future__ import annotations

import csv
import gzip
import io as _io
import re

import numpy as np

#: pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))

# cell classes
NA, INT, FLOAT, TEXT = 0, 1, 2, 3

_SPACE = " \t\n\v\f\r"
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?)(\d{1,17}))?")
_INF = re.compile(r"([+-]?)(?:inf|infinity)", re.IGNORECASE)
_POW10 = [float(f"1e{i}") for i in range(309)]
_MAX_DIGITS = 17


def parse_float(s: str):
    """The float pandas' C parser reads from ``s`` (its
    ``precise_xstrtod``), or None where it reads no number."""
    t = s.strip(_SPACE)
    m = _INF.fullmatch(t)
    if m:
        return -np.inf if m.group(1) == "-" else np.inf
    m = _FLOAT.fullmatch(t)
    if m is None:
        return None
    sign, whole, frac, esign, edigits = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    if frac is not None:
        taken = 0
        for ch in frac:
            if digits >= _MAX_DIGITS:
                break
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
            taken += 1
        exponent -= taken
    if digits == 0:
        return None
    if sign == "-":
        number = -number
    if edigits:
        exponent += -int(edigits) if esign == "-" else int(edigits)
    if exponent > 308:
        return np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def classify(s: str):
    """(class, value, integer value) of one cell: NA, INT, FLOAT or TEXT;
    the value pandas reads in a float column (NaN for NA and TEXT), and
    for INT the exact integer it reads in an integer column (they differ
    past 17 digits)."""
    if s in NA_STRINGS:
        return NA, np.nan, np.nan
    v = parse_float(s)
    if v is None:
        return TEXT, np.nan, np.nan
    t = s.strip(_SPACE)
    if _INT.fullmatch(t) and -2 ** 63 <= int(t) < 2 ** 63:
        return INT, v, float(int(t))
    return FLOAT, v, v


def dedup_header(names: list[str]) -> list[str]:
    """pandas' header names: empty ones become ``Unnamed: i``, repeats take
    the first free ``.1``, ``.2`` suffix (``parsers.pyx`` ``_get_header``)."""
    header = [n if n != "" else f"Unnamed: {i}" for i, n in enumerate(names)]
    counts: dict[str, int] = {}
    for i, col in enumerate(header):
        old = col
        cur = counts.get(col, 0)
        if cur > 0:
            while cur > 0:
                counts[old] = cur + 1
                col = f"{old}.{cur}"
                cur = cur + 1 if col in header else counts.get(col, 0)
            header[i] = col
        counts[col] = cur + 1
    return header


def read_rows(filename: str) -> list[list[str]]:
    """The tab-separated rows of a text file (``.gz`` read transparently),
    blank lines skipped; quoted fields are read as the csv module reads
    them."""
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt", encoding="utf-8", newline="") as fh:
        text = fh.read()
    if '"' in text:
        return [row for row in csv.reader(_io.StringIO(text), delimiter="\t")
                if row]
    return [line.split("\t") for line in text.replace("\r\n", "\n")
            .replace("\r", "\n").split("\n") if line]


def cells_matrix(rows: list[list[str]], first: int, width: int):
    """The cells ``first`` to ``width - 1`` of every row as (R, C) arrays:
    classes (int8) and, per column, the values pandas reads (f64): the
    integers of a column of integers, the parsed floats otherwise. A short
    row reads NA in its missing cells, a long one raises, as pandas does."""
    ncols = width - first
    nrows = len(rows)
    if any(len(r) > width for r in rows):
        bad = next(i for i, r in enumerate(rows) if len(r) > width)
        raise ValueError(f"Expected {width} fields in data row {bad + 1}, "
                         f"saw {len(rows[bad])}")
    flat = []
    for r in rows:
        flat.extend(r[first:])
        if len(r) < width:
            flat.extend([""] * (width - max(len(r), first)))
    index = {s: i for i, s in enumerate(dict.fromkeys(flat))}
    parsed = np.array([classify(s) for s in index], np.float64).reshape(-1, 3)
    idx = np.fromiter(map(index.__getitem__, flat), np.int64,
                      count=len(flat)).reshape(nrows, ncols)
    cls = parsed[:, 0].astype(np.int8)[idx]
    vals = parsed[:, 1][idx]
    ints = np.all(cls == INT, axis=0) & (nrows > 0)
    vals[:, ints] = parsed[:, 2][idx[:, ints]]
    return cls, vals


def column_dtype(cls: np.ndarray):
    """The dtype ``read_csv`` gives a column of cell classes: 'int64',
    'float64' or 'text' (an all-NA column reads float64)."""
    if (cls == TEXT).any():
        return "text"
    if len(cls) and (cls == INT).all():
        return "int64"
    return "float64"


def downcast_float(values: np.ndarray) -> np.dtype:
    """The float dtype ``to_numeric(downcast="float")`` leaves a numeric
    column in: float32 when its float32 copy is within 5e-4 of every value,
    else float64. (An int64 column beyond 2^53 that pandas keeps int64 ends
    as float64 in the attribute matrix all the same.)"""
    with np.errstate(over="ignore", invalid="ignore"):
        f32 = values.astype(np.float32)
        if np.allclose(f32, values, equal_nan=True, rtol=0.0, atol=5e-4):
            return np.dtype(np.float32)
    return np.dtype(np.float64)


def infer_column(strings: list[str]):
    """A column as ``read_csv`` infers it: an int64 or float64 array, or an
    object array of its strings with NaN for NA."""
    parsed = [classify(s) for s in strings]
    cls = np.array([c for c, _, _ in parsed], np.int8)
    kind = column_dtype(cls)
    if kind == "int64":
        return np.array([int(s) for s in strings], np.int64)
    if kind == "float64":
        return np.array([v for _, v, _ in parsed], np.float64)
    return np.array([np.nan if c == NA else s
                     for (c, _, _), s in zip(parsed, strings)], dtype=object)
