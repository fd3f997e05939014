"""Stage-level checkpoints: a session as an .npz of arrays and a JSON sidecar.

Port of ``safepy_tpu/checkpoint.py:37-133``, writing and reading the same
files, so that a checkpoint made by either package loads in the other:

- ``<path>.npz``: the neighborhoods (int8) and distances (f32), or for a
  band-stored session that cannot be dense (``BandedMatrix.dense_ok``) the
  bands themselves (``neighborhoods_band`` in its own dtype: int8, or
  uint8 when bit-packed, LSB-first; ``band_rank``, ``band_meta`` = (n,
  band, block); ``node_distances_band`` f32), then ``node2attribute``,
  ``ns``, ``pvalues_neg``, ``pvalues_pos``, ``nes`` and ``nes_binary`` as
  the public properties give them;
- ``<path>.meta.json``: ``{"settings": {...}}`` and the ``attributes``,
  ``node2domain`` and ``domains`` tables, each a string holding what
  pandas' ``DataFrame.to_json(orient="split")`` writes
  (``{"columns", "index", "data"}``), written and read here without
  pandas: floats as its encoder writes them (ten decimals, ``%.10g`` past
  1e16 and below 1e-15), NaN as ``null``, ``/`` escaped. ``node2domain``'s
  columns are the domain ids, then ``primary_domain`` and
  ``primary_nes``; ``domains`` is indexed by domain id. Read back, floats
  parse as ``read_json`` parses them (not always correctly rounded), and a
  float column whose values are all integral becomes int64, as it coerces
  them.

The .npz members are deflated at zlib level 1, where numpy's
``savez_compressed`` takes level 6: the same format, which ``np.load``
reads in either package, written several times faster from float
statistics, which deflate little at any level.

The graph is not stored (it has its own file, ``SAFE.save_network``): pass
it to :func:`load_session` to resume the stages that read it. A loaded
session's arrays are on the host; a stage that needs the device uploads
what it reads (a band once, on its first use).
"""

from __future__ import annotations

import json
import math
import zipfile

import numpy as np

from safepy_tpu_torch.domains import NodeDomains
from safepy_tpu_torch.io.record import NetworkRecord
from safepy_tpu_torch.ops.apsp_bandstore import BandedMatrix, _host

_SETTINGS = [
    "node_key_attribute", "attribute_sign", "node_distance_metric",
    "neighborhood_radius_type", "neighborhood_radius", "background",
    "num_permutations", "multiple_testing", "neighborhood_score_type",
    "enrichment_type", "enrichment_threshold", "enrichment_max_log10",
    "attribute_enrichment_min_size", "random_seed",
    "attribute_unimodality_metric", "attribute_distance_metric",
    "attribute_distance_threshold", "output_dir",
]

_ARRAYS = ["node2attribute", "ns", "pvalues_neg", "pvalues_pos", "nes",
           "nes_binary"]

# ---------------------------------------------------------------------------
# pandas' orient="split" JSON, without pandas
# ---------------------------------------------------------------------------


def _json_float(v: float) -> str:
    """A float as pandas' vendored ujson writes it at its default
    ``double_precision`` of 10 (``Buffer_AppendDoubleUnchecked``)."""
    v = float(v)
    if v != v or v in (np.inf, -np.inf):
        return "null"
    neg = v < 0
    x = -v if neg else v
    if x > 1e16 - 1 or (x != 0.0 and x < 1e-15):
        return "%.10g" % v
    if x.is_integer():
        whole, frac = int(x), 0
    else:
        whole = int(x)
        tmp = (x - whole) * 1e10
        frac = int(tmp)
        diff = tmp - frac
        if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
            frac += 1
        if frac >= 10 ** 10:
            frac, whole = 0, whole + 1
    if frac:
        count = 10
        while frac % 10 == 0:
            count -= 1
            frac //= 10
        text = f"{whole}.{str(frac).rjust(count, '0')}"
    else:
        text = f"{whole}.0"
    return "-" + text if neg else text


def _json_value(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return _json_float(v)
    if isinstance(v, str):
        return json.dumps(v).replace("/", "\\/")
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_json_value(x) for x in v) + "]"
    return json.dumps(str(v)).replace("/", "\\/")  # default_handler=str


def _json_cells(values) -> list[str]:
    arr = values if isinstance(values, np.ndarray) else None
    if arr is not None and arr.dtype.kind == "f":
        return [_json_float(x) for x in arr.tolist()]
    if arr is not None and arr.dtype.kind in "iub":
        return [_json_value(x) for x in arr.tolist()]
    return [_json_value(x) for x in values]


def split_json(columns: dict, index) -> str:
    """``{"columns", "index", "data"}`` of a table of named columns, as
    ``DataFrame.to_json(orient="split", default_handler=str)`` writes it."""
    cells = [_json_cells(col) for col in columns.values()]
    rows = ",".join("[" + ",".join(r) + "]" for r in zip(*cells))
    return ('{"columns":[' + ",".join(_json_value(c) for c in columns)
            + '],"index":[' + ",".join(_json_cells(np.asarray(index)))
            + '],"data":[' + rows + "]}")


def _column(values: list):
    """A JSON column as the port holds it: bool, int64 or float64 arrays
    (an integral float column without null as int64, as ``read_json``
    coerces it), an object array of int64 arrays for a column of lists,
    else a list (null as NaN)."""
    present = [v for v in values if v is not None]
    if values and len(present) == len(values):
        if all(isinstance(v, bool) for v in values):
            return np.array(values, dtype=bool)
        if all(isinstance(v, int) and not isinstance(v, bool)
               for v in values):
            return np.array(values, dtype=np.int64)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in present):
        arr = np.array([np.nan if v is None else v for v in values],
                       dtype=np.float64)
        if len(arr) and not np.isnan(arr).any() \
                and np.array_equal(arr, np.floor(arr)):
            return arr.astype(np.int64)
        return arr
    if present and all(isinstance(v, list) for v in present):
        out = np.empty(len(values), dtype=object)
        out[:] = [np.nan if v is None else np.asarray(v) for v in values]
        return out
    return [np.nan if v is None else v for v in values]


_DECIMALS = [1.0, 0.1, 0.01, 0.001, 0.0001, 1e-05, 1e-06, 1e-07, 1e-08,
             1e-09, 1e-10, 1e-11, 1e-12, 1e-13, 1e-14, 1e-15]


def _ujson_float(text: str) -> float:
    """A JSON float as pandas' ``read_json`` reads it (its vendored ujson
    decoder without ``precise_float``, ``decode_numeric``): the integer
    part, plus at most 15 fraction digits accumulated in a double and
    scaled by one power of ten, times ``pow(10, exponent)``; not always
    the correctly rounded value ``float`` gives."""
    neg = text.startswith("-")
    mantissa, _, exponent = text.lstrip("-").replace("E", "e").partition("e")
    whole, _, digits = mantissa.partition(".")
    frac = 0.0
    for ch in digits[:15]:
        frac = frac * 10.0 + (ord(ch) - 48)
    value = ((float(int(whole)) if whole else 0.0)
             + frac * _DECIMALS[min(len(digits), 15)])
    if neg:
        value = -value
    if exponent:
        value = value * math.pow(10.0, float(int(exponent)))
    return value


def read_split_json(text: str):
    """(columns, index) of a split-JSON table: ``{label: column}`` by
    :func:`_column`, and the index as a list; floats as ``read_json``
    reads them (:func:`_ujson_float`)."""
    table = json.loads(text, parse_float=_ujson_float)
    data = table["data"]
    columns = {c: _column([row[j] for row in data])
               for j, c in enumerate(table["columns"])}
    return columns, table["index"]


def _attributes_json(attributes: dict) -> str:
    n = len(attributes["name"])
    return split_json(attributes, np.arange(n))


def _node2domain_json(n2d: NodeDomains) -> str:
    columns = {int(d): n2d.counts[:, i] for i, d in enumerate(n2d.domains)}
    columns["primary_domain"] = np.asarray(n2d.primary_domain)
    columns["primary_nes"] = np.asarray(n2d.primary_nes, np.float64)
    return split_json(columns, np.arange(len(n2d.primary_domain)))


def _domains_json(domains: dict) -> str:
    return split_json(domains, np.asarray(domains["id"]))


def _node2domain_from(text: str) -> NodeDomains:
    columns, _ = read_split_json(text)
    ids = [c for c in columns if not isinstance(c, str)]
    n = len(columns["primary_domain"])
    counts = (np.stack([np.asarray(columns[d], np.float64) for d in ids],
                       axis=1) if ids else np.zeros((n, 0)))
    return NodeDomains(np.asarray(ids, np.int64), counts,
                       np.asarray(columns["primary_domain"], np.int64),
                       np.asarray(columns["primary_nes"], np.float64))


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------


def _savez(path: str, arrays: dict) -> None:
    """``np.savez_compressed``'s file, its members deflated at level 1."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as zf:
        for name, value in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value),
                                          allow_pickle=False)


def _json_default(o):
    return o.item() if isinstance(o, np.generic) else str(o)


def save_session(sf, path: str) -> None:
    """Write ``<path>.npz`` and ``<path>.meta.json`` (``checkpoint.py:37-87``).
    A band-stored session that cannot be dense writes its O(N W) bands, in
    their own dtypes."""
    arrays = {}
    nbr_dev = sf._neighborhoods_dev
    if isinstance(nbr_dev, BandedMatrix) and not nbr_dev.dense_ok():
        band = _host(nbr_dev.data)
        arrays["neighborhoods_band"] = (
            band if band.dtype == np.uint8
            else band.astype(np.int8, copy=False))
        arrays["band_rank"] = np.asarray(nbr_dev.rank, dtype=np.int64)
        arrays["band_meta"] = np.asarray(
            [nbr_dev.n, nbr_dev.band, nbr_dev.block], dtype=np.int64)
        nd_dev = sf._node_distances_dev
        if isinstance(nd_dev, BandedMatrix):
            arrays["node_distances_band"] = _host(nd_dev.data).astype(
                np.float32, copy=False)
    else:
        nbr = sf.neighborhoods
        if nbr is not None:
            arrays["neighborhoods"] = np.asarray(nbr, dtype=np.int8)
        nd = sf.node_distances
        if nd is not None:
            arrays["node_distances"] = np.asarray(nd, dtype=np.float32)
    for name in _ARRAYS:
        val = getattr(sf, name)
        if val is not None:
            arrays[name] = np.asarray(val)

    _savez(path + ".npz", arrays)

    meta = {"settings": {k: getattr(sf, k) for k in _SETTINGS}}
    if sf.attributes is not None:
        meta["attributes"] = _attributes_json(sf.attributes)
    if sf.node2domain is not None:
        meta["node2domain"] = _node2domain_json(sf.node2domain)
    if sf.domains is not None:
        meta["domains"] = _domains_json(sf.domains)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, default=_json_default)


def load_session(path: str, graph=None, verbose: bool = True, *,
                 device="cuda"):
    """A session rebuilt from :func:`save_session`'s files, of either
    package, on ``device`` (``checkpoint.py:90-133``). ``graph`` (a
    :class:`~safepy_tpu_torch.io.NetworkRecord` or a networkx graph with
    nodes 0..N-1) re-enables the stages that read the network."""
    from safepy_tpu_torch.safe import SAFE

    sf = SAFE(verbose=verbose, device=device)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    for k, v in meta["settings"].items():
        setattr(sf, k, v)

    data = np.load(path + ".npz", allow_pickle=False)
    if "neighborhoods_band" in data:
        n, band, block = (int(x) for x in data["band_meta"])
        rank = data["band_rank"]
        # the band stays in its dtype and on the host until a stage needs
        # it on the device (SAFE._band_device)
        sf._neighborhoods_dev = BandedMatrix(
            data["neighborhoods_band"], rank, n, band, block, fill=0.0)
        sf._neighborhoods_np = None
        sf._num_nodes = n
        if "node_distances_band" in data:
            sf._node_distances_dev = BandedMatrix(
                data["node_distances_band"], rank, n, band, block,
                fill=np.inf)
            sf._node_distances_np = None
    if "neighborhoods" in data:
        sf.neighborhoods = data["neighborhoods"].astype(int)
    if "node_distances" in data:
        sf.node_distances = data["node_distances"].astype(np.float64)
    for name in _ARRAYS:
        if name in data:
            setattr(sf, name, data[name])
    if sf.node2attribute is not None:
        sf._num_nodes = sf.node2attribute.shape[0]

    if "attributes" in meta:
        sf.attributes, _ = read_split_json(meta["attributes"])
    if "node2domain" in meta:
        sf.node2domain = _node2domain_from(meta["node2domain"])
    if "domains" in meta:
        sf.domains, _ = read_split_json(meta["domains"])

    if graph is not None:
        if not isinstance(graph, NetworkRecord):
            graph = NetworkRecord.from_networkx(graph)
        sf.graph = graph
        sf._graph_arrays = None
        sf._num_nodes = graph.num_nodes
    return sf
