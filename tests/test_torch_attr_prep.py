"""The attribute matrix's preparation on the CPU: the f32 matrix that
``enrich_band.upload_f32_counted`` makes from f64 row blocks is bitwise
numpy's cast and its count is the host predicate's, whatever the layout
and wherever the blocks end; the facade makes it once an attribute load
and reuses it, and the span ``facade.attr_prep`` names the route that
counted the non-0/1 values (``upload``, ``chunked`` or ``host``)."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE, profiling
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import enrich_band as peb

F64_MAX = np.finfo(np.float64).max
# every case the f32 cast decides: zeros, ones, NaN, a value that rounds
# to 1, values past f32's range, f32 subnormals and values below them
PLANTED = np.array([0.0, 1.0, -0.0, np.nan, 0.5, 1 + 1e-9, 1 - 1e-9, 1e39,
                    -1e39, F64_MAX, np.inf, -np.inf, 1e-40, 1e-45, 3e-45,
                    1e-46, -1e-40, 0.1])
N_ROWS, N_COLS = 1001, 37
# rows a block at N_COLS columns: N_ROWS is no multiple of it
BLOCK_ROWS = 64


def _planted(seed=0):
    return np.random.default_rng(seed).choice(PLANTED, (N_ROWS, N_COLS))


def _read_only(m):
    m = m.copy()
    m.flags.writeable = False
    return m


LAYOUTS = {
    "C": lambda m: m,
    "fortran": np.asfortranarray,
    "strided": lambda m: m[:, ::2],
    "one-column": lambda m: m[:, :1],
    "one-column-contiguous": lambda m: np.ascontiguousarray(m[:, 3:4]),
    "read-only": _read_only,
    "reversed": lambda m: m[::-1, ::-1],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_upload_is_the_host_cast(monkeypatch, layout):
    """Bitwise ``np.asarray(m, np.float32)``, and the count of its finite
    values that are not 0 or 1, from blocks of BLOCK_ROWS rows at N_COLS
    columns (the last block short)."""
    monkeypatch.setattr(peb, "_GROUP_ELEMS", 4 * BLOCK_ROWS * N_COLS)
    m = LAYOUTS[layout](_planted())
    got, count = peb.upload_f32_counted(m, device="cpu")
    with np.errstate(over="ignore"):
        want = np.asarray(m, np.float32)
    assert got.dtype == torch.float32 and got.shape == m.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert count == np.count_nonzero(np.isfinite(want) & (want != 0)
                                     & (want != 1))
    got = got.numpy()
    for value, cast in ((1 + 1e-9, 1.0), (1e39, np.inf), (F64_MAX, np.inf),
                        (1e-46, 0.0)):
        assert np.all(got[m == value] == cast)
    for subnormal in (1e-40, 1e-45, 3e-45):  # kept, not flushed to 0
        hit = got[m == subnormal]
        assert np.all(hit == np.float32(subnormal)) and np.all(hit != 0)


def test_upload_counts_across_blocks(monkeypatch):
    """A value that is not 0 or 1 in each block, one in the short last
    block: every block's count reaches the total."""
    monkeypatch.setattr(peb, "_GROUP_ELEMS", 4 * BLOCK_ROWS * N_COLS)
    m = np.zeros((N_ROWS, N_COLS))
    m[::BLOCK_ROWS, 5] = 0.25
    m[-1, -1] = 7.0
    got, count = peb.upload_f32_counted(m, device="cpu")
    assert count == -(-N_ROWS // BLOCK_ROWS) + 1
    np.testing.assert_array_equal(got.numpy(), m.astype(np.float32))


def _network(n=300, k=7, seed=3):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def _go(n, terms=24, seed=4):
    rng = np.random.default_rng(seed)
    out = (rng.random((n, terms)) < 0.08).astype(float)
    out[rng.random(n) < 0.1] = np.nan
    return out


@pytest.fixture
def band_go():
    """A band-storage session and a binary matrix on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    net = _network()
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    yield sf, _go(len(net[0]))
    torch.set_num_threads(threads)


def test_one_transfer_an_attribute_load(band_go, monkeypatch):
    """The binary check uploads the matrix and the operand prep reads that
    upload: one transfer an analysis, none on a second ``run_pipeline`` of
    the same load, and a new one after a reload, which drops the cached
    matrix and count."""
    sf, go = band_go
    calls = []
    upload = peb.upload_f32_counted

    def counted(n2a_np, *, device):
        calls.append(n2a_np.shape)
        return upload(n2a_np, device=device)
    monkeypatch.setattr(peb, "upload_f32_counted", counted)
    monkeypatch.setattr(peb, "count_other_values_chunked", None)  # unused
    sf.load_attributes(attribute_file=go)
    sf.run_pipeline()
    assert sf._hypergeom_engine_used == "table-band"
    assert calls == [go.shape] and sf._num_other_cache == 0
    held = sf._n2a_dev
    first = np.array(sf.nes)
    sf.run_pipeline()
    assert calls == [go.shape] and sf._n2a_dev is held
    np.testing.assert_array_equal(np.array(sf.nes), first)
    sf.load_attributes(attribute_file=go)
    assert sf._n2a_dev is None and sf._num_other_cache is None
    sf.run_pipeline()
    assert calls == [go.shape] * 2
    np.testing.assert_array_equal(np.array(sf.nes), first)


@pytest.mark.parametrize("route", ["upload", "chunked", "host"])
def test_attr_prep_span_names_its_route(band_go, monkeypatch, tmp_path,
                                        route):
    """Without a mesh, the full-device prep's upload (the f32 matrix kept
    on the device) or, where the prep is chunked, the column-chunked count;
    on a mesh the host count. Each is one ``facade.attr_prep`` span, and
    each count is the host predicate's."""
    sf, go = band_go
    go = go.copy()
    go[::9, 2] = 0.5
    sf.load_attributes(attribute_file=go)
    if route == "chunked":
        monkeypatch.setattr(sf, "_prep_chunked_selected", lambda: True)
    if route == "host":
        monkeypatch.setattr(sf, "mesh", object())
    profiling.reset_spans()
    try:
        with profiling.trace(str(tmp_path / "tr")):
            count = sf._num_other_values()
            assert sf._num_other_values() == count  # cached: no new span
        recs = profiling.span_records()
    finally:
        profiling.reset_spans()
    assert [(r["name"], r["attrs"]) for r in recs] == [
        ("facade.attr_prep", {"route": route})]
    v = go.astype(np.float32)
    assert count == np.count_nonzero(np.isfinite(v) & (v != 0) & (v != 1))
    assert (sf._n2a_dev is not None) == (route == "upload")
