"""The (n, A) results' f64 host matrices on the CPU:
``transfer.download_f64`` is bitwise numpy's ``astype(np.float64)`` of
f32 and int8 matrices (NaN payloads, infinities, signed zeros,
subnormals), fresh and owned by the caller whatever the shape, also in a
process forked after a download; and ``SAFE.nes`` and ``SAFE.nes_binary``
of a GO session are the old cast's arrays bitwise, each analysis's its
own."""

import os
import signal
import time

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE, transfer
from safepy_tpu_torch.io.graph_arrays import edge_lengths

BLOCK_ROWS = 3
# f32 bit patterns the widening must carry over: quiet NaNs with payloads
# and both signs, infinities, signed zeros, subnormals, 1 +/- 1 ulp
F32_BITS = np.array([0x7FC00000, 0x7FC00001, 0xFFC12345, 0x7FFFFFFF,
                     0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                     0x00000001, 0x007FFFFF, 0x80000001, 0x3F800001,
                     0x3F7FFFFF, 0x3F800000, 0x40490FDB], np.uint32)


def _block(monkeypatch, cols, rows=BLOCK_ROWS):
    """Blocks of ``rows`` rows at ``cols`` columns."""
    monkeypatch.setattr(transfer, "_BLOCK_ELEMS", rows * cols)
    assert transfer._block_rows(cols) == rows


def _f32(shape, seed=0):
    bits = np.random.default_rng(seed).choice(F32_BITS, shape)
    return bits.astype(np.uint32).view(np.float32)


def _i8(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) < 0.3).astype(np.int8)


def _same_bits(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


SHAPES = {"ragged": (10, 7), "one-block": (3, 7), "one-row": (1, 7),
          "one-column": (10, 1), "empty": (0, 7)}


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("held", ["numpy", "tensor"])
def test_download_is_the_host_cast(monkeypatch, kind, shape, held):
    """Bitwise ``astype(np.float64)`` (compared as int64 bits) from a
    numpy matrix or a CPU tensor, with blocks of 3 rows."""
    n, a = SHAPES[shape]
    _block(monkeypatch, a)
    m = _f32((n, a)) if kind == "f32" else _i8((n, a))
    x = torch.from_numpy(m) if held == "tensor" else m
    with np.errstate(invalid="ignore"):
        want = m.astype(np.float64)
    _same_bits(transfer.download_f64(x), want)


def test_special_values_survive():
    """Each planted bit pattern widens to the f64 that numpy's cast
    gives: payloads and signs of NaNs, -0.0, the smallest subnormal."""
    m = F32_BITS.view(np.float32).reshape(1, -1)
    with np.errstate(invalid="ignore"):
        want = m.astype(np.float64)
        got = transfer.download_f64(torch.from_numpy(m.copy()))
    _same_bits(got, want)
    assert np.signbit(got[0, 7]) and got[0, 7] == 0
    assert got[0, 8] == np.float64(np.float32(1e-45)) > 0
    assert len({int(b) for b in got[0, :4].view(np.int64)}) == 4


def test_result_is_fresh_and_owned():
    """Writable, C-contiguous, owning its memory, and shared with neither
    the source nor an earlier result."""
    m = _f32((17, 5))
    x = torch.from_numpy(m)
    first = transfer.download_f64(x)
    second = transfer.download_f64(x)
    for out in (first, second):
        assert out.flags.writeable and out.flags.c_contiguous
        assert out.flags.owndata and out.base is None
    first[:] = 7.0
    assert not np.shares_memory(first, second)
    with np.errstate(invalid="ignore"):
        _same_bits(second, m.astype(np.float64))


def test_strided_sources():
    """A transposed tensor and a column-sliced numpy view widen as numpy
    casts them."""
    m = _f32((9, 12))
    for x, want in ((torch.from_numpy(m).t(), m.T), (m[:, ::3], m[:, ::3])):
        with np.errstate(invalid="ignore"):
            _same_bits(transfer.download_f64(x), want.astype(np.float64))


@pytest.fixture
def pool_of(monkeypatch):
    """A widening pool of the given threads, made for the test (64 cores
    offered) and shut down after it."""
    def make(threads):
        monkeypatch.setattr(transfer, "_widen_pool", None)
        monkeypatch.setattr(transfer, "_WIDEN_THREADS_MAX", threads)
        monkeypatch.setattr(transfer.os, "sched_getaffinity",
                            lambda pid: set(range(64)), raising=False)
        assert transfer._widen_threads()[0] == threads
    yield make
    if transfer._widen_pool is not None:
        transfer._widen_pool[1].shutdown(wait=True)


def test_many_threads_many_slices(pool_of):
    """More widening threads than rows, and more rows than threads: every
    row is written once (a pool of 5 threads made for the test)."""
    pool_of(5)
    for n in (1, 3, 5, 6, 101):
        m = _i8((n, 3), seed=n)
        _same_bits(transfer.download_f64(m), m.astype(np.float64))


def _exit_code(pid, seconds=30.0):
    """The exit code of the child ``pid``; the test fails (and the child
    is killed) if it has not ended within ``seconds``."""
    deadline = time.monotonic() + seconds
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            return os.waitstatus_to_exitcode(status)
        if time.monotonic() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            pytest.fail(f"the forked child hung for {seconds} s")
        time.sleep(0.01)


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
@pytest.mark.parametrize("held", ["numpy", "tensor"])
def test_a_forked_child_widens_with_threads_of_its_own(pool_of, held):
    """Downloads in this process start the widening threads and leave
    them idle; a child forked after them has none of them, and its own
    download (4 slices) makes a pool of its own instead of handing the
    slices to the parent's threads and waiting forever, and widens
    bitwise."""
    pool_of(4)
    m = _f32((64, 9), seed=7)
    with np.errstate(invalid="ignore"):
        want = m.astype(np.float64)
    for _ in range(8):
        _same_bits(transfer.download_f64(m), want)
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            fresh = transfer._widen_pool is None
            got = transfer.download_f64(
                torch.from_numpy(m) if held == "tensor" else m)
            same = np.array_equal(got.view(np.int64), want.view(np.int64))
            code = 0 if fresh and same else 2
        finally:
            os._exit(code)
    assert _exit_code(pid) == 0


# --- the properties of a GO session -------------------------------------


def _network(n=240, k=7, seed=3):
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
    """A band-storage GO session on the CPU, one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    net = _network()
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    yield sf, len(net[0])
    torch.set_num_threads(threads)


def _whole(sf):
    """The old cast's arrays of the session's device results."""
    return (sf._nes_device().cpu().numpy().astype(np.float64),
            sf._nes_binary_dev.cpu().numpy().astype(float))


@pytest.mark.parametrize("threads", [1, 4])
def test_properties_are_the_whole_cast(band_go, pool_of, threads):
    """``sf.nes`` and ``sf.nes_binary`` equal the old cast's arrays
    bitwise, widened on one thread (one slice) and on four."""
    sf, n = band_go
    pool_of(threads)
    sf.load_attributes(attribute_file=_go(n))
    sf.run_pipeline()
    assert sf._hypergeom_engine_used == "table-band"
    want_nes, want_bin = _whole(sf)
    _same_bits(sf.nes, want_nes)
    _same_bits(sf.nes_binary, want_bin)
    assert sf.nes is sf.nes and sf.nes_binary is sf.nes_binary  # made once
    assert np.nansum(want_bin) > 0


def test_indicator_from_its_host_download(band_go):
    """Where the domain stage's int8 download exists, ``nes_binary``
    widens it (no new device read), bitwise."""
    sf, n = band_go
    sf.load_attributes(attribute_file=_go(n))
    sf.run_pipeline()
    i8 = sf._nes_binary_small()
    assert i8.dtype == np.int8 and sf._nes_binary_i8_np is i8
    want = i8.astype(float)
    sf._nes_binary_dev = None
    _same_bits(sf.nes_binary, want)


def test_second_analysis_leaves_the_first_arrays(band_go):
    """The arrays read after one analysis are the caller's: a second
    analysis of another matrix gives new arrays and changes none of the
    first's values."""
    sf, n = band_go
    sf.load_attributes(attribute_file=_go(n, seed=4))
    sf.run_pipeline()
    nes1, bin1 = sf.nes, sf.nes_binary
    kept = nes1.copy(), bin1.copy()
    sf.load_attributes(attribute_file=_go(n, seed=5))
    sf.run_pipeline()
    nes2, bin2 = sf.nes, sf.nes_binary
    assert nes2 is not nes1 and bin2 is not bin1
    assert not np.shares_memory(nes1, nes2)
    assert not np.shares_memory(bin1, bin2)
    _same_bits(nes1, kept[0])
    _same_bits(bin1, kept[1])
    assert not np.array_equal(nes1, nes2, equal_nan=True)
