"""The readers of the dense path's metrics on synthetic span records:
``neighborhoods.window_relax_host_ms`` (the window FW's relax, host),
``enrichment.dense_count_ms`` (the dense null's count chunks, stream),
``enrichment.go_tail_stream_ms``, ``enrichment.go_tail_iterations`` and
``enrichment.go_tail_roofline_pct`` (the f64 hypergeometric tail); each
reads nothing without analyses, without its spans, or where its spans lack
the attr that marks them (an older program) or a stream time (no card)."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec, work

TAIL_CELLS = 3971 * 4373


def _records(children, analyses=2):
    """Span records of ``analyses`` analyses (a ``facade.run_pipeline`` root
    each), each holding one span for each (name, attrs, host_ms,
    stream_ms) of ``children``."""
    recs, nid = [], 1
    for a in range(analyses):
        root, t0 = nid, a * 10 ** 8
        recs.append(dict(name="facade.run_pipeline", id=root, parent=None,
                         root=root, attrs={}, start_ns=t0,
                         end_ns=t0 + 9 * 10 ** 7, host_ms=90.0,
                         self_host_ms=5.0, stream_ms=None))
        for k, (name, attrs, host_ms, stream_ms) in enumerate(children):
            nid += 1
            recs.append(dict(name=name, id=nid, parent=root, root=root,
                             attrs=dict(attrs),
                             start_ns=t0 + (k + 1) * 10 ** 6,
                             end_ns=t0 + (k + 1) * 10 ** 6 + 10 ** 5,
                             host_ms=host_ms, self_host_ms=host_ms,
                             stream_ms=stream_ms))
        nid += 1
    return recs


@pytest.fixture
def program(monkeypatch):
    """Make ``spans.records`` return the records given."""
    def give(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return give


def _read(name):
    return spec.reader(name)(SimpleNamespace())


WINDOW = ("neighborhoods.relax", {"engine": "window", "rounds": 32}, 4.0, 6.0)
BAND = ("neighborhoods.relax", {"graph": "replay"}, 3.0, 15.0)
OLD_RELAX = ("neighborhoods.relax", {}, 4.0, 6.0)


@pytest.mark.parametrize("children,want", [
    ([WINDOW], 4.0), ([WINDOW, WINDOW], 8.0), ([WINDOW, BAND], 4.0),
    ([BAND], None), ([OLD_RELAX], None), ([], None)],
    ids=["window", "two-fronts", "beside-band", "band", "no-attr",
         "no-relax"])
def test_window_relax_host_ms(program, children, want):
    """Host ms per analysis of the relax spans whose ``engine`` reads
    ``window``; the band's and an older program's read nothing."""
    program(_records(children))
    assert _read("neighborhoods.window_relax_host_ms") == want


DENSE = ("enrichment.count", {"route": "dense"}, 2.0, 3.5)
BAND_COUNT = ("enrichment.count", {}, 2.0, 46.0)


@pytest.mark.parametrize("children,want", [
    ([DENSE] * 10, 35.0), ([DENSE, BAND_COUNT], 3.5), ([BAND_COUNT], None),
    ([("enrichment.count", {"route": "dense"}, 2.0, None)], None),
    ([("enrichment.permute", {"route": "dense"}, 2.0, 1.0)], None)],
    ids=["ten-chunks", "beside-band", "band", "no-card", "permute-only"])
def test_dense_count_ms(program, children, want):
    """Stream ms per analysis of the count spans whose ``route`` reads
    ``dense``; nothing from the band null's, without stream times, or from
    the gather spans."""
    program(_records(children))
    got = _read("enrichment.dense_count_ms")
    assert got == (None if want is None else pytest.approx(want))


def _tail(iterations=40, stream_ms=80.0, cells=TAIL_CELLS, bound=151):
    attrs = dict(cells=cells, bound=bound)
    if iterations is not None:
        attrs["iterations"] = iterations
    return ("enrichment.go_tail", attrs, 90.0, stream_ms)


def test_go_tail_stream_ms_and_iterations(program):
    program(_records([_tail(40, 80.0), _tail(12, 20.0)], analyses=3))
    assert _read("enrichment.go_tail_stream_ms") == pytest.approx(100.0)
    assert _read("enrichment.go_tail_iterations") == 52.0


@pytest.mark.parametrize("recs", [
    [], _records([_tail()], analyses=0), _records([DENSE]),
    _records([_tail(stream_ms=None)])],
    ids=["no-spans", "no-analyses", "no-tail", "no-card"])
def test_go_tail_stream_ms_reads_nothing(program, recs):
    program(recs)
    assert _read("enrichment.go_tail_stream_ms") is None


def test_go_tail_iterations_need_the_attr(program):
    """A tail span without ``iterations`` (an older program) reads nothing;
    the count needs no card."""
    program(_records([_tail(), _tail(iterations=None)]))
    assert _read("enrichment.go_tail_iterations") is None
    program(_records([_tail(iterations=7, stream_ms=None)]))
    assert _read("enrichment.go_tail_iterations") == 7.0
    program(_records([DENSE]))
    assert _read("enrichment.go_tail_iterations") is None


def test_go_tail_roofline_is_the_byte_floor_over_stream_time(program):
    """Example_2's 17.4M cells at 13 bytes (226 MB) at 3.35 TB/s, 67.4 us,
    over a tail of 80 ms: 0.0843%, whatever ``iterations`` reads."""
    floor_s = 13 * TAIL_CELLS / work.HBM_BYTES_PER_S
    for iterations in (40, 151, None):
        program(_records([_tail(iterations, 80.0)]))
        got = _read("enrichment.go_tail_roofline_pct")
        assert got == pytest.approx(100.0 * floor_s / 80e-3, rel=1e-12)
    assert floor_s == pytest.approx(67.41e-6, rel=1e-3)
    # two tails an analysis: the floors and the times add up
    program(_records([_tail(stream_ms=30.0, cells=1000),
                      _tail(stream_ms=10.0, cells=3000)]))
    assert _read("enrichment.go_tail_roofline_pct") == pytest.approx(
        100.0 * 13 * 4000 / work.HBM_BYTES_PER_S / 40e-3, rel=1e-12)
    # at the floor itself, 100%
    program(_records([_tail(stream_ms=1e3 * floor_s)]))
    assert _read("enrichment.go_tail_roofline_pct") == pytest.approx(100.0)


@pytest.mark.parametrize("recs", [
    [], _records([_tail()], analyses=0), _records([DENSE]),
    _records([_tail(stream_ms=None)]), _records([_tail(stream_ms=0.0)]),
    _records([("enrichment.go_tail", {"bound": 151}, 9.0, 80.0)])],
    ids=["no-spans", "no-analyses", "no-tail", "no-card", "zero-time",
         "no-cells"])
def test_go_tail_roofline_reads_nothing(program, recs):
    program(recs)
    assert _read("enrichment.go_tail_roofline_pct") is None
