"""The readers of ``enrichment.go_table_kernel_builds``,
``enrichment.go_table_roofline_pct`` and ``kernels.logsf_table_roofline_pct``
on synthetic span records and profiled spans: kernel-built class tables per
analysis, and the tables' HBM write floor over their spans' stream time and
over the kernel's device time; nothing without analyses, without table
spans, or where the spans lack ``route`` (an older program), a stream time
(no card) or the kernel (a program that builds the table otherwise)."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec, trace, work

CELL = dict(R=256, S_max=256, C=256)
CELL_BYTES = 4 * 256 * 256 * 256


def _records(tables, analyses=2, stream_ms=0.05):
    """Span records of ``analyses`` analyses (a ``facade.run_pipeline`` root
    each) holding one ``enrichment.go_table`` span for each attrs dict of
    ``tables`` (an empty list: none), each of ``stream_ms``."""
    recs, nid = [], 1
    for a in range(analyses):
        root, t0 = nid, a * 10 ** 8
        recs.append(dict(name="facade.run_pipeline", id=root, parent=None,
                         root=root, attrs={}, start_ns=t0,
                         end_ns=t0 + 9 * 10 ** 7, host_ms=90.0,
                         self_host_ms=5.0, stream_ms=None))
        for k, attrs in enumerate(tables):
            nid += 1
            recs.append(dict(name="enrichment.go_table", id=nid, parent=root,
                             root=root, attrs=dict(attrs),
                             start_ns=t0 + (k + 1) * 10 ** 6,
                             end_ns=t0 + (k + 1) * 10 ** 6 + 10 ** 5,
                             host_ms=0.1, self_host_ms=0.1,
                             stream_ms=stream_ms))
        nid += 1
    return recs


@pytest.fixture
def program(monkeypatch):
    """Make ``spans.records`` return the records given."""
    def give(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return give


def _read(name, ctx=None):
    return spec.reader(name)(ctx or SimpleNamespace())


@pytest.mark.parametrize("routes,want", [
    (["cuda"] * 9, 9.0), (["torch"] * 9, 0.0), (["cuda", "torch"], 1.0),
    ([None] * 9, None)],
    ids=["kernel", "loop", "both", "no-route"])
def test_kernel_builds_per_analysis(program, routes, want):
    program(_records([dict(CELL) if r is None else dict(CELL, route=r)
                      for r in routes]))
    assert _read("enrichment.go_table_kernel_builds") == want


@pytest.mark.parametrize("recs", [
    [], _records([dict(CELL, route="cuda")], analyses=0),
    _records([], analyses=3)],
    ids=["no-spans", "no-analyses", "no-table-spans"])
def test_kernel_builds_read_nothing_without_tables(program, recs):
    program(recs)
    assert _read("enrichment.go_table_kernel_builds") is None


def test_roofline_is_the_write_floor_over_stream_time(program):
    """9 tables of the cell's geometry at 1 ms each: 100 x 67.1 MB at
    3.35 TB/s (20.03 us) over 1 ms, whatever ``route`` says."""
    for route in ("cuda", "torch"):
        program(_records([dict(CELL, route=route)] * 9, stream_ms=1.0))
        want = 100.0 * CELL_BYTES / work.HBM_BYTES_PER_S / 1e-3
        assert _read("enrichment.go_table_roofline_pct") == pytest.approx(
            want, rel=1e-12)
        assert 2.0 < want < 2.01


def test_roofline_mixes_geometries_by_their_bytes(program):
    recs = _records([CELL, dict(R=128, S_max=64, C=1)], stream_ms=2.0)
    program(recs)
    nbytes = CELL_BYTES + 4 * 128 * 64
    want = 100.0 * nbytes / work.HBM_BYTES_PER_S / 4e-3
    assert _read("enrichment.go_table_roofline_pct") == pytest.approx(want,
                                                                   rel=1e-12)


def test_roofline_reads_100_at_the_byte_floor(program):
    floor_ms = 1e3 * CELL_BYTES / work.HBM_BYTES_PER_S
    program(_records([dict(CELL, route="cuda")], stream_ms=floor_ms))
    assert _read("enrichment.go_table_roofline_pct") == pytest.approx(
        100.0, rel=1e-12)


@pytest.mark.parametrize("recs", [
    [], _records([CELL], analyses=0), _records([], analyses=2),
    _records([CELL], stream_ms=None), _records([dict(R=256, C=256)]),
    _records([CELL], stream_ms=0.0)],
    ids=["no-spans", "no-analyses", "no-table-spans", "no-stream-time",
         "no-S_max", "zero-stream-time"])
def test_roofline_reads_nothing_it_cannot_bound(program, recs):
    program(recs)
    assert _read("enrichment.go_table_roofline_pct") is None


def _profiled(kernel_s, analyses=2, name="void (anonymous namespace)::"
              "logsf_table_kernel(float*, double const*, int, int, long, "
              "double, double, float, float)"):
    """A context of three profiled spans of ``analyses`` analyses, each
    holding table kernels of ``kernel_s`` seconds in all (the first span
    losing one event, as a dropped profiler event does) and a torch kernel
    beside them."""
    out = []
    for k in range(3):
        events = [(name, 0.0, kernel_s / 2), (name, kernel_s / 2, kernel_s),
                  ("vectorized_elementwise_kernel", 2.0, 2.5)]
        out.append(trace.Span(wall_s=3.0, analyses=analyses,
                              device=events[1:] if k == 0 else events))
    return SimpleNamespace(spans=out)


def test_kernel_roofline_is_the_write_floor_over_the_kernels_time(program):
    """9 tables of the cell's geometry an analysis, the kernel 1 ms an
    analysis: 100 x 9 x 67.1 MB at 3.35 TB/s over 1 ms, from the span with
    the most kernel time."""
    program(_records([dict(CELL, route="cuda")] * 9))
    want = 100.0 * 9 * CELL_BYTES / work.HBM_BYTES_PER_S / 1e-3
    got = _read("kernels.logsf_table_roofline_pct", _profiled(2e-3))
    assert got == pytest.approx(want, rel=1e-12) and 18.0 < want < 18.1


def test_kernel_roofline_reads_100_at_the_byte_floor(program):
    program(_records([dict(CELL, route="cuda")]))
    floor_s = 2 * CELL_BYTES / work.HBM_BYTES_PER_S  # two analyses
    assert _read("kernels.logsf_table_roofline_pct",
                 _profiled(floor_s)) == pytest.approx(100.0, rel=1e-12)


@pytest.mark.parametrize("recs,ctx", [
    ([], _profiled(1e-3)),
    (_records([CELL], analyses=0), _profiled(1e-3)),
    (_records([], analyses=2), _profiled(1e-3)),
    (_records([dict(R=256, C=256)]), _profiled(1e-3)),
    (_records([CELL]), _profiled(1e-3, name="minplus_product_kernel")),
    (_records([CELL]), SimpleNamespace(spans=[]))],
    ids=["no-spans", "no-analyses", "no-table-spans", "no-S_max",
         "no-kernel", "no-profile"])
def test_kernel_roofline_reads_nothing_it_cannot_bound(program, recs, ctx):
    program(recs)
    assert _read("kernels.logsf_table_roofline_pct", ctx) is None
