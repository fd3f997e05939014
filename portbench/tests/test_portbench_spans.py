"""The readers of the program's spans (``portbench.spans`` and the eight
metrics on it), on hand-built records and profiled sessions: the per-analysis
arithmetic over the right records, the device-only sessions told apart by
their gaps, idle time given to the innermost program span, and nothing read
where the program left no span."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec, trace

MS = 10 ** 6  # ns
SPAN_AT = ((0.2, False), (0.5, True), (0.8, False))


def analysis(t0_ms, first_id, *, relax=30.0, waits=3, stream=1.0):
    """The records of one analysis starting at ``t0_ms``: load_attributes
    (0.2 ms, a root), then run_pipeline (100 ms) over a front (40 ms, its
    relax ``relax`` ms), a null (45 ms: two chunks of a 2 ms gather and a
    20 ms count) and ``waits`` waits of 1 ms; stream times ``stream`` x
    host. Self host times as ``profiling.span_records`` gives them."""
    i = iter(range(first_id, first_id + 100))
    out = []

    def rec(name, parent, root, start, host, self_ms=None, **attrs):
        rid = next(i)
        out.append(dict(name=name, id=rid, parent=parent,
                        root=rid if root is None else root, attrs=attrs,
                        start_ns=int(start * MS),
                        end_ns=int((start + host) * MS), host_ms=host,
                        self_host_ms=host if self_ms is None else self_ms,
                        stream_ms=None if stream is None else stream * host))
        return rid

    rec("facade.load_attributes", None, None, t0_ms, 0.2)
    t = t0_ms + 0.5
    run = rec("facade.run_pipeline", None, None, t, 100.0,
              self_ms=100.0 - 40.0 - 45.0 - waits, engine="band-storage")
    front = rec("neighborhoods.front", run, run, t + 1, 40.0,
                self_ms=40.0 - relax)
    rec("neighborhoods.relax", front, run, t + 2, relax)
    null = rec("enrichment.null", run, run, t + 42, 45.0, self_ms=1.0)
    for k in range(2):
        rec("enrichment.permute", null, run, t + 43 + 22 * k, 2.0)
        rec("enrichment.count", null, run, t + 45 + 22 * k, 20.0)
    for k in range(waits):
        rec("facade.wait", run, run, t + 90 + k, 1.0, site=f"s{k}")
    return out


def three_sessions(per_session=2, gap_ms=5000.0):
    """Records of the harness's three profiled sessions: the middle one
    (host ops too) slower, and with one wait more, than the others."""
    recs, t, nid = [], 0.0, 1
    for k in range(3):
        for _ in range(per_session):
            host_ops = k == 1
            recs += analysis(t, nid, relax=60.0 if host_ops else 30.0,
                             waits=4 if host_ops else 3)
            nid += 100
            t += 101.0
        t += gap_ms
    return recs


@pytest.fixture
def program(monkeypatch):
    """Make ``spans.records`` return the records given."""
    def give(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return give


def ctx(host_spans=()):
    return SimpleNamespace(host_spans=list(host_spans), spans=[])


def test_sessions_are_told_apart_by_their_gaps():
    recs = three_sessions()
    parts = spans.sessions(recs)
    assert [len({r["root"] for r in p if r["parent"] is None}) for p in parts] \
        == [4, 4, 4]  # two analyses, two roots each
    chosen = spans.device_records(recs, SPAN_AT)
    assert {r["host_ms"] for r in chosen
            if r["name"] == "neighborhoods.relax"} == {30.0}
    # children follow their root into its session
    assert all(r["root"] in {c["id"] for c in chosen} for r in chosen)
    # sessions closer than the gap are one; the count then differs from
    # SPAN_AT's and every record is read
    close = three_sessions(gap_ms=10.0)
    assert len(spans.sessions(close)) == 1
    assert spans.device_records(close, SPAN_AT) == close


def test_harness_profiles_as_the_readers_assume(root):
    """Three sessions, the middle one with host ops, which start further
    apart than a session lasts (SPAN_SECONDS, or a few analyses past it)
    by many times the gap the readers split at."""
    import json

    from portbench import harness

    assert [host for _, host in harness.SPAN_AT] == [False, True, False]
    seconds = json.loads((root / "BENCHMARK.json").read_text())[
        "run_seconds"]
    apart = min(b - a for (a, _), (b, _) in zip(harness.SPAN_AT,
                                                harness.SPAN_AT[1:]))
    assert (apart * seconds - harness.SPAN_SECONDS) * 1e9 > 10 * spans.GAP_NS


def test_per_analysis_readers(program):
    program(three_sessions())
    # facade: load_attributes 0.2 + run_pipeline's own 100 - 40 - 45 - 3
    assert spec.reader("facade.self_host_ms")(ctx()) == pytest.approx(12.2)
    assert spec.reader("facade.host_waits")(ctx()) == 3
    assert spec.reader("neighborhoods.relax_host_ms")(ctx()) == \
        pytest.approx(30.0)
    assert spec.reader("neighborhoods.relax_stream_ms")(ctx()) == \
        pytest.approx(30.0)
    assert spec.reader("enrichment.null_gather_ms")(ctx()) == \
        pytest.approx(4.0)
    assert spec.reader("enrichment.null_count_ms")(ctx()) == \
        pytest.approx(40.0)


def test_stream_readers_need_every_stream_time(program):
    recs = three_sessions()
    recs[3]["stream_ms"] = None  # one relax without its events
    program(recs)
    assert spec.reader("neighborhoods.relax_stream_ms")(ctx()) is None
    assert spec.reader("neighborhoods.relax_host_ms")(ctx()) == \
        pytest.approx(30.0)


def host_session():
    """One session with host ops: two analyses over [0, 10] and [10, 20] s.
    Device busy [0, 1], [4, 6], [12, 13]; idle 1-4 and 6-10 in the first,
    10-12 and 13-20 in the second: 16 s in all."""
    s = trace.Span(20.0, 2, host_ops=True)
    s.device = [("k1", 0.0, 1.0), ("k2", 4.0, 6.0), ("k3", 12.0, 13.0)]
    s.host = [(trace.ANALYSIS, 0.0, 10.0), (trace.ANALYSIS, 10.0, 20.0),
              ("facade.run_pipeline", 0.5, 9.5),
              ("neighborhoods.front", 1.0, 5.0),
              ("neighborhoods.relax", 2.0, 4.5),
              ("aten::copy_", 2.5, 3.0),          # not a program span
              ("enrichment.null", 5.0, 8.0),
              ("facade.wait", 8.0, 9.0),
              ("facade.load_attributes", 10.0, 11.0),
              ("facade.run_pipeline", 11.0, 18.0),
              ("neighborhoods.relax", 11.5, 14.0)]
    return s


def test_idle_goes_to_the_innermost_program_span():
    total, by = spans.idle_by_layer(host_session())
    assert total == pytest.approx(16.0)
    # neighborhoods: 1-4 (front, relax), 11.5-12 and 13-14 (relax)
    assert by["neighborhoods."] == pytest.approx(4.5)
    # enrichment: 6-8 (null)
    assert by["enrichment."] == pytest.approx(2.0)
    # facade: 8-9.5 (wait, then run_pipeline), 10-11.5, 14-18
    assert by["facade."] == pytest.approx(7.0)
    # 9.5-10 and 18-20 lie in no program span: in the whole alone
    assert total - sum(by.values()) == pytest.approx(2.5)
    c = ctx([host_session()])
    n = spec.reader("device.idle_in_neighborhoods_pct")(c)
    f = spec.reader("device.idle_in_facade_pct")(c)
    assert n == pytest.approx(100 * 4.5 / 16)
    assert f == pytest.approx(100 * 7.0 / 16)
    assert n + f <= 100


def test_nothing_read_without_spans(program):
    program([])
    plain = host_session()
    plain.host = [h for h in plain.host
                  if not h[0].startswith(spans.LAYERS)]
    for name in ("facade.self_host_ms", "facade.host_waits",
                 "neighborhoods.relax_host_ms",
                 "neighborhoods.relax_stream_ms",
                 "enrichment.null_gather_ms", "enrichment.null_count_ms",
                 "device.idle_in_neighborhoods_pct",
                 "device.idle_in_facade_pct"):
        assert spec.reader(name)(ctx([plain])) is None, name
        assert spec.reader(name)(ctx()) is None, name


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """An older program: its profiling module has no span_records."""
    from safepy_tpu_torch import profiling

    monkeypatch.delattr(profiling, "span_records")
    assert spans.records() == []
    assert spec.reader("facade.host_waits")(ctx()) is None
