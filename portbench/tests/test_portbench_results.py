"""The reader of ``facade.results_host_ms`` on synthetic span records: the
host time of every ``facade.results`` span (a root of its own, opened
when the benchmark reads ``sf.nes`` and ``sf.nes_binary`` after an
analysis), per analysis (a ``facade.run_pipeline`` root); nothing without
analyses or without result spans (an older program)."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec


def _records(results, analyses=2, host_ms=80.0):
    """Span records of ``analyses`` analyses, each a ``facade.run_pipeline``
    root followed by one ``facade.results`` root of ``host_ms`` for each
    name in ``results`` (an empty list: none)."""
    recs, nid = [], 1
    for a in range(analyses):
        t0 = a * 10 ** 8
        recs.append(dict(name="facade.run_pipeline", id=nid, parent=None,
                         root=nid, attrs={}, start_ns=t0,
                         end_ns=t0 + 5 * 10 ** 7, host_ms=50.0,
                         self_host_ms=5.0, stream_ms=None))
        for k, name in enumerate(results):
            nid += 1
            s = t0 + 5 * 10 ** 7 + k * 2 * 10 ** 7
            recs.append(dict(name="facade.results", id=nid, parent=None,
                             root=nid, attrs=dict(name=name), start_ns=s,
                             end_ns=s + 10 ** 7, host_ms=host_ms,
                             self_host_ms=host_ms, stream_ms=None))
        nid += 1
    return recs


BOTH = ["nes", "nes_binary"]


@pytest.fixture
def program(monkeypatch):
    """Make ``spans.records`` return the records given."""
    def give(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return give


def _read():
    return spec.reader("facade.results_host_ms")(SimpleNamespace())


@pytest.mark.parametrize("results,want", [(BOTH, 120.0), (["nes"], 60.0),
                                          (["nes_binary"], 60.0)],
                         ids=["both", "nes", "nes_binary"])
def test_host_ms_sums_every_result_per_analysis(program, results, want):
    program(_records(results, analyses=4, host_ms=60.0))
    assert _read() == pytest.approx(want)


def test_host_ms_divides_by_the_analyses(program):
    """Results read after one analysis of four: a quarter of their time
    an analysis."""
    recs = _records(BOTH, analyses=1) + [
        dict(r, id=r["id"] + 100, root=r["root"] + 100,
             start_ns=r["start_ns"] + 10 ** 8, end_ns=r["end_ns"] + 10 ** 8)
        for r in _records([], analyses=3)]
    program(recs)
    assert _read() == pytest.approx(40.0)


@pytest.mark.parametrize("recs", [
    [], _records(["nes"], analyses=0), _records([], analyses=3)],
    ids=["no-spans", "no-analyses", "no-result-spans"])
def test_nothing_without_results(program, recs):
    program(recs)
    assert _read() is None
