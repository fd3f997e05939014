"""The readers of ``facade.attr_prep_host_ms`` and ``facade.attr_uploads``
on synthetic span records: the host time of every ``facade.attr_prep``
span and the spans whose ``route`` reads ``upload``, per analysis (a
``facade.run_pipeline`` root); nothing without analyses, without prep
spans, or where the spans lack ``route`` (an older program)."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec


def _records(preps, analyses=2, host_ms=120.0):
    """Span records of ``analyses`` analyses, each holding one
    ``facade.attr_prep`` span of ``host_ms`` for each attrs dict of
    ``preps`` (an empty list: none)."""
    recs, nid = [], 1
    for a in range(analyses):
        root, t0 = nid, a * 10 ** 8
        recs.append(dict(name="facade.run_pipeline", id=root, parent=None,
                         root=root, attrs={}, start_ns=t0,
                         end_ns=t0 + 9 * 10 ** 7, host_ms=900.0,
                         self_host_ms=5.0, stream_ms=None))
        for k, attrs in enumerate(preps):
            nid += 1
            recs.append(dict(name="facade.attr_prep", id=nid, parent=root,
                             root=root, attrs=dict(attrs),
                             start_ns=t0 + (k + 1) * 10 ** 6,
                             end_ns=t0 + (k + 1) * 10 ** 6 + 10 ** 5,
                             host_ms=host_ms, self_host_ms=host_ms,
                             stream_ms=None))
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


@pytest.mark.parametrize("routes,want", [
    (["upload"], 1.0), (["chunked"], 0.0), (["host"], 0.0),
    (["upload", "chunked"], 1.0), ([None], None)],
    ids=["upload", "chunked", "host", "two-preps", "no-route"])
def test_uploads_per_analysis(program, routes, want):
    program(_records([{} if r is None else dict(route=r) for r in routes]))
    assert _read("facade.attr_uploads") == want


def test_uploads_divide_by_the_analyses(program):
    """A prep on the first of four analyses (the later ones reuse it):
    0.25 a analysis."""
    recs = _records([dict(route="upload")], analyses=1) + [
        dict(r, id=r["id"] + 100, root=r["root"] + 100)
        for r in _records([], analyses=3)]
    program(recs)
    assert _read("facade.attr_uploads") == pytest.approx(0.25)


@pytest.mark.parametrize("route", ["upload", "chunked", "host"])
def test_host_ms_sums_every_prep_per_analysis(program, route):
    program(_records([dict(route=route)] * 2, analyses=4, host_ms=60.0))
    assert _read("facade.attr_prep_host_ms") == pytest.approx(120.0)


@pytest.mark.parametrize("recs", [
    [], _records([dict(route="upload")], analyses=0),
    _records([], analyses=3)],
    ids=["no-spans", "no-analyses", "no-prep-spans"])
@pytest.mark.parametrize("name", ["facade.attr_uploads",
                                  "facade.attr_prep_host_ms"])
def test_nothing_without_preps(program, recs, name):
    program(recs)
    assert _read(name) is None
