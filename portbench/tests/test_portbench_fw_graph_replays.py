"""The reader of ``neighborhoods.fw_graph_replays`` on synthetic span records:
replayed relax spans per analysis, and nothing from a program whose relax
spans carry no ``graph`` attr."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec


def _relax_records(modes, analyses=2):
    """Span records of ``analyses`` analyses (a ``facade.run_pipeline`` root
    each) and one ``neighborhoods.relax`` each with attr ``graph`` from
    ``modes`` in turn (None: no attr, as an older program leaves)."""
    recs = []
    for a in range(analyses):
        root = 10 * a + 1
        mode = modes[a % len(modes)]
        recs.append(dict(name="facade.run_pipeline", id=root, parent=None,
                         root=root, attrs={}, start_ns=a * 10 ** 8,
                         end_ns=a * 10 ** 8 + 9 * 10 ** 7, host_ms=90.0,
                         self_host_ms=5.0, stream_ms=None))
        recs.append(dict(name="neighborhoods.relax", id=root + 1,
                         parent=root, root=root,
                         attrs={} if mode is None else {"graph": mode},
                         start_ns=a * 10 ** 8 + 10 ** 6,
                         end_ns=a * 10 ** 8 + 2 * 10 ** 6, host_ms=1.0,
                         self_host_ms=1.0, stream_ms=15.0))
    return recs


@pytest.mark.parametrize("modes,want", [
    (["replay"], 1.0), (["capture", "replay"], 0.5), (["eager"], 0.0),
    (["eager", "capture"], 0.0), ([None], None)],
    ids=["replay", "capture-then-replay", "eager", "eager-then-capture",
         "no-attr"])
def test_fw_graph_replays(monkeypatch, modes, want):
    """Replayed relax spans per analysis: 1 where every analysis replays,
    0 where the rounds ran eagerly or were captured, nothing from a program
    whose relax spans carry no ``graph`` attr, or without spans at all."""
    read = spec.reader("neighborhoods.fw_graph_replays")
    monkeypatch.setattr(spans, "records", lambda: _relax_records(modes, 4))
    assert read(SimpleNamespace()) == want
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read(SimpleNamespace()) is None
