"""neighborhoods.window_relax_host_ms (ms, program span): host time per
analysis of the ``neighborhoods.relax`` spans whose attr ``engine`` reads
``window``: the host's enqueue of the banded-window FW's rounds (one
``relax_panel``, ``relax_window_sym`` and ``close_diag`` a pivot block),
from the profiled sessions of device ops alone (``portbench.spans``). A
program whose relax spans carry no ``engine`` attr, or a run of another
engine, gives nothing."""

from portbench import spans

RELAX = "neighborhoods.relax"


def window_relax_ms(recs):
    """Host ms per analysis of the window engine's relax spans in
    ``recs``; None without analyses or without such spans."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    relax = [r["host_ms"] for r in recs if r["name"] == RELAX
             and r["attrs"].get("engine") == "window"]
    if not runs or not relax:
        return None
    return sum(relax) / runs


def read(ctx):
    recs = spans.records()
    return window_relax_ms(spans.device_records(recs)) if recs else None
