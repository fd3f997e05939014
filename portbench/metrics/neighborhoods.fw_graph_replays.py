"""neighborhoods.fw_graph_replays (replays/analysis, program span):
``neighborhoods.relax`` spans per analysis whose FW rounds ran as the replay
of a CUDA graph captured before (attr ``graph`` = ``replay``; the others
read ``eager`` or ``capture``), from the profiled sessions of device ops
alone (``portbench.spans``). A program whose relax spans carry no ``graph``
attr gives nothing."""

from portbench import spans

RELAX = "neighborhoods.relax"


def replays(recs):
    """Replayed relax spans per analysis in ``recs``; None without
    analyses or where no relax span has a ``graph`` attr."""
    runs = sum(1 for r in recs if r["name"] == spans.RUN and r["parent"] is None)
    relax = [r for r in recs if r["name"] == RELAX]
    if not runs or not any("graph" in r["attrs"] for r in relax):
        return None
    return sum(r["attrs"].get("graph") == "replay" for r in relax) / runs


def read(ctx):
    recs = spans.records()
    return replays(spans.device_records(recs)) if recs else None
