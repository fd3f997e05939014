"""facade.attr_uploads (preps/analysis, program span): ``facade.attr_prep``
spans per analysis whose attr ``route`` reads ``upload``, where the f32
attribute matrix was made on the card from one f64 transfer and kept there
(``chunked``: counted from column chunks; ``host``: counted on the host).
From the profiled sessions of device ops alone (``portbench.spans``). A
program without the span, or whose spans carry no ``route``, gives
nothing."""

from portbench import spans

PREP = "facade.attr_prep"


def uploads(recs):
    """Upload-route prep spans per analysis in ``recs``; None without
    analyses, without prep spans, or where none has a ``route`` attr."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    preps = [r["attrs"] for r in recs if r["name"] == PREP]
    if not runs or not any("route" in a for a in preps):
        return None
    return sum(a.get("route") == "upload" for a in preps) / runs


def read(ctx):
    recs = spans.records()
    return uploads(spans.device_records(recs)) if recs else None
