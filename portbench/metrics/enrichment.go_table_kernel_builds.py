"""enrichment.go_table_kernel_builds (tables/analysis, program span):
``enrichment.go_table`` spans per analysis whose class table the
hand-written CUDA kernel built (attr ``route`` = ``cuda``; the torch slot
loop reads ``torch``), from the profiled sessions of device ops alone
(``portbench.spans``). A program whose table spans carry no ``route`` attr
gives nothing."""

from portbench import spans

TABLE = "enrichment.go_table"


def kernel_builds(recs):
    """Kernel-built table spans per analysis in ``recs``; None without
    analyses, without table spans, or where none has a ``route`` attr."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tables = [r["attrs"] for r in recs if r["name"] == TABLE]
    if not runs or not any("route" in a for a in tables):
        return None
    return sum(a.get("route") == "cuda" for a in tables) / runs


def read(ctx):
    recs = spans.records()
    return kernel_builds(spans.device_records(recs)) if recs else None
