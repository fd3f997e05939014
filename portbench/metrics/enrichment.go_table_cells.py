"""enrichment.go_table_cells (cells/analysis, program span): the class
tables' cells built per analysis, the sum of R x S_max x C over the
``enrichment.go_table`` spans (their attrs: neighborhood sizes, count slots,
classes of one chunk's plan), from the profiled sessions of device ops
alone (``portbench.spans``). Nothing from a program without the span or
whose spans lack those attrs."""

from portbench import spans

TABLE = "enrichment.go_table"


def cells(recs):
    """Table cells per analysis in ``recs``; None without analyses, without
    table spans, or where one lacks R, S_max or C."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tables = [r["attrs"] for r in recs if r["name"] == TABLE]
    if not runs or not tables or any(
            k not in a for a in tables for k in ("R", "S_max", "C")):
        return None
    return sum(a["R"] * a["S_max"] * a["C"] for a in tables) / runs


def read(ctx):
    recs = spans.records()
    return cells(spans.device_records(recs)) if recs else None
