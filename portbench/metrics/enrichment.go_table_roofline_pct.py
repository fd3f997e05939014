"""enrichment.go_table_roofline_pct (%, program span): the least time the
class tables of an analysis need on the card, their f32 bytes written once
(4 x R x S_max x C of each ``enrichment.go_table`` span's attrs) over 3.35
TB/s, as a share of the stream time those spans take (between each span's
two CUDA events), from the profiled sessions of device ops alone
(``portbench.spans``). A share of the whole span: the chunk's ``K_dist``
upload counts with the build, and the spans' attrs and times alone are
read, so it reads the same whatever builds the table (the kernel's own
share is ``kernels.logsf_table_roofline_pct``). Nothing without table
spans, where one lacks R, S_max or C, or without stream times (no
card)."""

from portbench import spans, work

TABLE = "enrichment.go_table"


def roofline(recs):
    """100 x the tables' bytes at the HBM peak over their stream time in
    ``recs``; None without analyses, without table spans, where one lacks
    R, S_max, C or a stream time, or where the stream time is 0."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tables = [r for r in recs if r["name"] == TABLE]
    if not runs or not tables or any(
            k not in r["attrs"] for r in tables for k in ("R", "S_max", "C")
    ) or any(r["stream_ms"] is None for r in tables):
        return None
    spent_s = sum(r["stream_ms"] for r in tables) / 1e3
    if spent_s <= 0:
        return None
    nbytes = sum(4 * r["attrs"]["R"] * r["attrs"]["S_max"] * r["attrs"]["C"]
                 for r in tables)
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / spent_s


def read(ctx):
    recs = spans.records()
    return roofline(spans.device_records(recs)) if recs else None
