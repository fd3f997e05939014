"""enrichment.go_tail_roofline_pct (%, program span): the least time the
hypergeometric tail of an analysis needs on the card, its cells' bytes at
3.35 TB/s, as a share of the stream time of the ``enrichment.go_tail``
spans (between each span's two CUDA events), from the profiled sessions of
device ops alone (``portbench.spans``).

The floor counts what the cells' operands and results need, 13 bytes a
cell (the attr ``cells`` of each span): the count read (4 bytes: int32 or
integer f32), and the NES (f32), the log survival (f32) and the call
(int8) written once. The neighborhood sizes and term totals are a row and
a column, and the f64 temporaries are the implementation's: neither
counts. So the share reads the same work whatever computes the tail, and no
implementation can pass 100%. Nothing without tail spans, where one lacks
``cells`` or a stream time, or where the stream time is 0."""

from portbench import spans, work

TAIL = "enrichment.go_tail"
BYTES_PER_CELL = 4 + 4 + 4 + 1


def floor_seconds(cells: int) -> float:
    """The least seconds ``cells`` tail cells need at the HBM peak."""
    return BYTES_PER_CELL * cells / work.HBM_BYTES_PER_S


def roofline(recs):
    """100 x the tail's byte floor over its stream time in ``recs``; None
    without analyses, without tail spans, where one lacks ``cells`` or a
    stream time, or where the stream time is 0."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tails = [r for r in recs if r["name"] == TAIL]
    if not runs or not tails or any(
            "cells" not in r["attrs"] or r["stream_ms"] is None
            for r in tails):
        return None
    spent_s = sum(r["stream_ms"] for r in tails) / 1e3
    if spent_s <= 0:
        return None
    least = sum(floor_seconds(r["attrs"]["cells"]) for r in tails)
    return 100.0 * least / spent_s


def read(ctx):
    recs = spans.records()
    return roofline(spans.device_records(recs)) if recs else None
