"""enrichment.dense_count_ms (ms, program span): stream time per analysis
of the ``enrichment.count`` spans whose attr ``route`` reads ``dense``, one
a chunk of permutations: the dense null's (N, V) x (V, chunk) contraction
and the two-sided compares and adds (``ops.permutation.scan_counts``), from
the profiled sessions of device ops alone (``portbench.spans``). A program
whose count spans carry no ``route`` attr, a band null, or a run without
stream times (no card) gives nothing."""

from portbench import spans

COUNT = "enrichment.count"


def dense_count_ms(recs):
    """Stream ms per analysis of the dense count spans in ``recs``; None
    without analyses, without such spans, or where one has no stream
    time."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    counts = [r["stream_ms"] for r in recs if r["name"] == COUNT
              and r["attrs"].get("route") == "dense"]
    if not runs or not counts or any(ms is None for ms in counts):
        return None
    return sum(counts) / runs


def read(ctx):
    recs = spans.records()
    return dense_count_ms(spans.device_records(recs)) if recs else None
