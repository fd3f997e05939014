"""enrichment.null_count_ms (ms, program span): stream time per analysis
of every ``enrichment.count`` span, one a chunk of permutations: the
permuted scores' contraction and the two-sided compares and adds. From the
profiled sessions of device ops alone (``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.count",), "stream_ms")
