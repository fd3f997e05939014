"""enrichment.go_lookup_stream_ms (ms, program span): stream time per
analysis of every ``enrichment.go_lookup`` span: a column chunk's gather
from its class table, the rows' un-permute, the columns' placement into the
(n, A) outputs and the enriched counts. From the profiled sessions of
device ops alone (``portbench.spans``); nothing from a program without the
span."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.go_lookup",), "stream_ms")
