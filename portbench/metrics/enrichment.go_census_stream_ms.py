"""enrichment.go_census_stream_ms (ms, program span): stream time per
analysis of every ``enrichment.go_census`` span of the class-table GO
engine: the neighborhood sizes' banded contraction and each column chunk's
banded census. From the profiled sessions of device ops alone
(``portbench.spans``); nothing from a program without the span."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.go_census",), "stream_ms")
