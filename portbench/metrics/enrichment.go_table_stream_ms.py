"""enrichment.go_table_stream_ms (ms, program span): stream time per
analysis of every ``enrichment.go_table`` span, between the two CUDA events
it records at its entry and exit; near its host time where the host paces
the slot loop. From the profiled sessions of device ops alone
(``portbench.spans``); nothing from a program without the span."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.go_table",), "stream_ms")
