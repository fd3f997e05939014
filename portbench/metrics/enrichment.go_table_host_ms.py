"""enrichment.go_table_host_ms (ms, program span): host time per analysis
of every ``enrichment.go_table`` span, one class-table build
(``build_logsf_table``) a column chunk: the host's enqueue of its slot
loop. From the profiled sessions of device ops alone (``portbench.spans``);
nothing from a program without the span."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.go_table",), "host_ms")
