"""enrichment.go_tail_stream_ms (ms, program span): stream time per
analysis of every ``enrichment.go_tail`` span: the f64 hypergeometric tail
loop over the (neighborhood, term) cells (``ops.hypergeom._sf_parts``) and
its device finalization (``finalize_logsf_device``), between each span's
two CUDA events, from the profiled sessions of device ops alone
(``portbench.spans``). Nothing without such spans (the class-table engines,
or a program without them) or without stream times (no card)."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.go_tail",), "stream_ms")
