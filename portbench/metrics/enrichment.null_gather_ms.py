"""enrichment.null_gather_ms (ms, program span): stream time per analysis
of every ``enrichment.permute`` span, one a chunk of permutations: the
index map, the gather of the permuted values and their padding. From the
profiled sessions of device ops alone (``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("enrichment.permute",), "stream_ms")
