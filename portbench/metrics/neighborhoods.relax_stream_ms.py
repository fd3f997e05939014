"""neighborhoods.relax_stream_ms (ms, program span): stream time per
analysis of the ``neighborhoods.relax`` span, between the two CUDA events
it records on the current stream at its entry and exit; near its host time
where the host paces the rounds. From the profiled sessions of device ops
alone (``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("neighborhoods.relax",), "stream_ms")
