"""neighborhoods.relax_host_ms (ms, program span): host time per analysis
of the ``neighborhoods.relax`` span: the enqueue of the FW rounds (or the
Bellman-Ford relax). From the profiled sessions of device ops alone
(``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("neighborhoods.relax",), "host_ms")
