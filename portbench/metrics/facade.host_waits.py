"""facade.host_waits (waits, program span): ``facade.wait`` spans per
analysis, each a place where the host blocks on the device's results (the
downloads of the scores and null counts); a count, which repeats exactly.
From the profiled sessions of device ops alone (``portbench.spans``)."""

from portbench import spans


def read(ctx):
    return spans.read(("facade.wait",), None)
