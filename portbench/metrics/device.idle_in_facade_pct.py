"""device.idle_in_facade_pct (%, device trace): of the device's idle time
inside the analyses of the profiled session that recorded the host's ops,
the share while the host's innermost program span is a ``facade.*`` span
(``portbench.spans.idle_share``). Idle time outside every program span
counts in the whole alone."""

from portbench import spans


def read(ctx):
    return spans.idle_share(ctx.host_spans, "facade.")
