"""enrichment.device_ms (ms, device trace): device time per analysis of
every kernel, copy and set that is not a ``csrc/minplus.cu`` kernel: the
null (gathers, the score contractions, the count scans), and with it the
neighborhoods' initialization, threshold and stats and the uploads and
downloads, a few percent in these cells. Of the three profiled spans, the
largest reading."""

from portbench import trace


def read(ctx):
    per = [s.device_s(lambda name: not trace.is_minplus(name)) / s.analyses
           for s in ctx.spans]
    if not per or max(per) <= 0:
        return None
    return 1e3 * max(per)
