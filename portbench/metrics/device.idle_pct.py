"""device.idle_pct (%, device trace): 100 x (1 - the union of the device's
kernel, copy and set intervals over the wall time of the profiled
analyses). Of the three spans, the one whose device was busiest (a dropped
profiler event only raises the idle share)."""


def read(ctx):
    shares = [s.busy_s() / s.wall_s for s in ctx.spans if s.wall_s > 0]
    if not shares or max(shares) <= 0:
        return None
    return 100.0 * (1.0 - max(shares))
