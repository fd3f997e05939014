"""kernels.fw_roofline_pct (%, device trace): the least time the FW of one
analysis needs on the card (``portbench.work``: the larger of its candidates
over the 16.75 T/s candidate peak and its bytes over 3.35 TB/s) over the
device time of the ``csrc/minplus.cu`` kernels per analysis in a profiled
span. Of the three spans, the one with the most kernel time (a dropped
profiler event only lowers a reading). Nothing when the span shows no such
kernel or the engine is not one whose work ``portbench.work`` counts."""

from portbench import trace, work


def fw_work(shapes):
    if shapes["engine"] == "banded-window":
        return work.window_fw_work(shapes["n"], shapes["window"],
                                   symmetric=shapes["symmetric"])
    if shapes["engine"] == "band-storage" and shapes["bt"]:
        return work.band_fw_work(shapes["n"], shapes["bt"],
                                 symmetric=shapes["symmetric"])
    return None


def read(ctx):
    need = fw_work(ctx.shapes)
    per = [s.device_s(trace.is_minplus) / s.analyses for s in ctx.spans]
    if need is None or not per or max(per) <= 0:
        return None
    least, _ = work.least_seconds(*need)
    return 100.0 * least / max(per)
