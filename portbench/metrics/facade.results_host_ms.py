"""facade.results_host_ms (ms, program span): host time per analysis of
every ``facade.results`` span, the materialisation of an (n, A) result's
f64 host matrix when ``SAFE.nes`` or ``SAFE.nes_binary`` is first read
(the download and the widening cast; the benchmark's own copies after it
are not in it). From the profiled sessions of device ops alone
(``portbench.spans``); nothing from a program without the span."""

from portbench import spans


def read(ctx):
    return spans.read(("facade.results",), "host_ms")
