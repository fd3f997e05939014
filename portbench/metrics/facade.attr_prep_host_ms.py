"""facade.attr_prep_host_ms (ms, program span): host time per analysis of
every ``facade.attr_prep`` span, the attribute matrix's one preparation an
attribute load (the f32 device matrix and its count of values that are not
0 or 1, or that count alone from column chunks or on the host). From the
profiled sessions of device ops alone (``portbench.spans``); nothing from
a program without the span."""

from portbench import spans


def read(ctx):
    return spans.read(("facade.attr_prep",), "host_ms")
