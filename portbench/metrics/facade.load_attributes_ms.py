"""facade.load_attributes_ms (ms, host clock): the mean time of the
benchmark's ``SAFE.load_attributes`` call over every analysis of the
traced window."""


def read(ctx):
    if not ctx.load_s:
        return None
    return 1e3 * sum(ctx.load_s) / len(ctx.load_s)
