"""analyses_per_s (analyses/s, host clock): the analyses the window
completed over the time from its start to the last completion: all the
work over all the time."""


def read(ctx):
    return len(ctx.ends) / ctx.ends[-1]
