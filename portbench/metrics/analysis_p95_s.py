"""analysis_p95_s (s, host clock): the 95th percentile (linear
interpolation between order statistics) of the wall time of every analysis
the window completed."""

import numpy as np


def read(ctx):
    walls = np.asarray(ctx.ends) - np.asarray(ctx.starts)
    return float(np.percentile(walls, 95))
