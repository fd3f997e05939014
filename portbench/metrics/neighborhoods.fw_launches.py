"""neighborhoods.fw_launches (launches, program counter): FW kernel launches
per analysis, from ``safepy_tpu_torch.ops.apsp_cuda.LAUNCHES`` reset before
each analysis (counted at the launch wrapper), mean over the traced
window's analyses; a count, which repeats exactly."""


def read(ctx):
    if not ctx.launches:
        return None
    return sum(sum(c.values()) for c in ctx.launches) / len(ctx.launches)
