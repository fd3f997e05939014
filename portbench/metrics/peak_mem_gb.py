"""peak_mem_gb (GB, allocator): ``torch.cuda.max_memory_allocated()`` over
the window (the stats reset at its start), the session's residents
included, in 10^9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
