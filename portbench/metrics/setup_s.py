"""setup_s (s, host clock): from the process's start to the window's start:
imports, the CUDA context, the kernel library (built on a checkout's first
run), the inputs made from the seed, ``load_network`` and the warm-up
analyses."""


def read(ctx):
    return ctx.setup_s
