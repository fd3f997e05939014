"""Timing and tracing of the port's stages.

Port of ``safepy_tpu/profiling.py:23-73`` to torch:

- :class:`StageTimer` accumulates host seconds by named stage; a stage
  given ``sync=tensors`` synchronizes their CUDA devices before it stops
  the clock, so that asynchronous launches are not charged to the next
  stage (CPU tensors need no sync);
- :func:`trace` records a block with ``torch.profiler`` (CPU and, where
  there is a card, CUDA activity) and exports a Chrome trace into a
  directory, viewable in Perfetto or ``chrome://tracing``;
- :func:`log_compile_time` times a callable's first call (on the card it
  includes the nvcc build of ``native.py`` on first use) and a steady one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import OrderedDict

import torch


def synchronize(tensors) -> None:
    """Wait for the CUDA devices of ``tensors`` (a tensor, or nested tuples,
    lists and dict values of them); nothing for CPU tensors."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tensors)
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Host seconds by named stage (``profiling.py:23-53``)."""

    def __init__(self):
        self.stages = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, *, sync=None):
        """Time a stage; ``sync=tensors`` waits for their devices at its
        end."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self, logger=None) -> str:
        total = sum(self.stages.values())
        lines = [f"  {name}: {t:.3f}s ({100 * t / total:.0f}%)"
                 for name, t in self.stages.items()]
        text = "Stage timings (total %.3fs):\n%s" % (total, "\n".join(lines))
        (logger or logging).info(text)
        return text


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over a block, its Chrome trace written into
    ``log_dir`` as ``trace_<pid>_<n>.json`` at the block's end
    (``profiling.py:56-63``). Yields the profiler, whose
    ``key_averages()`` the caller may read; its ``trace_path`` attribute
    names the file once written."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(log_dir,
                                      f"trace_{os.getpid()}_{n}.json")):
        n += 1
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    prof.trace_path = path


def log_compile_time(fn, *args, label: str = "fn", **kwargs):
    """Run ``fn`` twice, each to completion on its device; log the first
    call's seconds (build and run) and the steady call's; return the
    steady result (``profiling.py:66-73``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(out)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(out)
    steady_s = time.perf_counter() - t0
    logging.info("%s: compile+run %.3fs, steady %.3fs", label, first_s,
                 steady_s)
    return out
