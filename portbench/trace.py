"""Spans of the steady window under ``torch.profiler``, and what is read
from them: device intervals by kernel name, their union, and the host's
ops during the device's idle gaps.

The kernels of ``safepy_tpu_torch/csrc/minplus.cu`` are matched by name
(``MINPLUS_KERNELS``); every other device event (kernels of torch and
cuBLAS, copies, sets) is the rest of the analysis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# the __global__ functions of csrc/minplus.cu that an FW round launches
MINPLUS_KERNELS = ("relax_panel_kernel", "relax_band_row_kernel",
                   "relax_skew_sym_kernel", "relax_skew_kernel",
                   "relax_window_sym_sub_kernel", "relax_window_sym_kernel",
                   "minplus_product_kernel", "relax_full_kernel",
                   "relax_full_banded_sub_kernel",
                   "relax_full_banded_whole_kernel", "close_diag_kernel")
ANALYSIS = "portbench.analysis"


def is_minplus(name: str) -> bool:
    return any(k in name for k in MINPLUS_KERNELS)


@dataclass
class Span:
    """One profiled run of whole analyses: its host wall (first start to
    last end, after a synchronize), the analyses in it, the device events
    (name, start_s, end_s) and the host ops (name, start_s, end_s), read
    from the profile by :meth:`read` once the window has closed."""
    wall_s: float
    analyses: int
    host_ops: bool = False
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    profile: object = None

    def read(self):
        """Fill ``device`` and ``host`` from the profile, then drop it."""
        for e in self.profile.events():
            item = (e.name, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6)
            if _device_event(e):
                self.device.append(item)
            elif e.device_type == torch.autograd.DeviceType.CPU:
                self.host.append(item)
        self.profile = None
        return self

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def device_s(self, pick=lambda name: True) -> float:
        return sum(e - s for name, s, e in self.device if pick(name))

    def summary(self) -> str:
        mp = [d for d in self.device if is_minplus(d[0])]
        return (f"{'host and device' if self.host_ops else 'device'} ops: "
                f"{self.analyses} analyses in {self.wall_s:.4f} s, "
                f"{len(self.device)} device events ({len(mp)} min-plus), "
                f"device sum {self.device_s():.4f} s, union "
                f"{self.busy_s():.4f} s, min-plus "
                f"{sum(e - s for _, s, e in mp):.4f} s")


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def _device_event(e) -> bool:
    """A kernel, copy or set on the device; not the device-side copy of a
    ``record_function`` range, which spans the work it annotates."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != ANALYSIS)


def profile_span(run_one, min_seconds: float, max_analyses: int, *,
                 host: bool, cuda: bool = True) -> Span:
    """Profile whole analyses, ``run_one()`` each, until ``min_seconds``
    have passed or ``max_analyses`` ran. Each analysis is a
    ``record_function`` range named ``ANALYSIS``. ``host`` records the
    host's ops too, which slows the host-paced parts of an analysis: such a
    span names what the host did in the device's idle gaps, and the device
    metrics come from the spans without it. ``cuda=False`` (tests on the
    host) records the host's ops only. The events are read later, by
    :meth:`Span.read`, outside the measured window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        count = 0
        while True:
            with record_function(ANALYSIS):
                run_one()
            count += 1
            if (time.perf_counter() - t0 >= min_seconds
                    or count >= max_analyses):
                break
        wall = time.perf_counter() - t0
    return Span(wall, count, host_ops=host or not cuda, profile=prof)


def idle_gaps(span: Span, top: int = 10, scan: int = 200):
    """[[host op, seconds], ...]: the device's idle gaps inside the span's
    analyses, the longest ``scan`` of them each named by the innermost host
    op running at its middle, summed by that name, largest ``top`` first."""
    marks = [(s, e) for name, s, e in span.host if name == ANALYSIS]
    if not marks:
        return []
    lo, hi = min(s for s, _ in marks), max(e for _, e in marks)
    busy = sorted((s, e) for _, s, e in span.device if e > lo and s < hi)
    gaps, reach = [], lo
    for s, e in busy:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    ops = [h for h in span.host if h[0] != ANALYSIS]
    by_name = {}
    for g0, g1 in gaps[:scan]:
        mid = 0.5 * (g0 + g1)
        inner = [h for h in ops if h[1] <= mid <= h[2]]
        name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                else "host (no op recorded)")
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0)
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: kv[1], reverse=True)[:top]


def device_ops(spans, top: int = 10):
    """[[device op, seconds], ...] summed over ``spans``, largest first."""
    by_name = {}
    for span in spans:
        for name, s, e in span.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    return sorted(([k[:120], v] for k, v in by_name.items()),
                  key=lambda kv: kv[1], reverse=True)[:top]
