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
  includes the nvcc build of ``native.py`` on first use) and a steady one;
- :func:`span` marks a phase of an analysis (the facade, the neighborhoods'
  front and relax, the null's gather and count, the GO engines' census,
  class table, lookup and f64 tail) while a ``torch.profiler`` session
  records, and costs one flag check otherwise; :func:`annotate` adds attrs
  to the innermost open span.

Spans, for an operator: ``with profiling.trace(dir):`` around analyses
writes a Chrome trace in which each span is a ``record_function`` range on
the profiler's clock, above the torch ops and kernels it issued, so that a
trace viewer shows which phase of SAFE launched what.
:func:`span_records` gives the same spans in process: names, ids, each
one's parent and analysis (its root), host milliseconds, its own host time
without its children's, and on a card the stream milliseconds between two
CUDA events recorded at its entry and exit. A span never synchronizes; the
events are read when the records are.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque

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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

SPAN_BUFFER = 16384
# the newest SPAN_BUFFER span records, oldest first (in the order opened)
SPANS: deque = deque(maxlen=SPAN_BUFFER)

_profiler_enabled = torch._C._autograd._profiler_enabled
_span_ids = itertools.count(1)
_event_pool: dict = {}         # CUDA device index -> free timing events


class _Open(threading.local):
    """This thread's open spans, outermost first."""

    def __init__(self):
        self.stack = []


_open = _Open()


class _NullSpan:
    """What :func:`span` returns while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _event(device: int):
    free = _event_pool.get(device)
    if free:
        return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _release(rec) -> None:
    """Return a closed record's events to the pool."""
    if rec.events is not None and rec.t1 is not None:
        _event_pool.setdefault(rec.device, []).extend(rec.events)
        rec.events = None


class Span:
    """One span: a ``record_function`` range, and a record in ``SPANS``
    with host times (``time.perf_counter_ns``) and, where CUDA is in use,
    a pair of timing events on the current stream."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "t1",
                 "device", "events", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = self.events = self._range = self.device = None

    def __enter__(self):
        stack = _open.stack
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        if len(SPANS) == SPANS.maxlen:
            _release(SPANS.popleft())
        SPANS.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            self.events = (_event(self.device), _event(self.device))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager marking one phase of an analysis. While a
    ``torch.profiler`` session records on this process it opens a
    ``record_function(name)`` range and appends a :class:`Span` record
    (with ``attrs``) to ``SPANS``; it yields the record, whose ``attrs`` the
    block may add to. Otherwise it does nothing and yields None. Spans
    never synchronize a device."""
    if not _profiler_enabled():
        return _NULL_SPAN
    return Span(name, attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to this thread's innermost open span while a
    ``torch.profiler`` session records (a count known only at the end of
    the work a caller's span wraps); otherwise nothing."""
    if _profiler_enabled() and _open.stack:
        _open.stack[-1].attrs.update(attrs)


def reset_spans() -> None:
    """Forget every span record; their events go back to the pool."""
    while SPANS:
        _release(SPANS.popleft())


def span_records() -> list[dict]:
    """The closed spans in ``SPANS``, oldest first, as dicts: ``name``,
    ``id``, ``parent`` and ``root`` (ids; spans of one analysis share their
    root's), ``attrs``, ``start_ns`` and ``end_ns`` (host,
    ``time.perf_counter_ns``), ``host_ms``, ``self_host_ms`` (its host time
    less its children's in the buffer) and ``stream_ms`` (the elapsed time
    of its two CUDA events, waiting for the second where the device has
    not reached it; None without CUDA)."""
    closed = [r for r in SPANS if r.t1 is not None]
    child_ns: dict = {}
    for r in closed:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.t1 - r.t0
    out = []
    for r in closed:
        stream_ms = None
        if r.events is not None:
            r.events[1].synchronize()
            stream_ms = r.events[0].elapsed_time(r.events[1])
        host_ns = r.t1 - r.t0
        out.append(dict(name=r.name, id=r.id, parent=r.parent, root=r.root,
                        attrs=dict(r.attrs), start_ns=r.t0, end_ns=r.t1,
                        host_ms=host_ns * 1e-6,
                        self_host_ms=(host_ns - child_ns.get(r.id, 0)) * 1e-6,
                        stream_ms=stream_ms))
    return out
