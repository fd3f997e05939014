"""The facade's (n, A) matrices across the host boundary, in row blocks.

- :func:`upload_f32_counted`: the host f64 attribute matrix to the device
  as f32, with the count of its finite values that are not 0 or 1 (the
  binary check);
- :func:`download_f64`: a device result (the NES, the enrichment
  indicator) back as the fresh f64 host matrix that ``SAFE.nes`` and
  ``SAFE.nes_binary`` return.

A block is ``_BLOCK_ELEMS`` values of whole rows (32 MiB of f64).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_BLOCK_ELEMS = 1 << 22

# the widening threads: numpy's casts release the GIL, so the cast and the
# first touch of a fresh f64 result's pages run on every thread at once
_WIDEN_THREADS_MAX = 16
_widen_pool = None
_widen_lock = threading.Lock()


def _block_rows(cols: int) -> int:
    """Rows a block at ``cols`` columns."""
    return max(1, _BLOCK_ELEMS // max(1, cols))


def upload_f32_counted(n2a_np, *, device):
    """(the f32 (n, A) device matrix, the count of its finite values that
    are not 0 or 1) from one f64 transfer of the host matrix, in blocks of
    whole rows. A block is read where it lies (copied only where it is not
    writable f64 with non-negative strides); for a card torch's threads
    copy it into pinned pages, whose copy to the card runs while they copy
    the next block (the pinned allocator keeps a block's pages until its
    copy is done). Each block is cast on the device into its rows of the
    f32 matrix, as numpy casts (nearest even, inf past f32's range,
    subnormals kept), and counted there (the count of
    ``enrich_band.count_other_values_chunked``, on the same f32 values);
    the total is read once at the end."""
    n, a = n2a_np.shape
    out = torch.empty((n, a), dtype=torch.float32, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    step = _block_rows(a)
    for r0 in range(0, n, step):
        rows = np.require(n2a_np[r0:r0 + step], np.float64, "W")
        if min(rows.strides) < 0:
            rows = np.ascontiguousarray(rows)
        blk = torch.from_numpy(rows)
        x = out[r0:r0 + step]
        if x.is_cuda:
            blk = blk.pin_memory()
        x.copy_(blk.to(x.device, non_blocking=True))
        total += (torch.isfinite(x) & (x != 0.0) & (x != 1.0)).sum()
    return out, int(total)


def _forget_widen_pool() -> None:
    """In a forked child: the parent's threads are not there, so the next
    widening makes a pool of its own."""
    global _widen_pool, _widen_lock
    _widen_pool, _widen_lock = None, threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_forget_widen_pool)


def _widen_threads() -> tuple[int, ThreadPoolExecutor]:
    """(threads, their executor), made on first use in this process: one
    a core this process may run on, at most ``_WIDEN_THREADS_MAX``."""
    global _widen_pool
    with _widen_lock:
        if _widen_pool is None:
            cores = (len(os.sched_getaffinity(0))
                     if hasattr(os, "sched_getaffinity")
                     else os.cpu_count() or 1)
            threads = max(1, min(_WIDEN_THREADS_MAX, cores))
            _widen_pool = (threads, ThreadPoolExecutor(
                threads, thread_name_prefix="widen"))
        return _widen_pool


def _widen_start(dst: np.ndarray, src: np.ndarray) -> list:
    """Start ``np.copyto(dst, src)`` (numpy's cast, as ``astype`` makes
    it) in row slices across the widening threads; the futures to wait on
    (none where one slice ran here)."""
    threads, pool = _widen_threads()
    parts = min(threads, len(src))
    if parts <= 1:
        np.copyto(dst, src)
        return []
    cuts = np.linspace(0, len(src), parts + 1).astype(np.int64)
    return [pool.submit(np.copyto, dst[a:b], src[a:b])
            for a, b in zip(cuts[:-1], cuts[1:])]


def _wait(futures) -> None:
    for f in futures:
        f.result()


def download_f64(x) -> np.ndarray:
    """A fresh, C-contiguous f64 numpy copy of the (n, A) matrix ``x``
    (a tensor, or a host array), bitwise ``x.cpu().numpy().astype(np.
    float64)`` (f32 and int8 widen exactly; NaN payloads, signed zeros and
    subnormals kept). Nothing is widened or allocated on the card.

    On a card, blocks of whole rows are copied in turn on the current
    stream into two pinned staging buffers, and each block, once its
    copy's event has passed, is widened into its rows of the result while
    the next block is copied: the copy of block k + 1 waits only for the
    widening of block k - 1, whose buffer it takes, so that two widenings
    overlap and no thread idles at a block's end. A host ``x`` is widened
    straight from its memory. The widening runs in row slices across a
    pool of host threads (``_widen_start``)."""
    n, a = x.shape
    out = np.empty((n, a), np.float64)
    if out.size == 0:
        return out
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        _wait(_widen_start(out, x.numpy() if isinstance(x, torch.Tensor)
                           else x))
        return out
    step = _block_rows(a)
    blocks = -(-n // step)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        staging = [torch.empty((min(step, n), a), dtype=x.dtype,
                               pin_memory=True)
                   for _ in range(min(2, blocks))]

        def enqueue(k):
            r0 = k * step
            buf = staging[k % 2][:min(step, n - r0)]
            buf.copy_(x[r0:r0 + step], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            return r0, buf, done

        widening = {}   # block -> the futures of its widening
        try:
            nxt = enqueue(0)
            for k in range(blocks):
                r0, buf, done = nxt
                done.synchronize()
                widening[k] = _widen_start(out[r0:r0 + len(buf)],
                                           buf.numpy())
                if k + 1 < blocks:
                    _wait(widening.pop(k - 1, ()))
                    nxt = enqueue(k + 1)
        finally:
            for futures in widening.values():
                _wait(futures)
    return out
