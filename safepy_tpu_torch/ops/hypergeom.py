"""Vectorized hypergeometric survival function on torch tensors.

Port of ``safepy_tpu/ops/hypergeom.py``: ``P[X >= k]`` for X ~
Hypergeometric(M, K, n) (the reference's ``hypergeom.sf(k - 1, M, K, n)``,
safepy/safe.py:596) as one leading log-pmf per cell, assembled in f64 from a
host ``lgamma(x + 1)`` table, times a tail sum of the exact pmf ratio
recurrence

    pmf(t+1)/pmf(t) = (K - t)(n - t) / ((t + 1)(M - K - n + t + 1)),

summed in the decaying direction (upward from a start at or past the mode,
else the complement downward). The recipe is the JAX package's step by step
although the card has native f64: the port is held to that package, so the
complement branch keeps its f32 ``exp``, and the loop its global stop rule.

:func:`_sf_parts` runs on the tensors' device; :func:`hypergeom_sf` and
:func:`hypergeom_neglog10_sf` finalize on the host and return numpy, as
JAX's do; :func:`finalize_logsf_device` finalizes on the device for the
fused binary pipeline.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln as _host_gammaln

from safepy_tpu_torch.ops._device import on_device
from safepy_tpu_torch.profiling import annotate, span

_LN10 = float(np.log(10.0))
_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """f32 subnormals to zero, as XLA's CPU and the TPU compute f32 (an
    ``exp`` below the normal range is 0 there, and stays 0 after a
    product)."""
    return x.masked_fill(x.abs() < _F32_TINY, 0.0)


def lgamma_table(max_m: int) -> np.ndarray:
    """Host ``lgamma(x + 1)`` for integer x in [0, max_m], f64 (``:42``)."""
    return _host_gammaln(np.arange(max_m + 1, dtype=np.float64) + 1.0)


def tail_iterations(max_population: int, max_draws: int) -> int:
    """Iteration bound of the tail sum (``:47``): 12 sigma of Gaussian decay
    (sigma <= sqrt(min(n, M)) / 2) plus 48, capped by the support."""
    sigma = 0.5 * float(min(max_draws, max_population)) ** 0.5
    return int(min(max_draws + 2, 12.0 * sigma + 48.0))


def _sf_parts(k, M, K, n, lgt, iterations: int):
    """Leading log-pmf and tail ratio sum (``:59``).

    k, K, n: f64 tensors of integer values on one device, broadcastable
    (``expand`` views are fine: nothing is written in place); M: the
    population; lgt: the f64 lgamma table covering [0, M] on that device.
    Returns (log_pmf0, acc, use_upper, below, above): ``sf = exp(log_pmf0) *
    acc`` on the upper branch, ``1 - exp(log_pmf0) * acc`` on the other,
    1 where ``below``, 0 where ``above``.

    The loop stops on JAX's global rule (``:118-120``), checked before each
    body: ``i < iterations`` and the largest live term above 1e-18 (a wait
    for the device). The bodies run go to the ``iterations`` attr of the
    innermost open span, the caller's ``enrichment.go_tail``.
    """
    f64 = torch.float64
    k, K, n = k.to(f64), K.to(f64), n.to(f64)
    M = float(M)

    lower = torch.clamp(n + K - M, min=0.0)  # support lower bound
    upper = torch.minimum(K, n)              # support upper bound
    mode = torch.floor((n + 1.0) * (K + 1.0) / (M + 2.0))

    k_eff = torch.minimum(torch.maximum(k, lower), upper + 1.0)
    use_upper = k_eff >= mode
    t0 = torch.where(use_upper, k_eff, k_eff - 1.0)
    t0 = torch.minimum(torch.maximum(t0, lower), upper)

    last = lgt.shape[0] - 1

    def gather(x):
        return lgt[x.to(torch.int64).clamp_(0, last)]

    # log pmf(t0) = log C(K, t0) + log C(M-K, n-t0) - log C(M, n)
    log_pmf0 = (gather(K) - gather(t0) - gather(K - t0)
                + gather(M - K) - gather(n - t0) - gather(M - K - n + t0)
                - (lgt[int(M)] - gather(n) - gather(M - n)))

    # The ratio's factors are integer products, exact in f64 in any order,
    # so one pair serves both branches: with a = M - K - n,
    # P(x) = (K - x)(n - x) and Q(x) = (x + 1)(a + x + 1), the upper
    # branch's ratio at t is P(t) / Q(t) and the complement's,
    # t (a + t) / ((K - t + 1)(n - t + 1)), is Q(t - 1) / P(t - 1). The loop
    # carries x = t (upper) or t - 1 (complement).
    a = M - K - n
    step = torch.where(use_upper, 1.0, -1.0)
    # terms left in the support after the first: upper - t0 or t0 - lower
    room = torch.where(use_upper, upper - t0, t0 - lower)
    x = torch.where(use_upper, t0, t0 - 1.0)

    acc = torch.zeros_like(k_eff)
    term = torch.ones_like(k_eff)
    i = 0
    while i < iterations and float(term.max()) > 1e-18:
        term = torch.where(room >= i, term, 0.0)
        acc += term
        xp1 = x + 1.0
        p = (K - x) * (n - x)
        q = xp1 * (a + xp1)
        num = torch.where(use_upper, p, q)
        den = torch.where(use_upper, q, p)
        term = term * (num / torch.where(den == 0.0, 1.0, den))
        x += step
        i += 1
    annotate(iterations=i)
    return log_pmf0, acc, use_upper, k <= lower, k > upper


def _parts(k, M, K, n, iterations):
    """(``:140``) the parts of ``P[X >= k]`` on the operands' device, as
    numpy."""
    k, K, n = on_device("hypergeom_sf", k, K, n)
    M = int(M)
    if iterations is None:
        iterations = tail_iterations(M, M)
    f64 = torch.float64
    k, K, n = torch.broadcast_tensors(k.to(f64), K.to(f64), n.to(f64))
    lgt = torch.as_tensor(lgamma_table(M), device=k.device)
    with span("enrichment.go_tail", cells=k.numel(), bound=iterations):
        parts = _sf_parts(k, M, K, n, lgt, iterations)
    return tuple(x.cpu().numpy() for x in parts)


def hypergeom_sf(k, M, K, n, *, iterations: int | None = None):
    """P[X >= k] for X ~ Hypergeometric(M, K, n), vectorized (``:153``).

    Matches ``scipy.stats.hypergeom.sf(k - 1, M, K, n)``: pass the raw count.
    k, K, n broadcast; array-likes go to the card (``ops/_device.py``), so
    on the host pass CPU tensors. The tail sum runs on the operands' device,
    the final ``exp`` on the host in f64; returns numpy.

    Args:
      k: observed counts; M: population size (int); K: per-attribute
      annotated totals; n: per-neighborhood sizes; iterations: the tail
      length bound, derived from M when omitted.
    """
    return _host_sf(_parts(k, M, K, n, iterations))


def _host_sf(parts):
    lp0, acc, use_upper, below, above = parts
    tail = np.exp(lp0) * acc
    sf = np.where(use_upper, tail, 1.0 - tail)
    sf = np.where(below, 1.0, sf)
    sf = np.where(above, 0.0, sf)
    return np.clip(sf, 0.0, 1.0)


def _host_nes(parts):
    lp0, acc, use_upper, below, above = parts
    with np.errstate(divide="ignore", invalid="ignore"):
        upper_nes = -(lp0 + np.log(np.maximum(acc, 0.0))) / np.log(10.0)
        lower_nes = -np.log10(np.clip(1.0 - np.exp(lp0) * acc, 0.0, 1.0))
    nes = np.where(use_upper, upper_nes, lower_nes)
    nes = np.where(below, 0.0, nes)
    nes = np.where(above, np.inf, nes)
    return np.maximum(nes, 0.0)


def finalize_logsf_device(parts, enrichment_threshold):
    """Device finalization to (nes f32, log_sf f32, nes_binary int8)
    (``:193``).

    The upper branch's log-survival ``lp0 + log(acc)`` stays f64; the
    complement branch's ``exp`` runs in f32 and ``log1p`` of the clamped
    tail in f32, as in JAX, with JAX's f32 subnormals flushed to zero. The
    significance indicator is decided in f64 before the f32 rounding, so
    enriched counts are exact; callers recover p-values on the host as
    ``exp(float64(log_sf))``.
    """
    lp0, acc, use_upper, below, above = parts
    f32 = torch.float32
    log_sf_upper = lp0 + torch.log(torch.clamp(acc, min=1e-300))

    tail32 = flush_subnormal(flush_subnormal(torch.exp(lp0.to(f32)))
                             * acc.to(f32))
    tail32 = torch.clamp(tail32, 0.0, 1.0)
    cap = torch.tensor(1.0 - 1e-7, dtype=f32, device=tail32.device)
    log_sf_lower = torch.log1p(-torch.minimum(tail32, cap)).to(torch.float64)

    log_sf = torch.where(use_upper, log_sf_upper, log_sf_lower)
    log_sf = torch.where(below, 0.0, log_sf)
    log_sf = torch.where(above, -torch.inf, log_sf)
    log_sf = torch.clamp(log_sf, max=0.0)

    nes = -log_sf / _LN10
    threshold = -float(np.log(np.float64(enrichment_threshold)))
    nes_binary = (-log_sf > threshold).to(torch.int8)
    return (flush_subnormal(nes.to(f32)), flush_subnormal(log_sf.to(f32)),
            nes_binary)


def tail_device(counts, nsize, K, lgt, M: int, enrichment_threshold,
                iterations: int):
    """(nes f32, log sf f32, indicator int8) of a census block on its
    device: :func:`_sf_parts` over the (row, column) cells, ``nsize`` a
    row's draws and ``K`` a column's successes, then
    :func:`finalize_logsf_device`; in an ``enrichment.go_tail`` span
    (attrs ``cells``, ``bound`` and the bodies run, ``iterations``)."""
    f64 = torch.float64
    shape = counts.shape
    with span("enrichment.go_tail", cells=counts.numel(), bound=iterations):
        parts = _sf_parts(counts.to(f64), M,
                          K.to(f64)[None, :].expand(shape),
                          nsize.to(f64)[:, None].expand(shape), lgt,
                          iterations)
        return finalize_logsf_device(parts, enrichment_threshold)


def hypergeom_sf_and_nes(k, M, K, n, *, iterations: int | None = None):
    """(sf, -log10(sf)) from one tail-sum pass (``:229``), numpy."""
    parts = _parts(k, M, K, n, iterations)
    return _host_sf(parts), _host_nes(parts)


def hypergeom_neglog10_sf(k, M, K, n, *, iterations: int | None = None):
    """-log10(P[X >= k]) at full f64 precision (``:236``), numpy: the
    upper branch as ``-(log_pmf0 + log(acc)) / ln 10``, which does not
    underflow with ``sf`` itself."""
    return _host_nes(_parts(k, M, K, n, iterations))
