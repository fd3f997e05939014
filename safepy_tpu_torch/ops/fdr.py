"""Benjamini-Hochberg FDR correction along the last axis, in f64.

Port of ``safepy_tpu/ops/fdr.py`` (reference: statsmodels ``fdrcorrection``
row by row, safepy/safe.py:599-605). NaN p-values are excluded from the test
count and the scan, and come back as NaN.

Two forms: :func:`fdr_bh` adjusts linear p-values (the staged dense
hypergeometric path and the permutation null); :func:`fdr_bh_logsf` adjusts
log p-values on the device, exp-free (the fused binary path), with its numpy
twin :func:`fdr_bh_logsf_np`. The two agree only to the JAX package's own
tolerance (``tests/test_fdr.py:38``).
"""

from __future__ import annotations

import numpy as np
import torch

from safepy_tpu_torch.ops._device import on_device


def fdr_bh(pvalues) -> torch.Tensor:
    """Benjamini-Hochberg adjusted p-values along the last axis (``:26``), f64
    on the input's device; matches ``statsmodels.stats.multitest
    .fdrcorrection(p)[1]`` on finite input."""
    pvalues, = on_device("fdr_bh", pvalues)
    p = torch.as_tensor(pvalues, dtype=torch.float64)
    nan_mask = ~torch.isfinite(p)
    big = torch.where(nan_mask, torch.inf, p)  # NaNs sort last, outside m

    order = torch.argsort(big, dim=-1, stable=True)
    p_sorted = big.gather(-1, order)
    m = (~nan_mask).sum(dim=-1, keepdim=True).to(p.dtype)
    rank = torch.arange(1, p.shape[-1] + 1, dtype=p.dtype, device=p.device)
    raw = p_sorted * m / rank

    # reversed cumulative minimum; the inf (ex-NaN) tail never lowers it
    rev_cummin = raw.flip(-1).cummin(dim=-1).values.flip(-1)
    corrected = torch.empty_like(raw).scatter_(
        -1, order, torch.clamp(rev_cummin, max=1.0))
    return torch.where(nan_mask, torch.nan, corrected)


def _bh_logsf_rows(logsf: torch.Tensor, log_threshold: float):
    """BH on LOG p-values along the last axis, exp-free (``:52``).

    BH's ``p * m / rank`` and its reversed cumulative minimum are monotone
    under ``log``: ``adj = min(0, revcummin(logp + log m - log rank))``.
    ``-inf`` log-p (p = 0) sorts first and stays ``-inf``. The indicator
    ``adj < log_threshold`` is decided in f64 before the store in the
    input's float dtype (f32 for any other). Returns (adj, indicator int8).
    """
    lp = logsf.to(torch.float64)
    nan_mask = torch.isnan(lp)
    big = torch.where(nan_mask, torch.inf, lp)  # NaNs sort last, outside m

    order = torch.argsort(big, dim=-1, stable=True)
    lp_sorted = big.gather(-1, order)
    m = (~nan_mask).sum(dim=-1, keepdim=True).to(torch.float64)
    log_rank = torch.log(torch.arange(1, lp.shape[-1] + 1,
                                      dtype=torch.float64, device=lp.device))
    raw = lp_sorted + torch.log(m) - log_rank

    rev_cummin = raw.flip(-1).cummin(dim=-1).values.flip(-1)
    adj_sorted = torch.clamp(rev_cummin, max=0.0)  # p <= 1
    adj = torch.empty_like(adj_sorted).scatter_(-1, order, adj_sorted)
    adj = torch.where(nan_mask, torch.nan, adj)
    nbin = (adj < float(log_threshold)).to(torch.int8)
    out_dtype = (logsf.dtype if logsf.dtype.is_floating_point
                 else torch.float32)
    return adj.to(out_dtype), nbin


def fdr_bh_logsf_np(logsf, log_threshold):
    """NumPy twin of :func:`fdr_bh_logsf` (``:110``): the same log-space BH
    step-up on the host. Returns (logsf_adj, indicator int8, enriched counts
    int32) as numpy arrays."""
    lp = np.asarray(logsf, np.float64)
    nan_mask = np.isnan(lp)
    big = np.where(nan_mask, np.inf, lp)
    order = np.argsort(big, axis=-1, kind="stable")
    lp_sorted = np.take_along_axis(big, order, axis=-1)
    m = (~nan_mask).sum(axis=-1, keepdims=True).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = (lp_sorted + np.log(m)
               - np.log(np.arange(1, lp.shape[-1] + 1, dtype=np.float64)))
    rev_cummin = np.minimum.accumulate(raw[..., ::-1], axis=-1)[..., ::-1]
    adj_sorted = np.minimum(rev_cummin, 0.0)
    inv = np.argsort(order, axis=-1, kind="stable")
    adj = np.take_along_axis(adj_sorted, inv, axis=-1)
    adj = np.where(nan_mask, np.nan, adj)
    nbin = (adj < np.float64(log_threshold)).astype(np.int8)
    out_dtype = (logsf.dtype if np.issubdtype(np.asarray(logsf).dtype,
                                              np.floating) else np.float32)
    return (adj.astype(out_dtype), nbin,
            nbin.sum(axis=0, dtype=np.int32))


def fdr_bh_logsf(logsf32, log_threshold, *, row_chunk: int | None = None):
    """BH adjustment of an (N, A) log-survival matrix on its device
    (``:139``). Rows are independent, so with ``row_chunk`` the f64 sort
    runs a chunk of rows at a time into preallocated outputs; the last chunk
    clamps its start (its overlap rows recompute the same values).

    Returns (logsf_adj, indicator int8, enriched counts int32 (A,)), all on
    the input's device.
    """
    logsf32, = on_device("fdr_bh_logsf", logsf32)
    n = logsf32.shape[0]
    if row_chunk is None or row_chunk >= n:
        adj, nbin = _bh_logsf_rows(logsf32, log_threshold)
    else:
        dt = (logsf32.dtype if logsf32.dtype.is_floating_point
              else torch.float32)
        adj = torch.zeros(logsf32.shape, dtype=dt, device=logsf32.device)
        nbin = torch.zeros(logsf32.shape, dtype=torch.int8,
                           device=logsf32.device)
        for ci in range(-(-n // row_chunk)):
            start = min(ci * row_chunk, n - row_chunk)
            rows = slice(start, start + row_chunk)
            adj[rows], nbin[rows] = _bh_logsf_rows(logsf32[rows],
                                                   log_threshold)
    return adj, nbin, nbin.sum(dim=0, dtype=torch.int32)
