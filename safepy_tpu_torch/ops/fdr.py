"""Benjamini-Hochberg FDR correction along the last axis, in f64.

Port of ``safepy_tpu/ops/fdr.py:fdr_bh`` (reference: statsmodels
``fdrcorrection`` row by row, safepy/safe.py:599-605). NaN p-values are
excluded from the test count and the scan, and come back as NaN.
"""

from __future__ import annotations

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
