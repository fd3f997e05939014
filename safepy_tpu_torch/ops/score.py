"""Neighborhood scores as f32 matmuls with explicit NaN masks.

Port of ``safepy_tpu/ops/score.py``. 'sum' is ``neighborhoods @ nan_to_zero(
values)``; 'z-score' divides the neighborhood mean by its standard deviation
from ``E[X^2] - E[X]^2``, NaN where the std is 0 or fewer than 3 members are
annotated.

The matmuls stay ``torch.matmul`` (the JAX package leaves them to XLA) and
must run in full f32: the permutation null counts ties with ``<=``/``>=``, so
integer-valued scores must be exact. :func:`check_fp32_matmul` refuses to run
when TF32 or a reduced float32 matmul precision is switched on; it does not
reset the global settings itself.
"""

from __future__ import annotations

import torch

from safepy_tpu_torch.ops._device import on_device


def check_fp32_matmul(precision: str = "highest") -> None:
    """Raise unless f32 matmuls run at full f32 precision."""
    if precision != "highest":
        raise NotImplementedError(
            f"matmul precision {precision!r} is not ported; only 'highest'")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "score matmuls need full f32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def zscore_shift(B: torch.Tensor, NB: torch.Tensor) -> torch.Tensor:
    """Per-attribute mean of the annotated values (``:42``), the shift that
    keeps ``E[X^2] - E[X]^2`` well conditioned. B: (..., V, A) NaN->0 values,
    NB: the matching 0/1 mask. Returns (A,)."""
    tot = NB.sum(dim=-2)
    return B.sum(dim=-2) / torch.clamp(tot, min=1.0)


def zscore_from_contractions(AB, N, EXX_sum, shift=None):
    """z-scores from the value-sum, count and squared-sum contractions
    (``:64``); with ``shift``, AB and EXX_sum are of the shifted values."""
    safe_N = torch.where(N > 0, N, torch.ones_like(N))
    M = AB / safe_N
    EXX = EXX_sum / safe_N
    std = torch.sqrt(torch.clamp(EXX - M * M, min=0.0))
    if shift is not None:
        M = M + shift.to(M.dtype)
    nan = torch.full_like(M, float("nan"))
    score = torch.where(std > 0, M / torch.where(std > 0, std,
                                                 torch.ones_like(std)), nan)
    return torch.where(N < 3, nan, score)


def compute_neighborhood_score(neighborhoods: torch.Tensor,
                               node2attribute: torch.Tensor,
                               score_type: str = "sum",
                               precision: str = "highest") -> torch.Tensor:
    """(N, A) f32 per-neighborhood scores (``:86``).

    neighborhoods: (N, N) 0/1 indicator; node2attribute: (N, A), NaN =
    unannotated; score_type 'sum' or 'z-score'.
    """
    neighborhoods, node2attribute = on_device(
        "compute_neighborhood_score", neighborhoods, node2attribute)
    check_fp32_matmul(precision)
    A = neighborhoods.to(torch.float32)
    vals = node2attribute.to(torch.float32)
    mask = torch.isfinite(vals)
    B = torch.where(mask, vals, torch.zeros_like(vals))

    if score_type == "sum":
        return A @ B
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")

    NB = mask.to(torch.float32)
    N = A @ NB
    c = zscore_shift(B, NB)
    Bs = B - NB * c
    return zscore_from_contractions(A @ Bs, N, A @ (Bs * Bs), shift=c)
