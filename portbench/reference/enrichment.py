"""Quantitative scores and the permutation null of a block of neighborhoods."""

from __future__ import annotations

import math

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits, nearest even), as a
    tensor core rounds a TF32 GEMM's operands; kept as f32."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def permuted_values(x_valid: torch.Tensor, perm: torch.Tensor,
                    lowered: bool = False) -> torch.Tensor:
    """(V, P): column p holds the annotated values in the order of
    permutation p, ``x_valid[perm[p, j]]`` at row j. f64, or f32 rounded to
    TF32 with ``lowered``."""
    if lowered:
        return to_tf32(x_valid.to(torch.float32))[perm].T
    return x_valid.to(torch.float64)[perm].T


def block_null(nbr: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
               perm: torch.Tensor, *, chunk: int = 2048,
               lowered: bool = False):
    """Scores and two-sided null counts of a block of neighborhoods.

    nbr: (S, n) bool indicator rows; x: (n,) values, NaN = unannotated;
    valid: (V,) the annotated rows; perm: (P, V) permutations of them.
    Returns (obs (S,), absum (S,), counts_neg (S,), counts_pos (S,)) with
    obs = sum of the neighborhood's annotated values, absum = the sum of
    their magnitudes (the scale of a score's rounding), counts of
    ``null <= obs`` and ``null >= obs`` over the P permutations."""
    dtype = torch.float32 if lowered else torch.float64
    x0 = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    a = nbr.to(dtype)
    xo = to_tf32(x0.to(torch.float32)) if lowered else x0
    obs = a @ xo.to(dtype)
    absum = nbr.to(torch.float64) @ x0.abs()
    a_valid = a[:, valid]
    x_valid = x0[valid]
    counts_neg = torch.zeros(nbr.shape[0], dtype=torch.int64,
                             device=nbr.device)
    counts_pos = torch.zeros_like(counts_neg)
    for start in range(0, perm.shape[0], chunk):
        xp = permuted_values(x_valid, perm[start:start + chunk], lowered)
        null = a_valid @ xp.to(dtype)
        counts_neg += (null <= obs[:, None]).sum(dim=1)
        counts_pos += (null >= obs[:, None]).sum(dim=1)
    return obs.to(torch.float64), absum, counts_neg, counts_pos


def nes_binary(counts_neg: torch.Tensor, counts_pos: torch.Tensor,
               num_permutations: int, threshold: float = 0.05
               ) -> torch.Tensor:
    """SAFE's enrichment call of a quantitative null (safepy
    ``compute_pvalues_by_randomization``, ``attribute_sign='both'``):
    p = counts / P with 0 floored to 1 / P, NES = -log10 p_pos + log10
    p_neg, enriched where |NES| > -log10(threshold). f64."""
    p = float(num_permutations)
    p_neg = torch.clamp(counts_neg.to(torch.float64) / p, min=1.0 / p)
    p_pos = torch.clamp(counts_pos.to(torch.float64) / p, min=1.0 / p)
    nes = -torch.log10(p_pos) + torch.log10(p_neg)
    return nes.abs() > -math.log10(threshold)
