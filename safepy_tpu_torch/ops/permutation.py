"""Batched permutation null for quantitative attributes.

Port of ``safepy_tpu/ops/permutation.py``: permute the rows of the valid
(annotated) attribute rows, rescore every neighborhood, and count two-sided
``perm <= obs`` / ``perm >= obs`` (ties count on both sides), reference
safe_extras.py:36-70.

A chunk of C permutations is C rows of ``torch.rand(C, V, generator=g)
.argsort(dim=1)``, applied with one row gather, then scored in one
``(N, V) x (C, V, A)`` contraction. Only the gather engine is ported: the JAX
package's key-sort path (``permuted_operands_sorted`` :113) exists for the
TPU's slow lone-column gather. Every entry point also takes an explicit
``perm_idx`` of shape (P, V), so that tests can give two implementations the
same permutations; the torch and JAX random streams differ.
"""

from __future__ import annotations

import torch

from safepy_tpu_torch.ops._device import on_device
from safepy_tpu_torch.ops.score import (check_fp32_matmul, zscore_shift,
                                        zscore_from_contractions)
from safepy_tpu_torch.profiling import span


def default_batch_size(num_valid: int, num_attributes: int,
                       num_permutations: int,
                       budget_bytes: int = 1 << 28) -> int:
    """Largest permutation chunk whose gathered operands fit the budget (``:62``)."""
    per_perm = max(1, num_valid * num_attributes * 4 * 3)
    return int(max(1, min(num_permutations, budget_bytes // per_perm)))


def _scores_from_permuted(nbr_valid, Bp, NBp, score_type: str,
                          precision: str = "highest", shift=None):
    """(C, N, A) scores of permuted operands (``:69``). Bp: (C, V, A) permuted
    NaN->0 values (shifted for z-score); NBp: their masks (z-score only)."""
    check_fp32_matmul(precision)
    AB = torch.einsum("nv,cva->cna", nbr_valid, Bp)
    if score_type == "sum":
        return AB
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")
    Np = torch.einsum("nv,cva->cna", nbr_valid, NBp)
    EXX_sum = torch.einsum("nv,cva->cna", nbr_valid, Bp * Bp)
    return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)


def permutation_scores(nbr_valid, vals, mask, perm_idx, score_type: str,
                       precision: str = "highest", shift=None):
    """Scores of a chunk of row-permuted attribute matrices (``:92``).

    nbr_valid: (N, V); vals, mask: (V, A); perm_idx: (C, V) int.
    Returns (C, N, A) f32.
    """
    Bp = vals[perm_idx]                                    # (C, V, A)
    NBp = mask[perm_idx] if score_type == "z-score" else None
    return _scores_from_permuted(nbr_valid, Bp, NBp, score_type, precision,
                                 shift=shift)


def random_permutations(count: int, size: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(count, size) int64: each row a uniform random permutation, drawn on
    the generator's device."""
    keys = torch.rand(count, size, generator=generator,
                      device=generator.device)
    return keys.argsort(dim=1)


def count_scan(chunk, obs: torch.Tensor, *, num_permutations: int,
               batch_size: int, route: str = "dense"):
    """Two-sided count accumulator over permutation chunks (``:171``).

    ``chunk = (permuted, chunk_scores)``: ``permuted(start, count)``
    gathers the operands of permutations ``start .. start + count`` (an
    ``enrichment.permute`` span) and ``chunk_scores(operands) -> (count, N,
    A)`` scores them (with the counting, an ``enrichment.count`` span).
    Both spans carry the caller's ``route`` (``dense``: the (N, V)
    contraction of :func:`scan_counts`; ``band``).
    Returns int32 (counts_neg, counts_pos).
    """
    permuted, chunk_scores = chunk
    counts_neg = torch.zeros(obs.shape, dtype=torch.int32, device=obs.device)
    counts_pos = torch.zeros_like(counts_neg)
    for start in range(0, num_permutations, batch_size):
        count = min(batch_size, num_permutations - start)
        with span("enrichment.permute", route=route):
            operands = permuted(start, count)
        with span("enrichment.count", route=route):
            scores = chunk_scores(operands)
            del operands
            counts_neg += (scores <= obs[None]).sum(dim=0, dtype=torch.int32)
            counts_pos += (scores >= obs[None]).sum(dim=0, dtype=torch.int32)
    return counts_neg, counts_pos


def scan_counts(nbr_valid, vals, mask, obs, *, score_type: str,
                num_permutations: int, batch_size: int,
                generator: torch.Generator | None = None, perm_idx=None,
                precision: str = "highest"):
    """Count loop over permutation chunks (``:218``).

    Permutations come from ``perm_idx`` (P, V) when given, else from
    ``generator``. Returns int32 (N, A) counts.
    """
    V = vals.shape[0]
    if perm_idx is not None:
        perm_idx = torch.as_tensor(perm_idx, dtype=torch.int64,
                                   device=vals.device)
        if tuple(perm_idx.shape) != (num_permutations, V):
            raise ValueError(f"perm_idx must be ({num_permutations}, {V}), "
                             f"got {tuple(perm_idx.shape)}")
    elif generator is None:
        raise ValueError("scan_counts needs a generator or perm_idx")

    shift = None
    if score_type == "z-score":
        # centre once before permuting (shifting commutes with row
        # permutation): see ops.score.zscore_shift
        shift = zscore_shift(vals, mask)
        vals = vals - mask * shift

    def permuted(start, count):
        idx = (perm_idx[start:start + count] if perm_idx is not None
               else random_permutations(count, V, generator))
        return vals[idx], (mask[idx] if score_type == "z-score" else None)

    def chunk_scores(operands):
        return _scores_from_permuted(nbr_valid, *operands, score_type,
                                     precision, shift=shift)

    return count_scan((permuted, chunk_scores), obs,
                      num_permutations=num_permutations,
                      batch_size=batch_size)


def prepare_valid(neighborhoods, node2attribute, valid_rows):
    """Restrict operands to the valid rows: (nbr_valid, vals, mask) (``:252``).

    ``valid_rows=None`` means every row is valid (no column gather)."""
    nbr = neighborhoods.to(torch.float32)
    n2a = node2attribute.to(torch.float32)
    if valid_rows is None:
        rows, nbr_valid = n2a, nbr
    else:
        valid_rows = torch.as_tensor(valid_rows, dtype=torch.int64,
                                     device=nbr.device)
        nbr_valid = nbr.index_select(1, valid_rows)
        rows = n2a.index_select(0, valid_rows)
    mask = torch.isfinite(rows).to(torch.float32)
    vals = torch.where(mask > 0, rows, torch.zeros_like(rows))
    return nbr_valid, vals, mask


def run_permutations(neighborhoods, node2attribute, valid_rows, obs, *,
                     generator: torch.Generator | None = None, perm_idx=None,
                     score_type: str = "sum", num_permutations: int = 1000,
                     batch_size: int | None = None,
                     precision: str = "highest"):
    """Two-sided empirical null counts (``:275``).

    neighborhoods: (N, N) 0/1; node2attribute: (N, A) with NaNs; valid_rows:
    (V,) rows with a finite value, or None for all; obs: (N, A) observed
    scores. Returns int32 (counts_neg, counts_pos); where obs is NaN both
    count zero.
    """
    neighborhoods, node2attribute, valid_rows, obs = on_device(
        "run_permutations", neighborhoods, node2attribute, valid_rows, obs,
        generator=generator)
    nbr_valid, vals, mask = prepare_valid(neighborhoods, node2attribute,
                                          valid_rows)
    V, A = vals.shape
    if batch_size is None:
        batch_size = default_batch_size(V, A, num_permutations)
    return scan_counts(nbr_valid, vals, mask, obs.to(torch.float32),
                       score_type=score_type,
                       num_permutations=num_permutations,
                       batch_size=batch_size, generator=generator,
                       perm_idx=perm_idx, precision=precision)
