"""Neighborhood scores and the permutation null over band-storage
neighborhoods, never densified.

Port of ``safepy_tpu/ops/enrich_band.py`` for the quantitative branch:
:func:`band_score` (sum and z-score, ``:44``) and :func:`scan_counts_band`
(the two-sided null, ``:70``, gather engine). Everything lives in the
permuted (banded-order) node frame; callers un-permute the row outputs.

Permutations are drawn as in :mod:`.permutation`: ``torch.rand(C, V).argsort``
rows from the session's generator, or an explicit ``perm_idx`` (P, V), both
indexing the valid rows in ORIGINAL node order. ``sigma`` maps them into the
banded frame, so both engines of the port draw the same permutations from
the same seed or ``perm_idx``. The key-sort engine is a TPU workaround and is
not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from safepy_tpu_torch.ops.apsp_bandstore import (band_count_batch,
                                                 band_matmul,
                                                 band_matmul_batch)
from safepy_tpu_torch.ops.permutation import count_scan, random_permutations
from safepy_tpu_torch.ops.score import (zscore_from_contractions,
                                        zscore_shift)


def _pad_rows_to(x, rows: int):
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, rows - x.shape[0]))


def band_score(s_ind, vals, *, bt: int, block: int = 128,
               score_type: str = "sum", precision: str = "highest",
               blocks=None, row_block_offset: int = 0):
    """Observed neighborhood scores from the banded indicator (``:44``).

    vals: (n, A) attribute values with NaNs, rows in the permuted frame.
    Returns (npad, A) f32 scores (permuted frame; rows past n are padding).
    A row shard of the band passes ``blocks`` and ``row_block_offset``
    (``ops.apsp_bandstore._block_range``) and gets the rows of its real
    block-rows (``band_sharded._band_score_local`` :253).
    """
    npad = -(-vals.shape[0] // block) * block
    kw = dict(bt=bt, block=block, precision=precision, blocks=blocks,
              row_block_offset=row_block_offset)
    vals = vals.to(torch.float32)
    mask = torch.isfinite(vals)
    B = _pad_rows_to(torch.where(mask, vals, torch.zeros_like(vals)), npad)

    if score_type == "sum":
        return band_matmul(s_ind, B, **kw)
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")

    NB = _pad_rows_to(mask.to(torch.float32), npad)
    c = zscore_shift(B, NB)  # pad rows are (0, 0): no effect on the mean
    Bs = B - NB * c
    out = band_matmul(s_ind, torch.cat([Bs, NB, Bs * Bs], dim=1), **kw)
    AB, N, EXX_sum = torch.chunk(out, 3, dim=1)
    return zscore_from_contractions(AB, N, EXX_sum, shift=c)


def valid_frame_map(valid: torch.Tensor, rank: torch.Tensor):
    """(sigma, sigma_inv): banded-order valid row t is original-order valid
    row sigma[t]. valid: (n,) bool in the permuted frame; rank: (n,) original
    node -> permuted position."""
    n = rank.shape[0]
    order = torch.empty_like(rank)
    order[rank] = torch.arange(n, device=rank.device)
    valid_rank = torch.cumsum(valid[rank].to(torch.int64), 0) - 1
    sigma = valid_rank[order[valid]]
    sigma_inv = torch.empty_like(sigma)
    sigma_inv[sigma] = torch.arange(sigma.shape[0], device=sigma.device)
    return sigma, sigma_inv


def scan_counts_band(compact, starts, vals, mask, obs, frame_map, *,
                     score_type: str, num_permutations: int, batch_size: int,
                     bt: int, block: int = 128, precision: str = "highest",
                     generator: torch.Generator | None = None, perm_idx=None,
                     blocks=None, row_block_offset: int = 0):
    """Two-sided permutation counts against the compacted band (``:70``).

    compact: ((nb + 2 bt) b, w_c) valid-column-compacted indicator
    (``ops.apsp_bandstore.compact_band_columns``); starts: (nb,) slab starts
    in the valid-rank frame; vals, mask: (V, A) NaN->0 values and finite
    masks of the valid rows in permuted order; obs: (npad, A) observed scores
    in the permuted frame. Permutations come from ``perm_idx`` (P, V) or
    ``generator`` and index the valid rows in original order;
    ``frame_map`` = :func:`valid_frame_map` carries them into the banded
    frame.

    Sum scores go through the fused ``band_count_batch``; z-scores through
    ``band_matmul_batch`` and ``count_scan``. Returns int32 (npad, A)
    counts_neg, counts_pos. A row shard (``blocks``, ``row_block_offset``:
    ``ops.apsp_bandstore._block_range``) passes the compacted rows it holds
    and ``obs`` of its real block-rows and gets their counts; every shard
    draws the same permutations (``band_sharded._scan_counts_local`` :278).
    """
    V, A = vals.shape
    dev = vals.device
    w_c = compact.shape[1]
    v_pad = V + w_c  # slack so starts[i] + w_c never overruns
    if perm_idx is not None:
        perm_idx = torch.as_tensor(perm_idx, dtype=torch.int64, device=dev)
        if tuple(perm_idx.shape) != (num_permutations, V):
            raise ValueError(f"perm_idx must be ({num_permutations}, {V}), "
                             f"got {tuple(perm_idx.shape)}")
    elif generator is None:
        raise ValueError("scan_counts_band needs a generator or perm_idx")
    sigma, sigma_inv = frame_map
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    kw = dict(bt=bt, block=block, precision=precision, blocks=blocks,
              row_block_offset=row_block_offset)

    zscore = score_type == "z-score"
    shift = None
    if zscore:
        # centre once before permuting (ops.score.zscore_shift: exact,
        # commutes with the row permutation)
        shift = zscore_shift(vals, mask)
        vals = vals - mask * shift

    def permuted(start, count):
        idx = (perm_idx[start:start + count] if perm_idx is not None
               else random_permutations(count, V, generator))
        idx = sigma_inv[idx[:, sigma]]
        Bp = vals[idx]
        if zscore:
            Bp = torch.cat([Bp, mask[idx], Bp * Bp], dim=-1)
        return F.pad(Bp, (0, 0, 0, v_pad - V))  # (C, v_pad, A) or (.., 3A)

    if zscore:
        def chunk_scores(start, count):
            out = band_matmul_batch(compact, permuted(start, count), starts,
                                    **kw)
            AB, Np, EXX_sum = torch.chunk(out, 3, dim=-1)
            return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)

        return count_scan(chunk_scores, obs, num_permutations=num_permutations,
                          batch_size=batch_size)

    counts_neg = torch.zeros(obs.shape, dtype=torch.int32, device=dev)
    counts_pos = torch.zeros_like(counts_neg)
    for start in range(0, num_permutations, batch_size):
        count = min(batch_size, num_permutations - start)
        cn, cp = band_count_batch(compact, permuted(start, count), starts,
                                  obs, **kw)
        counts_neg += cn
        counts_pos += cp
    return counts_neg, counts_pos
