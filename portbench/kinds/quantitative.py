"""``quantitative``: one screen's quantitative attribute sets under an
empirical permutation null.

The mix file gives ``pool`` (sets made at set-up, which the window cycles
through), ``attributes`` (the conditions, columns, of one set: default 1),
``nan_share`` (``{"default": s, "<config>": s}``; the pool shares one NaN
mask, since the same genes are missing from every condition of a screen)
and ``num_permutations``. The null's permutations are made on the device at
set-up, one (P, V) int64 tensor, and passed to every analysis as
``run_pipeline(perm_idx=...)``, so that what is timed is what is compared.

A kind module gives ``NUMBERS``, ``make``, ``run_kwargs``, ``keep``,
``Reference`` (with ``lowered`` the control) and ``Judge``. Its numbers,
besides ``nbhd_ulps`` (``compare``), each a largest reading over what was
compared:

- ``score_rel``: the largest |score - reference| over the sum of the
  magnitudes that the score adds up, on rows whose neighborhood is the
  reference's.
- ``count_flips_ppm``: the null comparisons (rows x permutations x two
  sides) that the program's counts decide otherwise than the reference's,
  per million, on those rows.
- ``count_max_diff``: the largest difference of one row's count.
- ``nes_binary_bad``: cells whose enrichment call is not what SAFE's rule
  gives from the counts the program returned (exact: limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, generators, traffic
from portbench.reference import enrichment as ref_enr

NUMBERS = ("nbhd_ulps", "score_rel", "count_flips_ppm", "count_max_diff",
           "nes_binary_bad")


def make(cell, network, seed: int, device) -> dict:
    """The pool, its annotated rows and the permutations of one run."""
    pool_seed, perm_seed = traffic.seeds(seed, 2)
    mix = cell.traffic
    pool = generators.quantitative_pool(
        len(network.coords), int(mix["pool"]),
        traffic.nan_share(mix, cell.config_name), pool_seed,
        int(mix.get("attributes", 1)))
    valid = np.flatnonzero(np.isfinite(pool[0]).any(axis=1))
    perm = traffic.permutations(int(mix["num_permutations"]), len(valid),
                                perm_seed, device)
    return dict(pool=pool, valid=valid, perm=perm)


def run_kwargs(inputs) -> dict:
    return dict(perm_idx=inputs.perm)


def keep(sf) -> dict:
    """What the comparison reads of an analysis, as the session holds it."""
    return dict(ns=sf.ns, counts_neg=sf.counts_neg, counts_pos=sf.counts_pos,
                nes_binary=sf.nes_binary)


class Reference:
    """The plain reference of one run: its neighborhoods and, per pool
    entry, its scores and null counts. ``lowered``: bfloat16 distances and
    TF32 contractions (the control)."""

    def __init__(self, inputs, device, *, lowered: bool = False,
                 block: int = 512):
        self.inputs = inputs
        self.device = device
        self.lowered = lowered
        self.block = block
        self.nbr = compare.Neighborhoods(inputs, device, lowered=lowered,
                                         block=block)
        self.valid = torch.as_tensor(inputs.valid, device=device)
        self._null = {}

    def neighborhoods(self) -> torch.Tensor:
        return self.nbr.indicator()

    def null(self, pool_index: int):
        """(obs, absum, counts_neg, counts_pos) of pool entry
        ``pool_index``, (n, A) each, on the host (f64, int64)."""
        if pool_index not in self._null:
            nbr, n = self.nbr.indicator(), self.nbr.n
            values = self.inputs.pool[pool_index]
            cols = []
            for j in range(values.shape[1]):
                x = torch.as_tensor(values[:, j], device=self.device)
                parts = [ref_enr.block_null(nbr[r0:r0 + self.block], x,
                                            self.valid, self.inputs.perm,
                                            lowered=self.lowered)
                         for r0 in range(0, n, self.block)]
                cols.append([torch.cat([p[i] for p in parts]).cpu().numpy()
                             for i in range(4)])
            self._null[pool_index] = tuple(
                np.stack([c[i] for c in cols], axis=1) for i in range(4))
        return self._null[pool_index]

    def outputs(self, pool_index: int) -> dict:
        """One analysis's outputs as the program returns them: the
        reference in the program's place (the control, when lowered)."""
        obs, _, cn, cp = self.null(pool_index)
        P = int(self.inputs.perm.shape[0])
        return dict(ns=obs, counts_neg=cn, counts_pos=cp,
                    nes_binary=nes_binary_np(cn, cp, P))


class Judge(compare.Judge):
    """Holds outputs against the f64 :class:`Reference`."""

    def __init__(self, inputs, device, *, block: int = 512):
        super().__init__(inputs, device, NUMBERS, block=block)
        self.ref = Reference(inputs, device, block=block)
        self.ref.nbr = self.nbr     # one indicator for both

    def judge_analysis(self, pool_index: int, out: dict):
        """Reads the numbers of one analysis's outputs (ns, counts_neg,
        counts_pos, nes_binary) on the rows whose neighborhood agrees."""
        obs, absum, cn, cp = self.ref.null(pool_index)
        shape = obs.shape
        ns = np.asarray(out["ns"], np.float64).reshape(shape)
        got_cn = np.asarray(out["counts_neg"], np.int64).reshape(shape)
        got_cp = np.asarray(out["counts_pos"], np.int64).reshape(shape)
        rows = np.flatnonzero(self.agree)
        P = int(self.inputs.perm.shape[0])
        scale = np.maximum(absum[rows], np.finfo(np.float64).tiny)
        rel = np.abs(ns[rows] - obs[rows]) / scale
        d_neg = np.abs(got_cn[rows] - cn[rows])
        d_pos = np.abs(got_cp[rows] - cp[rows])
        call = nes_binary_np(got_cn, got_cp, P)
        bad = int((np.asarray(out["nes_binary"]).reshape(shape).astype(bool)
                   != call).sum())
        r = self.readings
        r["score_rel"] = max(r["score_rel"], float(rel.max(initial=0.0)))
        r["count_flips_ppm"] = max(
            r["count_flips_ppm"],
            float((d_neg + d_pos).sum()) / max(1, 2 * P * d_neg.size) * 1e6)
        r["count_max_diff"] = max(r["count_max_diff"], float(
            np.maximum(d_neg, d_pos).max(initial=0)))
        r["nes_binary_bad"] = max(r["nes_binary_bad"], float(bad))
        self.checked += 1


def nes_binary_np(counts_neg, counts_pos, num_permutations: int,
                  threshold: float = 0.05) -> np.ndarray:
    """SAFE's enrichment call from null counts, on the host in f64 (safepy
    ``compute_pvalues_by_randomization``, ``attribute_sign='both'``)."""
    out = ref_enr.nes_binary(torch.as_tensor(counts_neg),
                             torch.as_tensor(counts_pos), num_permutations,
                             threshold)
    return out.numpy()
