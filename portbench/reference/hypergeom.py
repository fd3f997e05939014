"""The hypergeometric test of binary annotations (safepy
``compute_pvalues_by_hypergeom``), in plain torch: f64, or f32 with
``lowered`` (the control).

For an (n, A) 0/1 annotation matrix whose unannotated genes are NaN rows and
an (n, n) neighborhood indicator: the population M is the annotated genes,
a term's K its members, a neighborhood's size n its annotated genes and its
count k the term's members in it. A cell's p-value is P(X >= k) for X ~
Hypergeometric(M, K, n) (safepy's ``hypergeom.sf(k - 1, M, K, n)``), its
NES -log10 of it, and it is enriched where the p-value is below the
threshold. The census (k and n) is two contractions of the indicator; each
log P(X >= k) is a log-sum-exp of the pmf terms j = k..min(K, n), each from
a table of log-factorials, or, where the p-value is above 1/2, log(1 - the
sum of the terms below k), which keeps its relative accuracy. Cells with
k = 0 read log P = 0. Nothing here is the program's: no class table, no
recurrence, no band.
"""

from __future__ import annotations

import math

import torch

LN2 = math.log(2.0)
LN10 = math.log(10.0)
# pmf terms (cells x support) evaluated at once
CELLS_X_TERMS = 2 ** 24


def log_factorials(m: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(m + 1,) log(x!) for x = 0..m, ``lgamma(x + 1)`` in ``dtype``."""
    x = torch.arange(m + 1, dtype=torch.float64, device=device)
    return torch.lgamma(x + 1.0).to(dtype)


def log_sf(k: torch.Tensor, K: torch.Tensor, n: torch.Tensor, M: int,
           lf: torch.Tensor) -> torch.Tensor:
    """log P(X >= k), X ~ Hypergeometric(M, K, n), elementwise over 1-D
    int64 tensors, in ``lf``'s dtype (``lf``: :func:`log_factorials` of at
    least M). 0 where k is at most the support's lowest value; -inf past
    its highest."""
    out = torch.empty(k.shape, dtype=lf.dtype, device=k.device)
    if k.numel() == 0:
        return out
    lo = torch.clamp(n + K - M, min=0)
    hi = torch.minimum(K, n)
    terms = int((hi - lo).max()) + 1
    step = max(1, CELLS_X_TERMS // terms)
    offsets = torch.arange(terms, device=k.device)
    for c0 in range(0, k.numel(), step):
        sl = slice(c0, c0 + step)
        kc, Kc, nc = k[sl, None], K[sl, None], n[sl, None]
        loc, hic = lo[sl, None], hi[sl, None]
        j = loc + offsets                         # (cells, terms)
        inside = j <= hic
        j = torch.where(inside, j, loc)
        log_pmf = (lf[Kc] - lf[j] - lf[Kc - j]
                   + lf[M - Kc] - lf[nc - j] - lf[M - Kc - nc + j]
                   - (lf[M] - lf[nc] - lf[M - nc]))
        log_pmf = log_pmf.masked_fill(~inside, -math.inf)
        at_or_above = j >= kc
        upper = torch.logsumexp(log_pmf.masked_fill(~at_or_above, -math.inf),
                                dim=1)
        below = torch.logsumexp(log_pmf.masked_fill(at_or_above, -math.inf),
                                dim=1)
        out[sl] = torch.where(upper < -LN2, upper,
                              torch.log1p(-torch.exp(below)))
    return out.clamp_(max=0.0)


class Population:
    """What the test needs of one annotation matrix besides the
    neighborhoods, on ``device``: the 0/1 matrix with NaN set to 0 (x0),
    the annotated rows (an (n,) 0/1 column), M, each term's K and the
    log-factorial table, in ``dtype``."""

    def __init__(self, values, device, dtype=torch.float64):
        x = torch.as_tensor(values, device=device).to(torch.float64)
        finite = ~torch.isnan(x)
        self.dtype = dtype
        self.x0 = torch.where(finite, x, 0.0).to(dtype)
        self.annotated = finite.any(dim=1).to(dtype)
        self.M = int(finite.any(dim=1).sum())
        self.K = torch.where(finite, x, 0.0).sum(dim=0).round().to(
            torch.int64)
        self.lf = log_factorials(self.M, dtype, device)

    def census(self, nbr_rows: torch.Tensor):
        """(k (S, A), n (S,)) int64 of a block of indicator rows: the
        contractions of the rows with the matrix and the annotated column."""
        a = nbr_rows.to(self.dtype)
        return ((a @ self.x0).round().to(torch.int64),
                (a @ self.annotated).round().to(torch.int64))

    def block_log_sf(self, nbr_rows: torch.Tensor) -> torch.Tensor:
        """(S, A) log P(X >= k) of a block of indicator rows: cells with
        k >= 1 by :func:`log_sf`, the rest 0."""
        k, n = self.census(nbr_rows)
        out = torch.zeros(k.shape, dtype=self.dtype, device=k.device)
        rows, cols = torch.nonzero(k >= 1, as_tuple=True)
        out[rows, cols] = log_sf(k[rows, cols], self.K[cols], n[rows],
                                 self.M, self.lf)
        return out


def log_sf_matrix(nbr: torch.Tensor, values, *, block: int = 512,
                  lowered: bool = False) -> torch.Tensor:
    """(n, A) log p-values of every neighborhood (rows of the (n, n) bool
    indicator ``nbr``) and term (columns of ``values``, 0/1 with NaN rows),
    on ``nbr``'s device, row block by row block: f64, or f32 with
    ``lowered``."""
    pop = Population(values, nbr.device,
                     torch.float32 if lowered else torch.float64)
    return torch.cat([pop.block_log_sf(nbr[r0:r0 + block])
                      for r0 in range(0, nbr.shape[0], block)])


def nes(log_p: torch.Tensor) -> torch.Tensor:
    """SAFE's NES of a binary test, -log10 p, in ``log_p``'s dtype."""
    return -log_p / LN10


def enriched(log_p: torch.Tensor, threshold: float) -> torch.Tensor:
    """SAFE's call: the p-value below ``threshold``, decided on ``log_p``
    in its own dtype."""
    return log_p < math.log(threshold)
