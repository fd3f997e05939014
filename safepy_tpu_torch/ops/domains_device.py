"""Device work of the attribute -> domain stage.

Port of ``safepy_tpu/ops/domains_device.py``. The reference clusters the top
attributes by average linkage over the jaccard distances of their binary
enrichment columns, and scipy's linkage computes that pdist itself: A^2/2
pairs of N elements each. The jaccard of 0/1 columns needs only their
pairwise intersection counts, which are one GEMM, ``B^T B``; the division
runs on the host in f64 from the exact integer counts, which reproduces
scipy's double jaccard bit for bit, so ``linkage(condensed, 'average')``
returns scipy's own dendrogram (:56-81).

The same GEMM serves the node -> domain counts (``B @ onehot(domain)``, the
reference's groupby-sum) and a segment-max the per-domain NES maxima; both
read the session's device-resident indicator and NES.

The products run in f32 and return f32: 0/1 operands are exact, and f32
sums of them are exact integers below 2^24 nodes. (JAX feeds bf16 with an
f32 accumulator, ``:41-44``; a torch matmul of bf16 or fp16 tensors returns
bf16 or fp16, which would round every count above 256 or 2,048.) These are
plain large products and stay ``torch.matmul``: no hand-written kernel.

Every entry point takes tensors on their device, or numpy, which goes to the
``device`` it is given: a CUDA session's stage runs on the card or raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_device(x, dtype, device) -> torch.Tensor:
    """A tensor stays where it is; numpy goes to ``device`` in ``dtype``
    (the JAX module's ``jnp.asarray(np.asarray(x, dtype))``)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)


def enrichment_intersections(nes_binary, device="cuda") -> np.ndarray:
    """Host int32 (A, A) pairwise intersection counts of the 0/1 columns of
    ``nes_binary`` (N, A): a tensor (the session's int8 indicator) or numpy
    of any dtype (``:39-53``)."""
    b = _to_device(nes_binary, np.int8, device).to(torch.float32)
    return (b.T @ b).to(torch.int32).cpu().numpy()


def jaccard_condensed_from_counts(inter: np.ndarray) -> np.ndarray:
    """Condensed (scipy pdist-ordered) f64 jaccard distances from exact
    integer intersection counts (``:56-81``).

    scipy's double jaccard of 0/1 rows u, v is ``(|u| + |v| - 2 inter) /
    (|u| + |v| - inter)``, 0 when the union is empty; both operands are
    exact small integers in f64, so one correctly rounded division gives
    scipy's bits. Row slices keep the host's memory traffic contiguous."""
    a = inter.shape[0]
    card = np.diag(inter).astype(np.float64)
    out = np.empty(a * (a - 1) // 2, dtype=np.float64)
    pos = 0
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(a - 1):
            row = inter[i, i + 1:].astype(np.float64)
            s = card[i] + card[i + 1:]
            union = s - row
            d = (s - 2.0 * row) / union
            d[union == 0.0] = 0.0
            out[pos:pos + a - i - 1] = d
            pos += a - i - 1
    return out


def domain_counts(b: torch.Tensor, dom: torch.Tensor,
                  num_domains: int) -> torch.Tensor:
    """(N, D) int32: per node, how many domain-d attributes it is enriched
    for, ``B @ onehot(domain)`` (``:84-95``). ``dom`` (A,) int64 domain
    positions."""
    onehot = (dom[:, None] == torch.arange(num_domains, device=dom.device)
              [None, :]).to(torch.float32)
    return (b.to(torch.float32) @ onehot).to(torch.int32)


def domain_max_nes(nes: torch.Tensor, dom: torch.Tensor,
                   num_domains: int) -> torch.Tensor:
    """(N, D): per node, the maximum NES over each domain's attribute
    columns (``:98-106``); NaN counts as -inf, and a domain without a
    finite value gives -inf (the -inf start of the reduction)."""
    clean = torch.where(torch.isnan(nes), torch.full_like(nes, -np.inf), nes)
    out = torch.full((nes.shape[0], num_domains), -np.inf, dtype=nes.dtype,
                     device=nes.device)
    return out.scatter_reduce_(1, dom.expand(nes.shape[0], -1), clean, "amax")


def indicator_csc(nes_binary_dev: torch.Tensor, column_counts):
    """scipy CSC view of a device 0/1 indicator (``:129-153``): the row
    indices of its nonzeros in column-major order cross to the host, not the
    dense matrix. ``column_counts`` (A,): the enriched counts per attribute,
    whose sum cross-checks the nonzeros.

    JAX ships a column-major bitmap instead (``:109-126``), for its slow
    device-to-host relay and its slow device sort; ``torch.nonzero`` over
    the transposed view gives the same order directly."""
    import scipy.sparse as sp

    n, a = nes_binary_dev.shape
    counts = np.asarray(column_counts, dtype=np.int64)
    nnz = int(counts.sum())
    if nnz == 0:
        return sp.csc_matrix((n, a), dtype=np.int8)
    rows = torch.nonzero(nes_binary_dev.T)[:, 1].to(torch.int32).cpu().numpy()
    if len(rows) != nnz:
        raise AssertionError(
            f"indicator nonzero count {len(rows)} != enriched-count sum "
            f"{nnz}; the facade's counts are stale")
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return sp.csc_matrix((np.ones(nnz, np.int8), rows, indptr), shape=(n, a))


def domain_aggregates(nes_binary, nes, domain_of_attr, num_domains: int,
                      device="cuda"):
    """Host (counts (N, D) int64, max_nes (N, D) f64) from the device GEMM
    and segment-max (``:156-171``). ``nes_binary`` / ``nes``: tensors, or
    numpy that goes to ``device`` as int8 and f32 (a host f64 NES rounds to
    f32 there, as JAX's upload rounds it)."""
    b = _to_device(nes_binary, np.int8, device)
    nv = _to_device(nes, np.float32, device)
    dom = torch.as_tensor(np.asarray(domain_of_attr, np.int64),
                          device=b.device)
    counts = domain_counts(b, dom, num_domains).cpu().numpy().astype(np.int64)
    max_nes = (domain_max_nes(nv, dom.to(nv.device), num_domains)
               .cpu().numpy().astype(np.float64))
    return counts, max_nes
