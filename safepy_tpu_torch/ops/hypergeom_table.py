"""Class-table hypergeometric survival engine for binary annotations, dense.

Port of the dense subset of ``safepy_tpu/ops/hypergeom_table.py``. With 0/1
annotations every cell's ``sf(k; M, K, n)`` depends only on (k, K, n) with M
fixed, so the whole surface is a table over (distinct K) x (neighborhood
size n = 0..R-1) x (count k), built by ONE downward f64 recurrence per class

    T(hi) = 1;  T(t) = 1 + rho(t) T(t+1);  sf(t) = pmf(t) T(t),

``rho(t) = pmf(t+1)/pmf(t)`` an exact small-integer ratio, anchored at
``log pmf(hi)`` from a gather-free Stirling series, and every cell is then
resolved by one gather. The table stores f32 log sf; the significance
decision is made on the f64 value and carried by nudging the stored value
off the f32 threshold by at most one ulp, so ``stored < thr32`` reproduces
it and enriched counts are exact.

:func:`build_logsf_table` builds a CUDA table with one launch of the
hand-written kernel ``csrc/hypergeom_table.cu`` (built by
:mod:`safepy_tpu_torch.native`), bitwise equal to the slot loop
:func:`_build_logsf_table_torch` run on the card, and any other table with
that loop; :data:`LAUNCHES` counts the kernel's launches.

Only the gather form of :func:`table_lookup` is ported: JAX's slot loop
(``_lookup_slot_loop`` :228) exists because the TPU serializes element
gathers, and is bit-identical to the gather. The chunk planner :func:`plan`
serves the band engines (``ops/enrich_band.hypergeom_band_table``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from safepy_tpu_torch.ops.hypergeom import flush_subnormal

_LN_2PI = float(np.log(2.0 * np.pi))
_RENORM = 1e250
_LN_RENORM = float(np.log(_RENORM))
# stored f32 for impossible slots (k > support); no real count lands there
_SENTINEL = float(np.float32(-1e30))

# kernel launches since the last reset_launches(), as ops.apsp_cuda counts
LAUNCHES = {"logsf_table": 0}


def reset_launches() -> None:
    LAUNCHES["logsf_table"] = 0


def route(device) -> str:
    """How :func:`build_logsf_table` builds a table on ``device``: ``'cuda'``
    (the kernel) on a CUDA device, ``'torch'`` (the slot loop) elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def log_factorial(x: torch.Tensor) -> torch.Tensor:
    """ln(x!) = lgamma(x + 1) for integer-valued x >= 0, f64, gather-free
    (``:54``): the Stirling series at z = x + 1 shifted to z >= 17, the
    shift divided out with one log of an exactly accumulated product."""
    x = x.to(torch.float64)
    z = x + 1.0
    shift = z < 17.0
    prod = torch.ones_like(z)
    for i in range(16):
        prod = prod * torch.where(shift, z + i, 1.0)
    zb = torch.where(shift, z + 16.0, z)
    zi2 = 1.0 / (zb * zb)
    series = (1.0 / 12.0 + zi2 * (-1.0 / 360.0 + zi2 *
                                  (1.0 / 1260.0 - zi2 / 1680.0))) / zb
    lg = (zb - 0.5) * torch.log(zb) - zb + 0.5 * _LN_2PI + series
    return lg - torch.log(prod)


def table_geometry(K_values, n_max: int, M: int):
    """(R, S_max) of one table (``:76``): R rows cover neighborhood sizes
    0..n_max, S_max slots counts 0..min(K_max, n_max) + 1, each a power of
    two (R from 128, S_max from 64)."""
    r = 128
    while r < int(n_max) + 1:
        r *= 2
    k_max = int(max(1, np.max(K_values))) if len(K_values) else 1
    s_max = 64
    while s_max < int(min(k_max, n_max) + 2):
        s_max *= 2
    return r, s_max


def build_logsf_table(K_dist: torch.Tensor, M, log_thr, *, R: int,
                      S_max: int, C: int) -> torch.Tensor:
    """(S_max, C, R) f32 table of threshold-nudged log sf (``:108``) on the
    device of ``K_dist`` (C class totals).

    Slot ``s`` holds k = S_max - 1 - s for class ``K = K_dist[c]`` and
    neighborhood size n = row index. On a CUDA device one kernel launch
    builds the table on the current stream, without a synchronize; elsewhere
    :func:`_build_logsf_table_torch` does, the same function.
    """
    build = (_build_logsf_table_cuda if route(K_dist.device) == "cuda"
             else _build_logsf_table_torch)
    return build(K_dist, M, log_thr, R=R, S_max=S_max, C=C)


def _build_logsf_table_cuda(K_dist, M, log_thr, *, R: int, S_max: int,
                            C: int) -> torch.Tensor:
    """:func:`build_logsf_table` by the kernel: one thread a (class, size)
    pair walks the slots in registers (``csrc/hypergeom_table.cu``). The f32
    threshold and the largest f32 below it are computed here, as the torch
    loop computes them on the device."""
    from safepy_tpu_torch import native

    if min(R, S_max, C) < 1 or C * R >= 2 ** 31:
        raise ValueError(f"class table geometry out of range: R={R} "
                         f"S_max={S_max} C={C}")
    if K_dist.shape != (C,):
        raise ValueError(f"K_dist must hold the C={C} class totals, got "
                         f"shape {tuple(K_dist.shape)}")
    K = K_dist.to(torch.float64).contiguous()
    table = torch.empty((S_max, C, R), dtype=torch.float32,
                        device=K_dist.device)
    log_thr64 = float(log_thr)
    thr32 = np.float32(log_thr64)
    thr_lo32 = np.nextafter(thr32, np.float32(-np.inf))
    stream = torch.cuda.current_stream(K_dist.device).cuda_stream
    native.launch("logsf_table", ctypes.c_void_p(table.data_ptr()),
                  ctypes.c_void_p(K.data_ptr()), R, S_max, C, float(M),
                  log_thr64, float(thr32), float(thr_lo32),
                  ctypes.c_void_p(stream))
    LAUNCHES["logsf_table"] += 1
    return table


def _build_logsf_table_torch(K_dist: torch.Tensor, M, log_thr, *, R: int,
                             S_max: int, C: int) -> torch.Tensor:
    """:func:`build_logsf_table` as a loop of torch ops over the slots, on
    any device: the CPU path, and the plain version the kernel is held to
    on the card. One downward pass over k computes every class at once; T
    is renormalized by 1e250 against overflow."""
    f64, f32 = torch.float64, torch.float32
    dev = K_dist.device
    K = K_dist.to(f64)[:, None]                                 # (C, 1)
    n = torch.arange(R, dtype=f64, device=dev)[None, :]         # (1, R)
    M64 = float(M)
    lo = torch.clamp(n + K - M64, min=0.0)
    hi = torch.minimum(K, n)

    # anchor: log pmf(hi) = log [C(K,hi) C(M-K,n-hi) / C(M,n)]
    F = log_factorial
    m_t = torch.tensor(M64, dtype=f64, device=dev)
    anchor = (F(K) - F(hi) - F(K - hi)
              + F(M64 - K) - F(n - hi) - F(M64 - K - n + hi)
              - (F(m_t) - F(n) - F(M64 - n)))

    log_thr64 = float(log_thr)
    thr32 = torch.tensor(log_thr64, dtype=f32, device=dev)
    # one ulp below the f32 threshold: the largest f32 strictly less than it
    thr_lo32 = torch.nextafter(thr32, torch.tensor(-np.inf, dtype=f32,
                                                   device=dev))
    sentinel = torch.tensor(_SENTINEL, dtype=f32, device=dev)
    zero32 = torch.zeros((), dtype=f32, device=dev)

    shape = (C, R)
    log_pmf = torch.zeros(shape, dtype=f64, device=dev)   # live below hi
    tm = torch.ones(shape, dtype=f64, device=dev)         # T mantissa
    te = torch.zeros(shape, dtype=torch.int32, device=dev)  # T exponent
    table = torch.empty((S_max, C, R), dtype=f32, device=dev)
    for s in range(S_max):
        t64 = float(S_max - 1 - s)
        at_hi = hi == t64
        below = hi > t64

        num = (K - t64) * (n - t64)
        den = (t64 + 1.0) * (M64 - K - n + t64 + 1.0)
        rho = num / torch.where(den == 0.0, 1.0, den)
        safe_rho = torch.where(rho > 0.0, rho, 1.0)

        log_pmf = torch.where(at_hi, anchor,
                              torch.where(below, log_pmf - torch.log(safe_rho),
                                          log_pmf))
        tm = torch.where(at_hi, 1.0, torch.where(below, 1.0 + rho * tm, tm))
        te = torch.where(at_hi, 0, te)
        over = tm > _RENORM
        tm = torch.where(over, tm / _RENORM, tm)
        te = te + over.to(torch.int32)

        log_sf = torch.clamp(
            log_pmf + torch.log(tm) + te.to(f64) * _LN_RENORM, max=0.0)
        val32 = flush_subnormal(log_sf.to(f32))
        sig = log_sf < log_thr64          # the f64 significance decision
        stored = torch.where(sig, torch.minimum(val32, thr_lo32),
                             torch.maximum(val32, thr32))
        table[s] = torch.where(lo >= t64, zero32,
                               torch.where(hi < t64, sentinel, stored))
    return table


def table_lookup(table, counts, nsize, colc, log_thr32, *, S_max: int,
                 R: int, C: int):
    """Resolve (N, A) cells against the class table with one gather
    (``:189``, its gather form).

    counts: (N, A) f32 integer-valued census; nsize: (N,) f32 neighborhood
    sizes; colc: (A,) class index of each column. Returns (nes f32, log sf
    f32, indicator int8).
    """
    k = torch.clamp(torch.round(counts).to(torch.int64), 0, S_max - 1)
    n_i = torch.clamp(torch.round(nsize).to(torch.int64), 0, R - 1)
    idx = ((S_max - 1 - k) * (C * R)
           + colc.to(torch.int64)[None, :] * R + n_i[:, None])
    logsf = table.reshape(-1)[idx.clamp_(0, table.numel() - 1)]
    thr = torch.tensor(float(log_thr32), dtype=torch.float32,
                       device=logsf.device)
    nbin = (logsf < thr).to(torch.int8)
    ln10 = torch.tensor(np.float32(np.log(10.0)), device=logsf.device)
    nes = -logsf / ln10
    return nes, logsf, nbin


def plan(K_np, n_max, M: int, *, chunk_cols: int = 512,
         budget_cells: int = 12 * 10 ** 8,
         chunk_budget_cells: int = 4 * 10 ** 8):
    """Host plan of the chunked table engine (``:265``), or None where it
    does not apply.

    Eligible: integer K (binary annotations), an integer ``n_max`` (the
    largest neighborhood size), each chunk's table within
    ``chunk_budget_cells`` and their sum within ``budget_cells``. Chunks of
    ``chunk_cols`` columns run in natural column order, each with its own
    classes: ``K_dist`` (its distinct totals padded with zeros to a power of
    two, ``C``), ``colc`` (each column's class) and the geometry (``R``,
    ``S_max``) of :func:`table_geometry`.

    JAX then unifies the chunks' geometry (``_unify_chunk_signatures``
    :327) so that one compiled program serves the run; that is a
    compile-cache device, and the values of a cell do not depend on the
    geometry, so it is not ported. The chunks keep JAX's ``overlap`` key
    (columns a chunk recomputes from the one before; 0 here), which the
    engines trim from their per-chunk counts.
    """
    K_np = np.asarray(K_np, np.float64)
    if K_np.size == 0 or not np.all(K_np == np.floor(K_np)):
        return None
    if n_max != int(n_max):
        return None
    n_max = int(n_max)

    chunks = []
    total = 0
    for s in range(0, len(K_np), chunk_cols):
        kc = K_np[s:s + chunk_cols]
        k_dist, colc = np.unique(kc, return_inverse=True)
        r, s_max = table_geometry(k_dist, n_max, M)
        c = 1
        while c < len(k_dist):
            c *= 2
        k_dist_padded = np.zeros(c, np.float64)
        k_dist_padded[:len(k_dist)] = k_dist
        cells = r * s_max * c
        if cells > chunk_budget_cells:
            return None
        total += cells
        chunks.append(dict(start=s, width=len(kc), overlap=0,
                           K_dist=k_dist_padded,
                           colc=colc.reshape(-1).astype(np.int32), R=r,
                           S_max=s_max, C=c))
    if total > budget_cells:
        return None
    return dict(chunks=chunks, total_cells=total, n_max=n_max, M=int(M))
