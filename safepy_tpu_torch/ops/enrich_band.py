"""Enrichment statistics over band-storage neighborhoods, never densified.

Port of ``safepy_tpu/ops/enrich_band.py``. Quantitative attributes:
:func:`band_score` (sum and z-score, ``:44``) and :func:`scan_counts_band`
(the two-sided null, ``:70``, gather engine). Binary attributes (the
hypergeometric test, reference safe.py:556-608) with the census as banded
products:

- :func:`hypergeom_core_band` (``:138``): census + per-cell f64 survival
  tail + device finalization, optionally in attribute chunks;
- :func:`hypergeom_band_hostchunks` (``:245``): the tail in K-sorted column
  chunks, each with its own iteration bound;
- :func:`hypergeom_band_table` (``:431``): the class-table engine
  (:mod:`.hypergeom_table`) chunk by chunk into preallocated outputs.

Everything lives in the permuted (banded-order) node frame; callers
un-permute the row outputs, or pass ``rank`` and get them in the original
frame. The indicator band may be int8 or bit-packed: every contraction goes
through the banded products of :mod:`.apsp_bandstore`, which unpack a packed
band one group of block-rows at a time.

Permutations are drawn as in :mod:`.permutation`: ``torch.rand(C, V).argsort``
rows from the session's generator, or an explicit ``perm_idx`` (P, V), both
indexing the valid rows in ORIGINAL node order. ``sigma`` maps them into the
banded frame, so both engines of the port draw the same permutations from
the same seed or ``perm_idx``. The key-sort engine is a TPU workaround and is
not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from safepy_tpu_torch.ops import hypergeom_table as htab
from safepy_tpu_torch.ops.apsp_bandstore import (_GROUP_ELEMS,
                                                 band_count_batch,
                                                 band_matmul,
                                                 band_matmul_batch,
                                                 band_width)
from safepy_tpu_torch.ops.hypergeom import tail_device, tail_iterations
from safepy_tpu_torch.ops.permutation import count_scan, random_permutations
from safepy_tpu_torch.ops.score import (zscore_from_contractions,
                                        zscore_shift)
from safepy_tpu_torch.profiling import span


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
    # a boolean index: the host waits for the device to size the result
    with span("facade.wait", site="valid_frame_map"):
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
    (``ops.apsp_bandstore.compact_band_columns``), int8 or bit-packed;
    starts: (nb,) slab starts in the valid-rank frame; vals, mask: (V, A)
    NaN->0 values and finite masks of the valid rows in permuted order;
    obs: (npad, A) observed scores in the permuted frame. Permutations come from ``perm_idx`` (P, V) or
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
    w_c = band_width(compact)  # counted in bits for a packed band (``:88``)
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
        def chunk_scores(Bp):
            out = band_matmul_batch(compact, Bp, starts, **kw)
            AB, Np, EXX_sum = torch.chunk(out, 3, dim=-1)
            return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)

        return count_scan((permuted, chunk_scores), obs,
                          num_permutations=num_permutations,
                          batch_size=batch_size, route="band")

    counts_neg = torch.zeros(obs.shape, dtype=torch.int32, device=dev)
    counts_pos = torch.zeros_like(counts_neg)
    for start in range(0, num_permutations, batch_size):
        count = min(batch_size, num_permutations - start)
        with span("enrichment.permute"):
            Bp = permuted(start, count)
        with span("enrichment.count"):
            cn, cp = band_count_batch(compact, Bp, starts, obs, **kw)
            del Bp
            counts_neg += cn
            counts_pos += cp
    return counts_neg, counts_pos


# ---------------------------------------------------------------------------
# Hypergeometric enrichment (binary annotations)
# ---------------------------------------------------------------------------

def _npad(s_ind, bt: int, block: int) -> int:
    return s_ind.shape[0] - 2 * bt * block


def hypergeom_core_band(s_ind, nan0, nodes_not_nan, K, lgt, M,
                        enrichment_threshold, *, iterations: int, bt: int,
                        block: int = 128, precision: str = "highest",
                        attr_chunk: int | None = None, rank=None,
                        blocks=None, row_block_offset: int = 0,
                        x_from_block: int | None = None):
    """Census + survival tail over the banded indicator from NaN-zeroed
    operands (``:138``).

    nan0: (n, A) annotations with NaN set to 0, rows in the permuted frame;
    nodes_not_nan: (n,) f32; K: (A,) per-attribute totals; lgt: the f64
    lgamma table over [0, M] on the band's device. ``rank`` (n,): un-permute
    the row outputs to the original frame (chunk by chunk when chunked).
    ``attr_chunk``: compute the tail over columns in chunks of this size,
    so that one chunk's f64 intermediates are live at a time; the last chunk
    clamps its start to ``A - attr_chunk`` and recomputes a few columns
    identically. Returns (log sf f32, indicator int8), (n, A) with ``rank``
    else (npad, A). A row shard of the band (``blocks``,
    ``row_block_offset``: ``ops.apsp_bandstore._block_range``) gets the
    rows of its real block-rows and passes no ``rank``
    (``band_sharded.py:515``); with ``x_from_block`` its operands are only
    its window of rows (``ops.apsp_bandstore.band_matmul``).
    """
    dev = s_ind.device
    nan0 = torch.as_tensor(nan0, device=dev).to(torch.float32)
    npad = -(-nan0.shape[0] // block) * block
    nnn = torch.as_tensor(nodes_not_nan, device=dev).to(torch.float32)
    K = torch.as_tensor(K, device=dev)
    A = nan0.shape[1]
    kw = dict(bt=bt, block=block, precision=precision, blocks=blocks,
              row_block_offset=row_block_offset, x_from_block=x_from_block)

    def gather(x):
        return x if rank is None else x.index_select(0, rank)

    if attr_chunk is None or attr_chunk >= A:
        stacked = _pad_rows_to(torch.cat([nnn[:, None], nan0], dim=1), npad)
        prod = band_matmul(s_ind, stacked, **kw)
        _nes, logsf, nbin = tail_device(prod[:, 1:], prod[:, 0], K, lgt, M,
                                        enrichment_threshold, iterations)
        return gather(logsf), gather(nbin)

    nsize = band_matmul(s_ind, _pad_rows_to(nnn[:, None], npad), **kw)[:, 0]
    nan0_r = _pad_rows_to(nan0, npad)
    out_rows = nsize.shape[0] if rank is None else rank.shape[0]
    logsf_b = torch.empty((out_rows, A), dtype=torch.float32, device=dev)
    bin_b = torch.empty((out_rows, A), dtype=torch.int8, device=dev)
    for ci in range(-(-A // attr_chunk)):
        start = min(ci * attr_chunk, A - attr_chunk)
        cols = slice(start, start + attr_chunk)
        counts = band_matmul(s_ind, nan0_r[:, cols], **kw)
        _nes, logsf_c, bin_c = tail_device(counts, nsize, K[cols], lgt, M,
                                           enrichment_threshold, iterations)
        logsf_b[:, cols] = gather(logsf_c)
        bin_b[:, cols] = gather(bin_c)
    return logsf_b, bin_b


def hypergeom_tail_band(s_ind, vals, lgt, M, enrichment_threshold, *,
                        iterations: int, bt: int, block: int = 128,
                        precision: str = "highest",
                        attr_chunk: int | None = None, rank=None):
    """:func:`hypergeom_core_band` from the raw NaN-carrying (n, A)
    annotations in the permuted frame (``:217``)."""
    vals = torch.as_tensor(vals, device=s_ind.device).to(torch.float32)
    finite = torch.isfinite(vals)
    nan0 = torch.where(finite, vals, torch.zeros_like(vals))
    nodes_not_nan = finite.any(dim=1).to(torch.float32)
    return hypergeom_core_band(s_ind, nan0, nodes_not_nan, nan0.sum(dim=0),
                               lgt, M, enrichment_threshold,
                               iterations=iterations, bt=bt, block=block,
                               precision=precision, attr_chunk=attr_chunk,
                               rank=rank)


def _iteration_bucket(iters: int) -> int:
    """The tail's iteration bound rounded up to a power of two, from 64
    (``:236``). JAX rounds to share compiled programs; the bound also
    decides how long a chunk's loop may run, so the port keeps it."""
    b = 64
    while b < iters:
        b *= 2
    return b


def hypergeom_band_hostchunks(s_ind, nan0_np, nodes_not_nan_np, lgt, M,
                              enrichment_threshold, *, bt: int,
                              block: int = 128, rank_np, attr_chunk: int,
                              precision: str = "highest"):
    """The f64 survival tail in host-driven column chunks (``:245``).

    The columns are sorted by their annotated total K, so each chunk's
    iteration bound (:func:`_iteration_bucket` of ``tail_iterations``)
    fits its own largest term; each chunk is one :func:`hypergeom_core_band`
    call with the row un-permute inside. The last chunk clamps its start and
    drops the columns it recomputes. The chunks are joined and put back in
    the original column order with one ``index_select``.

    nan0_np, nodes_not_nan_np: host f32 operands in the permuted row frame.
    Returns (log sf f32, indicator int8, enriched counts int32 (A,)) on the
    band's device, the (n, A) matrices in the original node frame.
    """
    dev = s_ind.device
    n_attrs = nan0_np.shape[1]
    K_np = nan0_np.sum(axis=0)
    order_a = np.argsort(K_np, kind="stable")
    inv_a = np.argsort(order_a, kind="stable")

    nan0_dev = torch.as_tensor(nan0_np[:, order_a], device=dev)
    nnn_dev = torch.as_tensor(nodes_not_nan_np, device=dev)
    rank_dev = torch.as_tensor(rank_np, dtype=torch.int64, device=dev)
    K_sorted = K_np[order_a]

    attr_chunk = min(attr_chunk, n_attrs)
    logsf_pieces, bin_pieces = [], []
    for ci in range(-(-n_attrs // attr_chunk)):
        start = min(ci * attr_chunk, n_attrs - attr_chunk)
        overlap = ci * attr_chunk - start
        K_c = K_sorted[start:start + attr_chunk]
        k_max = int(max(1.0, float(K_c.max()))) if K_c.size else 1
        iters = _iteration_bucket(tail_iterations(M, min(k_max, M)))
        logsf_c, bin_c = hypergeom_core_band(
            s_ind, nan0_dev[:, start:start + attr_chunk], nnn_dev,
            torch.as_tensor(K_c, dtype=torch.float32, device=dev), lgt, M,
            enrichment_threshold, iterations=iters, bt=bt, block=block,
            precision=precision, rank=rank_dev)
        logsf_pieces.append(logsf_c[:, overlap:])
        bin_pieces.append(bin_c[:, overlap:])
    del nan0_dev
    inv_dev = torch.as_tensor(inv_a, device=dev)

    def assemble(pieces):
        sorted_cols = torch.cat(pieces, dim=1)
        pieces.clear()
        return sorted_cols.index_select(1, inv_dev)

    logsf = assemble(logsf_pieces)
    nbin = assemble(bin_pieces)
    return logsf, nbin, nbin.sum(dim=0, dtype=torch.int32)


def _finite_mask(x):
    """``torch.isfinite(x)`` of a 2-D tensor, made row chunk by row chunk:
    isfinite takes an f32 ``|x|`` and two bool temporaries, which stay
    chunk-sized (64 MB of f32) here."""
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    step = max(1, _GROUP_ELEMS // max(1, x.shape[1]))
    for r0 in range(0, x.shape[0], step):
        out[r0:r0 + step] = torch.isfinite(x[r0:r0 + step])
    return out


def band_hyper_operands_device(n2a_dev, order, binary_ok=None):
    """(nan0 int8, nodes_not_nan f32, K f32, binary_ok) from the device
    annotation upload, rows gathered into the permuted frame by ``order``
    (permuted position -> original row) (``:322``). ``binary_ok`` may be
    given by a caller that counted the upload's non-0/1 values
    (:func:`upload_f32_counted`: a count of 0); else it is checked here.

    nan0 is stored int8: callers read it only when ``binary_ok`` (every
    finite value 0 or 1), where the cast is exact. The steps are ordered so
    that at most 9 bytes a cell are live with the f32 upload (the binary
    check's bool temporaries before the f32 copy; the copy freed before
    the gather; the finite mask made by row chunks): ``hbm.prep_peak``
    counts them."""
    finite = _finite_mask(n2a_dev)
    if binary_ok is None:
        binary_ok = bool(
            ((n2a_dev == 0.0) | (n2a_dev == 1.0) | ~finite).all())
    nan0 = torch.where(finite, n2a_dev, 0.0)
    nnn = finite.any(dim=1).to(torch.float32)
    del finite
    K = nan0.sum(dim=0)
    nan0_i8 = nan0.to(torch.int8)
    del nan0
    order = torch.as_tensor(order, device=n2a_dev.device)
    return (nan0_i8.index_select(0, order), nnn.index_select(0, order), K,
            binary_ok)


def _host_chunks(n2a_np, chunk_cols: int, device):
    """(first column, f32 device upload) of each column chunk of the host
    matrix: one chunk on the device at a time."""
    for j in range(0, n2a_np.shape[1], chunk_cols):
        with np.errstate(over="ignore"):  # as the host count casts
            x = np.asarray(n2a_np[:, j:j + chunk_cols], np.float32)
        yield j, torch.as_tensor(x, device=device)


def band_hyper_operands_chunked(n2a_np, order, chunk_cols: int = 512, *,
                                device):
    """:func:`band_hyper_operands_device` built from column-chunked uploads
    of the host matrix (``:365``): the int8 operands are written into one
    (n, A) buffer chunk by chunk, and the f32 (n, A) upload never exists;
    the rows are gathered once at the end. The int8 operands, the row
    validity and the flag equal the full-device build's; K too wherever
    it is read (integer totals of binary columns, exact in any order)."""
    n, a = n2a_np.shape
    buf = torch.empty((n, a), dtype=torch.int8, device=device)
    nnn_any = torch.zeros(n, dtype=torch.bool, device=device)
    K_parts, ok = [], True
    for j, x in _host_chunks(n2a_np, chunk_cols, device):
        finite = torch.isfinite(x)
        ok = ok and bool(((x == 0.0) | (x == 1.0) | ~finite).all())
        nan0 = torch.where(finite, x, 0.0)
        nnn_any |= finite.any(dim=1)
        del finite, x
        K_parts.append(nan0.sum(dim=0))
        buf[:, j:j + nan0.shape[1]] = nan0  # the int8 cast on the copy
        del nan0
    order = torch.as_tensor(order, device=device)
    return (buf.index_select(0, order),
            nnn_any.to(torch.float32).index_select(0, order),
            torch.cat(K_parts) if K_parts else torch.zeros(0, device=device),
            ok)


def count_other_values_chunked(n2a_np, chunk_cols: int = 512, *,
                               device) -> int:
    """Count of finite non-0/1 values of the f32 matrix (the reference's
    binary detection, reference safe.py:454-456) from column-chunked
    uploads (``:396``), never staging the whole f32 (n, A) on the
    device."""
    total = 0
    for _, x in _host_chunks(n2a_np, chunk_cols, device):
        total += int((torch.isfinite(x) & (x != 0.0) & (x != 1.0)).sum())
    return total


def upload_f32_counted(n2a_np, *, device):
    """(the f32 (n, A) device matrix, the count of its finite values that
    are not 0 or 1) from one f64 transfer of the host matrix, in blocks of
    whole rows of ``_GROUP_ELEMS // 4`` values (32 MiB). A block is read
    where it lies (copied only where it is not writable f64 with
    non-negative strides); for a card torch's threads copy it into pinned
    pages, whose copy to the card runs while they copy the next block (the
    pinned allocator keeps a block's pages until its copy is done). Each
    block is cast on the device into its rows of the f32 matrix, as numpy
    casts (nearest even, inf past f32's range, subnormals kept), and
    counted there (``:396``'s count, on the same f32 values); the total is
    read once at the end."""
    n, a = n2a_np.shape
    out = torch.empty((n, a), dtype=torch.float32, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    step = max(1, (_GROUP_ELEMS // 4) // max(1, a))
    for r0 in range(0, n, step):
        rows = np.require(n2a_np[r0:r0 + step], np.float64, "W")
        if min(rows.strides) < 0:
            rows = np.ascontiguousarray(rows)
        blk = torch.from_numpy(rows)
        x = out[r0:r0 + step]
        if x.is_cuda:
            blk = blk.pin_memory()
        x.copy_(blk.to(x.device, non_blocking=True))
        total += (torch.isfinite(x) & (x != 0.0) & (x != 1.0)).sum()
    return out, int(total)


def _column_sums_chunked(nan0_dev, chunk_cols: int = 1024) -> np.ndarray:
    """Per-attribute totals of an int8 (n, A) matrix, summed in f32 (exact
    below 2^24 rows) over column chunks, so that no f32 copy of the whole
    matrix exists (``:410``)."""
    a = nan0_dev.shape[1]
    return torch.cat([nan0_dev[:, j:j + chunk_cols].sum(dim=0,
                                                        dtype=torch.float32)
                      for j in range(0, a, chunk_cols)]).cpu().numpy()


def hypergeom_band_table(s_ind, nan0, nodes_not_nan, M,
                         enrichment_threshold, *, bt: int, block: int = 128,
                         rank_np, precision: str = "highest",
                         chunk_cols: int = 512, plan=None,
                         logsf_out: str = "device", K_np=None,
                         budget: int | None = None,
                         extra_resident_bytes: int = 0,
                         select_out: dict | None = None):
    """Hypergeometric enrichment of binary annotations by the class-table
    engine, column chunk by column chunk (``:431``).

    nan0: (n, A) int8 or f32 annotations with NaN set to 0, rows in the
    permuted frame (host or device); ``K_np``: their column totals if the
    caller has them. Each chunk of ``htab.plan`` is one banded census, one
    table build and one lookup with the row un-permute; its columns are
    copied into the outputs. While a profiler records, the spans
    ``enrichment.go_census`` mark the neighborhood sizes' contraction and
    each chunk's census, ``enrichment.go_table`` each table build (attrs
    ``R``, ``S_max``, ``C`` and ``route``: ``cuda`` where the kernel builds
    it, ``torch`` where the slot loop does), ``enrichment.go_lookup`` each
    chunk's lookup, un-permute, placement and count, and a ``facade.wait``
    (site ``go_n_max``) the read of the largest size.

    ``logsf_out``: where the (n, A) outputs live. ``'device'``: f32 log sf
    and int8 indicator on the device; ``'f16'``: the log sf stored f16 (the
    indicator and counts are decided in f64 before, so they stay exact);
    ``'host'``: numpy buffers filled chunk by chunk, equal to ``'device'``;
    ``'auto'``: the first of the three whose census peak fits ``budget``,
    chosen by ``hbm.census_select`` with the exact class-table bytes once
    the plan exists (the facade's pre-prep plan could not know them).

    Every mode is checked against ``budget`` (None: the device's,
    ``hbm.device_hbm_budget``, with the indicator band, the annotations
    already on the device and ``extra_resident_bytes`` counted as the
    run's own); nothing fitting raises ``ValueError`` before any (n, A)
    allocation. ``extra_resident_bytes``: caller-owned device residents to
    count (a kept f32 distance band, the f32 upload); ``select_out``, where
    given, is filled with the selection (JAX's out-parameter).

    Returns (log sf, indicator, enriched counts int32 (A,) on the device),
    the (n, A) matrices in the original node frame, or None when the plan
    is ineligible (non-integer totals, or a table over budget).
    """
    dev = s_ind.device
    ann_resident = (nan0.nbytes if isinstance(nan0, torch.Tensor)
                    and nan0.device == dev else 0)
    nan0_dev = torch.as_tensor(nan0, device=dev)
    if K_np is None:
        K_np = _column_sums_chunked(nan0_dev)
    K_np = np.asarray(K_np)
    npad = _npad(s_ind, bt, block)
    kw = dict(bt=bt, block=block, precision=precision)
    nnn_dev = torch.as_tensor(nodes_not_nan, device=dev).to(torch.float32)
    with span("enrichment.go_census"):
        nsize_dev = band_matmul(s_ind, _pad_rows_to(nnn_dev[:, None], npad),
                                **kw)[:, 0]
    if plan is None:
        with span("facade.wait", site="go_n_max"):
            n_max = float(nsize_dev.max())
        plan = htab.plan(K_np, n_max, int(M), chunk_cols=chunk_cols)
    if plan is None:
        return None
    if logsf_out not in ("device", "f16", "host", "auto"):
        raise ValueError(f"unknown logsf_out: {logsf_out!r}")
    from safepy_tpu_torch import hbm
    if budget is None:
        budget = hbm.device_hbm_budget(
            dev, own_bytes=s_ind.nbytes + ann_resident + extra_resident_bytes)
    sel = hbm.census_select(
        n=len(rank_np), n_attrs=nan0_dev.shape[1], rows=s_ind.shape[0],
        chunk_w=max(ch["width"] for ch in plan["chunks"]),
        ind_bytes=s_ind.nbytes, ann_bytes=nan0_dev.nbytes,
        table_bytes=4 * max(ch["R"] * ch["S_max"] * ch["C"]
                            for ch in plan["chunks"]),
        table_cr=max(ch["R"] * ch["C"] for ch in plan["chunks"]),
        window=s_ind.shape[1] * (8 if s_ind.dtype == torch.uint8 else 1),
        extra_resident=extra_resident_bytes, budget=budget, device=dev,
        modes=(("device", "f16", "host") if logsf_out == "auto"
               else (logsf_out,)))
    if select_out is not None:
        select_out.update(sel)
    if not sel["fits"]:
        raise ValueError(
            "the census phase does not fit the device memory budget: "
            f"peak {sel['census_peak'] / 1e9:.2f} GB vs "
            f"{sel['budget'] / 1e9:.2f} GB (logsf_out={logsf_out!r})")
    logsf_out = sel["logsf_out"]

    log_thr64 = float(np.log(enrichment_threshold))
    rank_dev = torch.as_tensor(rank_np, dtype=torch.int64, device=dev)
    n, n_attrs = len(rank_np), nan0_dev.shape[1]
    host = logsf_out == "host"
    if host:
        logsf = np.empty((n, n_attrs), np.float32)
        nbin = np.empty((n, n_attrs), np.int8)
    else:
        dtype = torch.float16 if logsf_out == "f16" else torch.float32
        logsf = torch.empty((n, n_attrs), dtype=dtype, device=dev)
        nbin = torch.empty((n, n_attrs), dtype=torch.int8, device=dev)
    log_thr32 = float(np.float32(log_thr64))
    counts = []
    for ch in plan["chunks"]:
        start, width = ch["start"], ch["width"]
        R, S_max, C = ch["R"], ch["S_max"], ch["C"]
        # the chunk's banded census (int8 cast to f32 here)
        with span("enrichment.go_census"):
            census = band_matmul(s_ind, _pad_rows_to(
                nan0_dev[:, start:start + width].to(torch.float32), npad),
                **kw)
        with span("enrichment.go_table", R=R, S_max=S_max, C=C,
                  route=htab.route(dev)):
            table = htab.build_logsf_table(
                torch.as_tensor(ch["K_dist"], device=dev), M, log_thr64,
                R=R, S_max=S_max, C=C)
        # one lookup, the rows un-permuted by rank, the columns placed
        with span("enrichment.go_lookup"):
            _nes, logsf_c, bin_c = htab.table_lookup(
                table, census, nsize_dev,
                torch.as_tensor(ch["colc"], device=dev), log_thr32,
                S_max=S_max, R=R, C=C)
            del census, table, _nes
            logsf_c = logsf_c.index_select(0, rank_dev)
            bin_c = bin_c.index_select(0, rank_dev)
            # a chunk's leading `overlap` columns repeat the previous chunk's
            counts.append(bin_c.sum(dim=0, dtype=torch.int32)[ch["overlap"]:])
            if host:
                logsf[:, start:start + width] = logsf_c.cpu().numpy()
                nbin[:, start:start + width] = bin_c.cpu().numpy()
            else:
                _place_chunk(logsf, nbin, logsf_c, bin_c, start)
            del logsf_c, bin_c
    return logsf, nbin, torch.cat(counts)


def _place_chunk(logsf, nbin, logsf_c, bin_c, start: int):
    """Copy one chunk's columns into the outputs in place (``:596``); the
    f32 log sf is cast to the output's dtype (f16 storage) on the copy."""
    width = logsf_c.shape[1]
    logsf[:, start:start + width].copy_(logsf_c)
    nbin[:, start:start + width].copy_(bin_c)
