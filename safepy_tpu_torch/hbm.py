"""Pre-dispatch device-memory plan for the band GO (binary) pipelines.

Port of ``safepy_tpu/hbm.py``. Before a band GO run allocates anything,
the facade asks this model for each phase's peak and either picks the
log-survival residency (device f32 -> device f16 -> host) or raises a
``ValueError`` carrying the plan. The phases are JAX's:

  * ``prep`` -- the operand build (``ops.enrich_band.band_hyper_operands_*``);
  * ``relax`` -- the FW front: the f32 distance band, relaxed in place, and
    the indicator it leaves;
  * ``census`` -- the class-table chunk loop: indicator band, int8
    annotations and the (n, A) outputs at the chosen residency, plus one
    chunk's live set.

Every term is the port's own byte count, read from the tensors the port's
code holds in that phase (each term below names its line of code); the
TPU's calibrations (``CENSUS_SAFETY``, ``RELAX_SAFETY``,
``TABLE_BYTES_ESTIMATE``, ``hbm.py:50-55``) are not ported, and neither
are two of JAX's mechanisms: the port's FW front updates the band in place
(XLA double-buffers it, whence JAX's ``split_front``), and its table lookup
is one gather (JAX's slot loop keeps ``lookup_group`` gathers live). The
model counts allocated bytes (``torch.cuda.max_memory_allocated``); a phase
is admitted when its peak is at most the budget. ``record_peak`` samples
the allocator between phases, which is how the model is checked on the
card (``chip_smoke.py`` phase 16).

The allocator's reserved bytes can rise above a phase's model: a block
freed in one phase stays cached, and a later, larger request takes a new
segment. When ``cudaMalloc`` fails (or a cap is reached) the allocator
releases its free segments and retries, so that cache is not lost; what
is lost are the free remainders of segments that still hold a live block
(``inactive_split_bytes``), which :func:`device_hbm_budget` leaves out.
``chip_smoke.py`` phase 16 checks the two together: it runs each
residency again with the process capped
(``torch.cuda.set_per_process_memory_fraction``) at what it holds and
cannot give back plus the plan's largest phase peak, as if the budget
read exactly that peak.

On a TPU a device OOM poisoned the backend, which is why JAX plans before
dispatching; torch raises a catchable ``torch.OutOfMemoryError``, so here
the plan chooses the residency and refuses early rather than after
minutes of work.
"""

from __future__ import annotations

import os

import torch

from safepy_tpu_torch.ops.apsp_bandstore import _GROUP_ELEMS, band_params

# what a host session assumes when it plans (JAX's CPU meshes get the same)
_DEFAULT_BUDGET = 16 * 10 ** 9
# ops.apsp_bandstore.band_threshold's packed row chunk (256 block-rows)
_PACK_CHUNK_ROWS = 256 * 128
# the most bytes one piece of the sharded engines' host assembly moves
# (parallel.band_sharded._assemble_host): a rank receiving another rank's
# rows holds one such piece on its device
SHARD_STAGE_BYTES = 1 << 28
# the run's tensors of O(n + A + E) elements (ranks, sizes, totals, tile
# lists, lgamma table, per-chunk class arrays): a bound, not a measurement
_SMALL_BYTES = 64 << 20

#: allocator samples appended by :func:`record_peak` when
#: SAFEPY_TPU_HBM_TRACE is set (each: tag, allocated, peak_allocated,
#: reserved, peak_reserved, in bytes; the peaks since the previous sample)
HBM_TRACE: list[dict] = []


def trace_active() -> bool:
    return os.environ.get("SAFEPY_TPU_HBM_TRACE", "") not in ("", "0")


def record_peak(tag: str, device=None):
    """Sample the CUDA caching allocator at a phase boundary into
    :data:`HBM_TRACE` (``hbm.py:64``), after waiting for the device; a
    no-op unless SAFEPY_TPU_HBM_TRACE is set. The peaks are those since the
    previous sample (the allocator's peak counters are reset after each
    sample), so each sample holds the peak of the phase that ends at it. A
    CPU device has no counters: its sample is marked ``unavailable``.
    Sampling never changes a result."""
    if not trace_active():
        return None
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        rec = dict(tag=tag, allocated=-1, peak_allocated=-1, reserved=-1,
                   peak_reserved=-1, unavailable=True)
    else:
        torch.cuda.synchronize(dev)
        rec = dict(tag=tag, allocated=torch.cuda.memory_allocated(dev),
                   peak_allocated=torch.cuda.max_memory_allocated(dev),
                   reserved=torch.cuda.memory_reserved(dev),
                   peak_reserved=torch.cuda.max_memory_reserved(dev))
        torch.cuda.reset_peak_memory_stats(dev)
    HBM_TRACE.append(rec)
    return rec


def releasable_cache_bytes(device) -> int:
    """The caching allocator's reserved bytes that it can give back: its
    whole free segments (reserved less allocated, less the free remainders
    of segments that still hold a live block, ``inactive_split_bytes``,
    which only a request that fits inside one of them can use)."""
    stats = torch.cuda.memory_stats(device)
    return (int(stats.get("reserved_bytes.all.current", 0))
            - int(stats.get("allocated_bytes.all.current", 0))
            - int(stats.get("inactive_split_bytes.all.current", 0)))


def device_hbm_budget(device=None, own_bytes: int = 0) -> int:
    """The bytes a plan may count on ``device`` (``hbm.py:97``): on a card,
    what ``torch.cuda.mem_get_info`` reports free, plus the allocator's
    releasable cache (:func:`releasable_cache_bytes`: it releases those
    segments and retries a failed ``cudaMalloc``), plus ``own_bytes``, the
    live tensors that the caller's plan already counts among its peaks (a
    session's cached upload, operands or stored band). Every other live
    tensor of the process, and the free remainders of its segments, stay
    out of the budget. 16 GB for a CPU session."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return _DEFAULT_BUDGET
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free) + releasable_cache_bytes(dev) + int(own_bytes)


def band_geometry(n: int, band: int, block: int = 128):
    """(bt, padded rows, window columns) of the skewed band store
    (``ops.apsp_bandstore.band_params``)."""
    bt, nb, window = band_params(n, band, block)
    return bt, (nb + 2 * bt) * block, window


def _budget(budget, device) -> int:
    return device_hbm_budget(device) if budget is None else int(budget)


def _out_bytes(mode: str, n: int, n_attrs: int) -> int:
    """The (n, A) outputs' device bytes at residency ``mode``
    (``hypergeom_band_table``'s ``logsf`` and ``nbin``)."""
    per_cell = {"device": 5, "f16": 3, "host": 0}  # log sf + int8 indicator
    if mode not in per_cell:
        raise ValueError(f"unknown logsf_out: {mode!r}")
    return per_cell[mode] * n * n_attrs


def census_chunk_bytes(rows: int, chunk_w: int, table_bytes: int,
                       table_cr: int, window: int) -> int:
    """One census chunk's live bytes (a chunk of
    ``enrich_band.hypergeom_band_table``):
    the class table plus the largest of its three steps, each over
    ``rows`` (at least the padded node rows) by ``chunk_w`` cells:

      * the banded census: the int8 columns cast to f32, padded to npad,
        ghost-padded inside ``band_matmul`` and its f32 output (4 x 4 B a
        cell), plus one group's slab and product;
      * the table build (``build_logsf_table``): the f32 counts and about
        16 (C, R) f64 arrays live in its recurrence (``table_cr`` = C R);
      * the lookup (``table_lookup`` and the row un-permute): counts f32,
        the clamped int64 counts and the int64 flat index with one int64
        temporary of its sum, the gathered f32 log sf, the bool and int8
        indicator and the f32 NES, then the un-permuted copies
        (4 + 8 + 8 + 8 + 4 + 1 + 1 + 4 B a cell at most at once: 38).
    """
    cells = rows * chunk_w
    # a group's f32 slab (4 B an element, 4 more for a packed band's
    # unpack temporaries) and its f32 product
    group = 8 * _GROUP_ELEMS + 4 * (_GROUP_ELEMS // max(1, window) + 128) \
        * chunk_w
    census = 16 * cells + group
    build = 4 * cells + 16 * 8 * table_cr
    lookup = 38 * cells
    return int(table_bytes) + max(census, build, lookup)


def census_select(*, n: int, n_attrs: int, rows: int, chunk_w: int,
                  ind_bytes: int, ann_bytes: int, table_bytes: int,
                  table_cr: int = 0, window: int = 1, keep_band: int = 0,
                  extra_resident: int = 0, budget: int | None = None,
                  modes=("device", "f16", "host"), device=None):
    """The census phase's log-survival residency (``hbm.py:121``).

    Peak = the resident set (indicator band, annotations, the (n, A)
    outputs at the mode's residency, a kept distance band and any other
    caller-owned residents) + one chunk's live set
    (:func:`census_chunk_bytes`). Modes are walked in order, cheapest loss
    first; the first whose peak is within the budget wins. Returns a dict
    with ``logsf_out`` (None when nothing fits: the smallest peak is
    reported), ``census_peak``, ``budget`` and ``fits``.
    """
    budget = _budget(budget, device)
    live = census_chunk_bytes(rows, chunk_w, table_bytes, table_cr, window)
    best = None
    for mode in modes:
        peak = (ind_bytes + ann_bytes + keep_band + extra_resident
                + _out_bytes(mode, n, n_attrs) + live + _SMALL_BYTES)
        sel = dict(logsf_out=mode, census_peak=int(peak), budget=budget,
                   fits=peak <= budget)
        if sel["fits"]:
            return sel
        if best is None or peak < best["census_peak"]:
            best = dict(sel, logsf_out=None)
    return best


def prep_peak(n: int, n_attrs: int, *, chunked: bool,
              chunk_cols: int = 512) -> int:
    """The operand prep's peak (``enrich_band.band_hyper_operands_*``).

    Full-device: the f32 upload (4 B a cell; cast on the device from f64
    row blocks of 32 MiB, a block and its count's temporaries within the
    small bytes), the finite mask (1, made by row chunks:
    ``torch.isfinite`` takes an f32 ``|x|`` and two bool temporaries), the
    binary check's three bool temporaries (3; none where the upload's count
    decides it), then the f32 NaN-zeroed copy (4) with its int8 cast (1)
    and the gathered int8 operands (1): at most 10 B a cell. Chunked: the
    int8 buffer (1 B a cell) and one f32 column chunk's upload, isfinite's
    temporaries, the mask and copy (12 B a chunk cell), or at the end the
    buffer and its gathered copy (2)."""
    cells = n * n_attrs
    if not chunked:
        return 10 * cells + _SMALL_BYTES
    chunk = 12 * n * min(chunk_cols, n_attrs)
    return max(cells + chunk, 2 * cells) + _SMALL_BYTES


def relax_peak(n: int, band: int, *, packed: bool, keep_distances: bool,
               resident: int, edges: int = 0, block: int = 128) -> int:
    """The FW front's peak (``pipeline.band_neighborhoods``): ``resident`` bytes
    held across it (annotation operands, upload) + the f32 band, relaxed in
    place, + the largest of: the initialization's edge index temporaries
    (about 160 B an edge), a round's panels, and the threshold (a bool
    mask and the int8 indicator; packed: the uint8 bits and a chunk's bool,
    uint8 and product temporaries, then ``band_row_sizes``' int64 gather);
    a kept band then takes one more bool mask for its radius fill."""
    _, rows, window = band_geometry(n, band, block)
    f32_band = 4 * rows * window
    cells = rows * window
    if packed:
        chunk = min(rows, _PACK_CHUNK_ROWS) * window
        threshold = cells // 8 + max(4 * chunk, 8 * _GROUP_ELEMS)
    else:
        threshold = 2 * cells
    rounds = 3 * 4 * block * window
    keep = (cells // 8 if packed else cells) + cells if keep_distances else 0
    return (resident + f32_band + max(160 * edges, rounds, threshold, keep)
            + _SMALL_BYTES)


def band_go_hbm_plan(n: int, band: int, n_attrs: int, *, packed: bool,
                     keep_distances: bool, logsf_out: str = "auto",
                     prep_chunked: bool = True, budget: int | None = None,
                     block: int = 128, chunk_cols: int = 512,
                     edges: int = 0, device=None):
    """Phase peaks of the single-device band GO pipeline (``hbm.py:160``).

    Returns a dict with each phase's modeled peak, the admitted
    ``logsf_out`` ('auto' walks device -> f16 -> host), ``fits`` and the
    governing phase (the one nearest to, or furthest past, the budget).
    Callers raise on ``fits=False`` before any allocation.

    The class table's geometry needs the largest neighborhood, which only
    the relax gives: this pre-prep plan counts no table, and
    ``ops.enrich_band.hypergeom_band_table`` selects again with the exact
    table once its plan exists (JAX's pre-prep plan counts a v5e estimate,
    ``TABLE_BYTES_ESTIMATE``). ``prep_chunked``: the prep builds the int8
    operands from column chunks (never staging the f32 upload, which then
    is not resident either); False models the full-device prep, whose f32
    upload the session keeps. ``edges``: the edge count (the
    initialization's temporaries).
    """
    budget = _budget(budget, device)
    bt, rows, window = band_geometry(n, band, block)
    f32_band = 4 * rows * window
    ind_bytes = rows * window // 8 if packed else rows * window
    ann8 = n * n_attrs  # the int8 operands
    upload = 0 if prep_chunked else 4 * n * n_attrs
    prep = prep_peak(n, n_attrs, chunked=prep_chunked, chunk_cols=chunk_cols)
    relax = relax_peak(n, band, packed=packed, keep_distances=keep_distances,
                       resident=ann8 + upload, edges=edges, block=block)
    sel = census_select(
        n=n, n_attrs=n_attrs, rows=rows, chunk_w=min(chunk_cols, n_attrs),
        ind_bytes=ind_bytes, ann_bytes=ann8, table_bytes=0, window=window,
        keep_band=f32_band if keep_distances else 0, extra_resident=upload,
        budget=budget,
        modes=(("device", "f16", "host") if logsf_out == "auto"
               else (logsf_out,)))
    fits = sel["fits"] and relax <= budget and prep <= budget
    ratios = {"prep": prep / budget, "relax": relax / budget,
              "census": sel["census_peak"] / budget}
    return dict(n=n, band=band, n_attrs=n_attrs, bt=bt, rows=rows,
                window=window, packed=packed, keep_distances=keep_distances,
                prep_chunked=prep_chunked, f32_band=f32_band,
                indicator_bytes=ind_bytes, annotations_int8=ann8,
                prep_peak=prep, relax_peak=relax,
                census_peak=sel["census_peak"],
                logsf_out=sel["logsf_out"] if fits else None, budget=budget,
                fits=fits,
                governing_phase=max(ratios, key=ratios.get))


def band_go_shard_hbm_plan(n: int, band: int, n_attrs: int, ndev: int, *,
                           packed: bool = True, budget: int | None = None,
                           block: int = 128, chunk_cols: int = 1024,
                           keep_distances: bool = True, device=None):
    """Per-rank peak of the row-sharded band GO engine over a ``data`` axis
    of ``ndev`` ranks (``hbm.py:227``; the engine is
    ``parallel/band_sharded.py``'s layout: equal slabs of ghosted
    block-rows).

    JAX's terms, kept as they are: the f32 FW slab with its 2 bt ghost
    block-rows, the (packed) indicator slab, the rank's rows of the int8
    annotations and of the two (n, A) outputs; plus one census chunk over
    the slab's rows (:func:`census_chunk_bytes`; the replicated class
    table, known only after the relax, is not counted, as in
    :func:`band_go_hbm_plan`). Their sum is ``per_shard_peak``.

    The port assembles the bands and the (n, A) outputs in host memory and
    builds each rank's window of the operands on its device, so its card
    holds three more transients, none of which grows with the rank count:

      * ``stage_buffer``: one piece of the host assembly
        (``band_sharded._assemble_host``), a rank's band segment (the f32
        distance slab with ``keep_distances``, else the indicator slab) or
        a census chunk's rows of the f32 log sf, whichever is larger,
        capped at :data:`SHARD_STAGE_BYTES`; one rank stages nothing (its
        rows go straight to the host), but the term is counted at every
        rank count alike;
      * ``ghost_operands``: the rank's int8 operand window beyond JAX's
        share, its ``bt`` ghost block-rows on each side and the rounding of
        its rows to a block: at most (2 bt + 1) b rows
        (``band_sharded.operand_window``);
      * ``prep_chunk``: one column chunk of the per-rank prep
        (``band_sharded.band_hyper_operands_sharded``) over the window's
        rows: the f32 upload, ``isfinite``'s temporaries, the mask and the
        copy, 12 B a cell of its 512 columns (the chunked term of
        :func:`prep_peak`).

    ``per_rank_peak`` is ``per_shard_peak`` plus these; ``fits`` compares
    it with the budget. What each rank holds in host memory is reported
    beside it and not compared with the device budget: ``host_outputs``
    (the (n, A) f32 log sf and int8 indicator), ``host_bands`` (the global
    indicator band and, with ``keep_distances``, the f32 band, in the frame
    padded to a multiple of the rank count) and ``host_operands`` (one f32
    column chunk of the window's rows, read from the session's matrix).
    """
    budget = _budget(budget, device)
    bt, rows, window = band_geometry(n, band, block)
    local_rows = -(-rows // (block * ndev)) * block
    slab_rows = local_rows + 2 * bt * block
    fw_slab = 4 * slab_rows * window
    ind_bytes = (slab_rows * window // 8 if packed
                 else slab_rows * window)
    ann8 = rows * n_attrs // ndev
    out_bytes = 5 * (n * n_attrs // ndev)  # f32 log sf + int8 indicator
    w = min(chunk_cols, n_attrs)
    transient = census_chunk_bytes(slab_rows, w, 0, 0, window)
    per_shard = fw_slab + ind_bytes + ann8 + out_bytes + transient \
        + _SMALL_BYTES
    band_cell = 4 if keep_distances else (1 / 8 if packed else 1)
    pc = min(512, n_attrs)  # band_hyper_operands_sharded's chunk
    port = dict(
        stage_buffer=min(SHARD_STAGE_BYTES,
                         int(local_rows * max(window * band_cell, 4 * w))),
        ghost_operands=(2 * bt + 1) * block * n_attrs,
        prep_chunk=12 * slab_rows * pc)
    per_rank = per_shard + sum(port.values())
    # the global frame: the ghosted block-rows padded to a multiple of ndev
    g_rows = -(-rows // (block * ndev)) * ndev * block
    host = dict(
        host_outputs=5 * n * n_attrs,
        host_bands=((g_rows * window // 8 if packed else g_rows * window)
                    + (4 * g_rows * window if keep_distances else 0)),
        host_operands=4 * slab_rows * pc)
    return dict(n=n, band=band, n_attrs=n_attrs, ndev=ndev, bt=bt,
                rows=rows, window=window, packed=packed, fw_slab=fw_slab,
                indicator_bytes=ind_bytes, annotations_int8=ann8,
                out_bytes=out_bytes, census_transient=transient,
                per_shard_peak=per_shard, keep_distances=keep_distances,
                **port, per_rank_peak=per_rank, **host, budget=budget,
                fits=per_rank <= budget, sharded=True)


def explain(plan: dict) -> str:
    """One-line summary of a plan, for the guard's ValueError
    (``hbm.py:277``)."""
    gb = 1e9
    if plan.get("sharded"):
        host = (plan["host_outputs"] + plan["host_bands"]
                + plan["host_operands"])
        return (f"sharded band GO memory plan at {plan['n']:,} x "
                f"{plan['n_attrs']:,} over {plan['ndev']} devices (band "
                f"{plan['band']}, packed={plan['packed']}, "
                f"keep_distances={plan['keep_distances']}): per-shard peak "
                f"{plan['per_shard_peak'] / gb:.2f} GB, per-rank peak with "
                f"the staging, ghost operand rows and prep chunk "
                f"{plan['per_rank_peak'] / gb:.2f} GB vs a budget of "
                f"{plan['budget'] / gb:.2f} GB (host memory a rank "
                f"{host / gb:.2f} GB)")
    return (f"band GO memory plan at {plan['n']:,} x {plan['n_attrs']:,} "
            f"(band {plan['band']}, packed={plan['packed']}, "
            f"keep_distances={plan['keep_distances']}, "
            f"prep_chunked={plan['prep_chunked']}): "
            f"prep peak {plan['prep_peak'] / gb:.2f} GB, "
            f"relax peak {plan['relax_peak'] / gb:.2f} GB, census peak "
            f"{(plan['census_peak'] or 0) / gb:.2f} GB "
            f"(logsf_out={plan['logsf_out']}) vs a budget of "
            f"{plan['budget'] / gb:.2f} GB")
