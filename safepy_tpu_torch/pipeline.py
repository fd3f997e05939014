"""The fused pipelines: graph arrays in, enrichment out.

Port of ``safepy_tpu/pipeline.py``: APSP -> radius threshold -> observed
scores -> permutation null (:func:`fused_permutation_pipeline`), and APSP
-> threshold -> census -> hypergeometric survival for binary annotations
(:func:`fused_hypergeom_pipeline`), over dense or banded-window distances.
The JAX package compiles each into one program; here it is eager torch, and
the tensors stay on the device of the inputs. Over band storage the JAX
package's fused pipelines are, in eager torch, the band front
(:func:`band_neighborhoods`, :func:`euclidean_band_neighborhoods`)
followed by the tail that the staged run takes (:func:`_band_perm_tail`,
``ops.enrich_band``), so the facade composes those.

With a ``mesh`` (a DeviceMesh over ``torch.distributed``, every rank running
the same call on its own device), the dense pipelines run the JAX package's
multi-device branches: the FW row-sharded over a ``data`` axis or 2-D over
(``row``, ``col``) (``parallel.apsp_sharded``, ``parallel.apsp_sharded_2d``),
the permutation batch split over every mesh axis
(``parallel.permutation_sharded``) and the hypergeometric columns over an
``attr`` axis (``parallel.hypergeom_sharded``); every rank returns the same
global results.
"""

from __future__ import annotations

import torch

from safepy_tpu_torch.ops import apsp_bandstore as bst
from safepy_tpu_torch.ops import hypergeom as hyper
from safepy_tpu_torch.ops import hypergeom_table as htab
from safepy_tpu_torch.ops.apsp_banded import apsp_banded_unpermuted
from safepy_tpu_torch.ops.apsp_cuda import apsp_blocked_fw
from safepy_tpu_torch.ops.enrich_band import (band_score,
                                              scan_counts_band,
                                              valid_frame_map)
from safepy_tpu_torch.ops.neighborhoods import threshold_and_stats
from safepy_tpu_torch.ops.permutation import prepare_valid, scan_counts
from safepy_tpu_torch.ops.score import (check_fp32_matmul,
                                        compute_neighborhood_score)
from safepy_tpu_torch.parallel.mesh import fw_sharding, mesh_names
from safepy_tpu_torch.profiling import span


def _apsp_inline(d0, block, mesh=None, window=None, inv_rank=None,
                 radius=None):
    """FW distances (``pipeline.py:43``): the certified banded window when the
    caller passes one and the mesh shards no FW, else 2-D block-sharded over
    a (``row``, ``col``) mesh, row-sharded over a ``data`` axis, or the
    dense blocked FW on one device."""
    sharding = fw_sharding(mesh)
    if window is not None and sharding is None:
        return apsp_banded_unpermuted(d0, inv_rank, radius, window=window,
                                      block=block)
    if sharding == "2d":
        from safepy_tpu_torch.parallel.apsp_sharded_2d import apsp_sharded_2d
        return apsp_sharded_2d(d0, mesh, block=block)
    if sharding == "data":
        from safepy_tpu_torch.parallel.apsp_sharded import apsp_sharded
        return apsp_sharded(d0, mesh, block=block)
    # the facade only reaches here with undirected-graph distances
    return apsp_blocked_fw(d0, block=block, symmetric=True)


def fused_permutation_pipeline(d0, vals, valid_rows, generator, radius, *,
                               score_type: str = "sum",
                               num_permutations: int = 1000,
                               batch_size: int = 1000, strict: bool = False,
                               block: int = 128, precision: str = "highest",
                               mesh=None, window=None, inv_rank=None,
                               perm_idx=None):
    """APSP + neighborhoods + observed scores + permutation counts
    (``pipeline.py:111``).

    d0: dense (N, N) initialization, or with ``window`` the banded-order
    edge tuple ``(u, v, w)``; vals: (N, A) with NaNs; valid_rows: (V,) or
    None; generator: the null's ``torch.Generator`` (or ``perm_idx`` (P, V)).
    With a mesh, ``num_permutations`` is the per-device count (the facade
    rounds the total up to a multiple of the device count), ``generator``
    this rank's (``permutation_sharded.rank_generator``) and ``perm_idx``
    every rank's rows, (ndev num_permutations, V); the counts are summed
    over the mesh (``_sharded_null`` :87).
    Returns (dist, nbr, obs, counts_neg, counts_pos, mean_size, std_size).
    """
    with span("neighborhoods.front"):
        dist = _apsp_inline(d0, block, mesh, window=window,
                            inv_rank=inv_rank, radius=radius)
        nbr, mean, std = threshold_and_stats(dist, radius, strict=strict)
    with span("enrichment.null"):
        obs = compute_neighborhood_score(nbr, vals, score_type, precision)
        nbr_valid, v, m = prepare_valid(nbr, vals, valid_rows)
        if mesh is None:
            counts_neg, counts_pos = scan_counts(
                nbr_valid, v, m, obs, score_type=score_type,
                num_permutations=num_permutations, batch_size=batch_size,
                generator=generator, perm_idx=perm_idx, precision=precision)
        else:
            from safepy_tpu_torch.parallel.permutation_sharded import (
                sharded_counts)
            counts_neg, counts_pos = sharded_counts(
                nbr_valid, v, m, obs, mesh=mesh, score_type=score_type,
                per_device=num_permutations, batch_size=batch_size,
                generator=generator, perm_idx=perm_idx, precision=precision)
    return dist, nbr, obs, counts_neg, counts_pos, mean, std


def _hypergeom_tail(nbr, vals, lgt, M: int, enrichment_threshold, *,
                    iterations: int, mesh=None, attr_axis: str = "attr",
                    table_K_dist=None, table_colc=None, table_spec=None):
    """Census GEMMs + survival + device finalization (``pipeline.py:144``).

    The census (neighborhood sizes and per-attribute counts) is two f32
    GEMMs at full f32, so that the counts are exact integers. With
    ``table_spec = (R, S_max, C)`` and the matching ``table_K_dist`` /
    ``table_colc`` the survival values come from the class table, else
    from the per-cell f64 tail loop. With a mesh that has ``attr_axis``,
    each rank computes its slice of the columns, zero-padded to a multiple
    of the axis (``parallel.hypergeom_sharded``), and the slices are
    shared. Returns (nes f32, log sf f32, indicator int8)."""
    check_fp32_matmul("highest")
    finite = torch.isfinite(vals)
    nan0 = torch.where(finite, vals, torch.zeros_like(vals)).to(torch.float32)
    nodes_not_nan = finite.any(dim=1).to(torch.float32)
    nbr = nbr.to(torch.float32)
    if attr_axis in mesh_names(mesh):
        from safepy_tpu_torch.parallel import hypergeom_sharded as hs
        n_attrs = nan0.shape[1]
        group, ndev, my, width = hs.column_slice(n_attrs, mesh, attr_axis)
        del finite
        nan0 = hs.my_columns(nan0, width, my)
        if table_colc is not None:
            table_colc = hs.my_columns(table_colc[None, :], width, my)[0]
        out = _tail_columns(nbr, nan0, nodes_not_nan, lgt, M,
                            enrichment_threshold, iterations, table_K_dist,
                            table_colc, table_spec)
        return tuple(hs.gather_columns(x, n_attrs, group, ndev, my)
                     for x in out)
    return _tail_columns(nbr, nan0, nodes_not_nan, lgt, M,
                         enrichment_threshold, iterations, table_K_dist,
                         table_colc, table_spec)


def _tail_columns(nbr, nan0, nodes_not_nan, lgt, M, enrichment_threshold,
                  iterations, table_K_dist, table_colc, table_spec):
    """:func:`_hypergeom_tail` over the columns of ``nan0`` (JAX's ``tail``
    :160): spans ``enrichment.go_census``, then ``enrichment.go_table`` and
    ``enrichment.go_lookup`` (the class table) or ``enrichment.go_tail``
    (the f64 loop: attrs ``cells``, ``bound`` and the bodies run,
    ``iterations``)."""
    with span("enrichment.go_census"):
        nsize = nbr @ nodes_not_nan
        counts = nbr @ nan0
    if table_spec is not None:
        r, s_max, c = table_spec
        log_thr64 = torch.log(torch.tensor(float(enrichment_threshold),
                                           dtype=torch.float64))
        with span("enrichment.go_table", R=r, S_max=s_max, C=c,
                  route=htab.route(table_K_dist.device)):
            table = htab.build_logsf_table(table_K_dist, M,
                                           float(log_thr64), R=r,
                                           S_max=s_max, C=c)
        with span("enrichment.go_lookup"):
            return htab.table_lookup(table, counts, nsize, table_colc,
                                     float(log_thr64.to(torch.float32)),
                                     S_max=s_max, R=r, C=c)
    return hyper.tail_device(counts, nsize, nan0.sum(dim=0), lgt, M,
                             enrichment_threshold, iterations)


def fused_hypergeom_pipeline(d0, vals, lgt, M: int, radius,
                             enrichment_threshold, *, iterations: int,
                             strict: bool = False, block: int = 128,
                             mesh=None, window=None, inv_rank=None,
                             table_K_dist=None, table_colc=None,
                             table_spec=None):
    """APSP + neighborhoods + hypergeometric enrichment (``pipeline.py:203``).

    vals: (N, A) with NaNs; lgt: the f64 lgamma table over [0, M] on the
    device. Returns (dist, nbr, nes f32, log sf f32, indicator int8,
    enriched counts int32 (A,), mean size, std size); p-values come from
    ``exp(float64(log_sf))`` on the host. The enriched counts are reduced on
    the device.
    """
    with span("neighborhoods.front"):
        dist = _apsp_inline(d0, block, mesh, window=window,
                            inv_rank=inv_rank, radius=radius)
        nbr, mean, std = threshold_and_stats(dist, radius, strict=strict)
    with span("enrichment.go"):
        nes32, log_sf32, nes_binary = _hypergeom_tail(
            nbr, vals, lgt, M, enrichment_threshold, iterations=iterations,
            mesh=mesh, table_K_dist=table_K_dist, table_colc=table_colc,
            table_spec=table_spec)
    enriched_counts = nes_binary.sum(dim=0, dtype=torch.int32)
    return (dist, nbr, nes32, log_sf32, nes_binary, enriched_counts, mean,
            std)


# ---------------------------------------------------------------------------
# Band-storage pipeline: O(N W) memory end to end
# ---------------------------------------------------------------------------

def band_neighborhoods(u, v, w, radius, *, n: int, band: int,
                       block: int = 128, keep_distances: bool = True,
                       bf_slots=None, bf_max_iters: int = 0,
                       packed: bool = False):
    """Band-storage neighborhoods: init -> band relax -> indicator and
    stats (``pipeline.py:233``, ``:301``).

    The relax is the FW unless ``bf_slots = (nbr, dlt, wgt)`` is given
    (``ops.apsp_bandstore.band_bf_slots``); then the sparse Bellman-Ford
    runs with ``bf_max_iters`` as its budget. Returns (dist_band, s_ind,
    mean, std, converged) in the permuted frame; ``converged`` is True on
    the FW and False when BF ran out of rounds, in which case the band
    holds upper bounds and the caller must run again with the FW. The relax
    runs in place on the one f32 band. With ``keep_distances`` its entries
    beyond the radius (upper bounds, which the reference's Dijkstra cutoff
    never yields) are set to +inf in place and it is returned; without, it
    is dropped as soon as the indicator exists and ``dist_band`` is None.
    ``packed`` makes the indicator bit-packed uint8.
    """
    bt = bst.band_params(n, band, block)[0]
    with span("neighborhoods.front"):
        s = bst.band_init_from_edges(u, v, w, n=n, band=band, block=block)
        converged = True
        if bf_slots is not None:
            with span("neighborhoods.relax"):
                _, converged, _ = bst.apsp_band_bf(
                    s, *bf_slots, radius, bt=bt, block=block,
                    max_iters=bf_max_iters)
        else:
            bst.apsp_band_fw(s, bt=bt, block=block)
        s_ind = bst.band_threshold(s, radius, packed=packed, block=block)
        _, mean, std = bst.band_row_stats(s_ind, n=n, bt=bt, block=block)
        if not keep_distances:
            return None, s_ind, mean, std, converged
        r = torch.as_tensor(radius, dtype=s.dtype, device=s.device)
        s.masked_fill_(s > r, float("inf"))
    return s, s_ind, mean, std, converged


def euclidean_band_neighborhoods(coords_perm, radius, *, n: int, band: int,
                                 block: int = 128,
                                 keep_distances: bool = True,
                                 packed: bool = False):
    """Banded euclidean neighborhoods (strict ``dist < r``) for scatter/UMAP
    inputs at band-storage scale (``pipeline.py:267``; reference
    safe.py:389-399): (dist_band or None, s_ind, mean, std) in the permuted
    frame. ``coords_perm``: (n, 2) coordinates in the banded order on the
    device. With ``keep_distances`` the f32 distance band is built and
    kept, its entries from the radius on set to +inf; without, the
    indicator is built directly and the f32 band never exists, and
    ``packed`` makes it bit-packed."""
    if keep_distances and packed:
        raise ValueError("a bit-packed indicator needs keep_distances=False")
    if keep_distances:
        dist_band = bst.euclidean_band_distances(coords_perm, n=n, band=band,
                                                 block=block)
        beyond = dist_band >= torch.as_tensor(radius, dtype=torch.float32,
                                              device=dist_band.device)
        s_ind = (~beyond).to(torch.int8)
        dist_band.masked_fill_(beyond, float("inf"))
    else:
        dist_band = None
        s_ind = bst.euclidean_band_indicator(coords_perm, radius, n=n,
                                             band=band, block=block,
                                             packed=packed)
    _, mean, std = bst.band_row_stats(
        s_ind, n=n, bt=bst.band_params(n, band, block)[0], block=block)
    return dist_band, s_ind, mean, std


def _band_null(s_ind, vals, vals_valid, valid, starts, rank, generator, *,
               bt: int, block: int, score_type: str, num_permutations: int,
               batch_size: int, w_c: int, precision: str, perm_idx=None,
               blocks=None, row_block_offset: int = 0):
    """Observed scores + compaction + permutation counts over a banded
    indicator, in the permuted frame: (npad, A) obs, counts_neg,
    counts_pos, or for a row shard of the band (``blocks``,
    ``row_block_offset``: ``ops.apsp_bandstore._block_range``) the rows of
    its real block-rows."""
    kw = dict(bt=bt, block=block, precision=precision, blocks=blocks,
              row_block_offset=row_block_offset)
    obs = band_score(s_ind, vals, score_type=score_type, **kw)
    compact = bst.apply_compaction(s_ind, valid, w_c, bt=bt, block=block,
                                   row_block_offset=row_block_offset)
    mask_valid = torch.isfinite(vals_valid).to(torch.float32)
    vv = torch.where(mask_valid > 0, vals_valid.to(torch.float32),
                     torch.zeros_like(mask_valid))
    counts_neg, counts_pos = scan_counts_band(
        compact, starts, vv, mask_valid, obs, valid_frame_map(valid, rank),
        score_type=score_type, num_permutations=num_permutations,
        batch_size=batch_size, generator=generator, perm_idx=perm_idx, **kw)
    return obs, counts_neg, counts_pos


def _band_perm_tail(s_ind, vals, vals_valid, valid, starts, rank, generator,
                    *, bt: int, block: int, score_type: str,
                    num_permutations: int, batch_size: int, w_c: int,
                    precision: str, perm_idx=None):
    """:func:`_band_null` with the (n, A) outputs un-permuted to the
    original frame by ``rank`` (``pipeline.py:369``)."""
    with span("enrichment.null"):
        obs, counts_neg, counts_pos = _band_null(
            s_ind, vals, vals_valid, valid, starts, rank, generator, bt=bt,
            block=block, score_type=score_type,
            num_permutations=num_permutations, batch_size=batch_size,
            w_c=w_c, precision=precision, perm_idx=perm_idx)
        return obs[rank], counts_neg[rank], counts_pos[rank]
