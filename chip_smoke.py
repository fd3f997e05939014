"""Drive the PyTorch/CUDA port of SAFE once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card (``nvidia-smi`` name and power limit); refuse to run
   without CUDA;
2. build the CUDA kernels from ``safepy_tpu_torch/csrc`` into ``build/``;
3. hold each kernel bitwise against its plain torch version on the card at
   the shapes of its path, and time both (CUDA events, median): the
   banded-window kernels at the Example_1 shapes (``relax_window_sym``
   also over the dense 4,096 matrix, each case with its tile-list form and
   its bound, and both of its forms timed at list lengths from 35 to 528
   tiles, ``FORM_CASES``; the banded ``relax_full`` kernel and both forms
   of ``relax_window_sym``'s kernel timed over the banded list at 62 to
   1,024 tiles, ``FULL_FORM_CASES``), the skew kernels at the
   49,920-node band shape (block 128, bt 12, W 3,200) and at bt 0-2, at
   block 64 (bt 0-3 and 12), and as views into bands wider than W, the
   classic relax over the dense 4,096 matrix and the 1,024 window, one
   4096 x 4096 x 4096 min-plus product and a ragged one with negative
   entries and +inf rows and columns, and the sharded window rows
   (``relax_band_row``, one row of 128 x 3,200 and of 128 x 640, and
   ``relax_band_rows``, a round's rows in one launch, whole and cut); each
   beside its bound; ``close_diag`` also on +inf-diagonal, padding and
   strided tiles at block 128 and 64, beside its one-SM floor; the class
   table's kernel (``csrc/hypergeom_table.cu``, one launch a table)
   ``torch.equal`` to the slot loop run on the card at the band GO chunk
   of genome scale (M 18,440, R = S_max = C = 256) and at the dense fused
   route's R 4,096, beside its bound (the f32 table written once); then a
   register-only probe measures the card's FP32 add + min rate, and each
   min-plus kernel's rate is printed as a share of it and of the nominal
   rate the bounds assume;
4. the Example_1 path: the Example_1-shaped workflow of ``bench.py``
   (3,971-node kNN geometric network, one quantitative attribute,
   1,000-permutation null) through ``SAFE(device="cuda").run_pipeline``.
   Checks that the banded plan was taken, that every kernel launched, that
   the neighborhoods equal scipy Dijkstra's, and that the counts are
   consistent; times the warm run, the steady runs and the APSP and null
   phases, and profiles one steady run for the device's busy time and its
   largest kernels;
5. the same network with ``apsp_mode="full"`` (dense FW): the same
   neighborhoods; and with ``apsp_mode="band"`` (band storage) and the same
   seed: the same neighborhoods, scores within 1e-5 and counts within
   near-tie flips;
6. the band-storage path: ``bench.py``'s band-scale network (49,920 nodes,
   kNN k = 9, radius for ~125-node neighborhoods) with one normal attribute
   through ``run_pipeline`` with ``apsp_mode="auto"``. Checks that band
   storage was taken, the launch counts (one of each kernel a FW round),
   512 seeded indicator rows against scipy Dijkstra and the counts; times
   the warm and steady runs, the FW-front and null-tail phases, reports
   the peak device memory and profiles one steady run. Then the
   non-symmetric band FW (``relax_skew``) on the same initial band must
   give the same indicator;
7. the op-level path (``safepy_tpu_torch.ops``) at the Example_1 width:
   ``ops.apsp(d0)`` with the JAX defaults (classic FW, ``relax_full``),
   bitwise equal to ``symmetric=True``; the classic banded FW
   (``relax_full`` with a band), bitwise equal to the symmetric one;
   ``method="pallas_squaring"`` (``minplus_product``), within 1e-6 of the
   FW; a directed 16-NN matrix through the classic dense and banded FW
   against scipy's directed Dijkstra, and how many pairs the mirror-halved
   FW would get wrong there; the flagship step of
   ``__graft_entry__.entry()`` (APSP, threshold, scores, 1,000-permutation
   null). Launch counts per path and min-of-3 times;
8. the row-sharded band engine (``parallel.band_sharded``) on phase 6's
   network and attribute: at world 1 over NCCL in this process,
   ``SAFE(mesh=make_mesh({"data": 1})).run_pipeline`` with launch counts
   (one ``close_diag``, one ``relax_panel`` and one ``relax_band_row`` for
   the window rows a round), the indicator band bitwise and the counts exactly
   equal to phase 6's and the scores within 1e-5, timed and profiled, and
   the sharded FW alone; then world 2 over gloo, two processes on the same
   card (``torch.multiprocessing.spawn``), each running the sharded FW and
   the facade run, whose band and indicator must equal world 1's bitwise;
10. the binary GO path (run after phase 8, before phase 9's report): two
    binary matrices of 4,373 terms (seeded, members near random centres,
    10% unannotated genes) on the Example_1 network through the fused
    binary ``run_pipeline`` (banded window). Matrix A (term sizes 3-300)
    must take the f64 tail loop, matrix B (at most 64 sizes of at most
    120) the class table; B on the loop engine gives the table's indicator
    and counts and p within 1e-6; 10,000 sampled cells of each within 1e-6
    of scipy's ``hypergeom.sf``; the stages (``define_neighborhoods``,
    ``compute_pvalues``) on A give the fused run's neighborhoods and
    indicator and p within 1e-6; the FDR run on A is
    ``fdr_bh_logsf_np`` of the unadjusted log-survival within 1 f32 ulp,
    indicator equal, on sampled rows. Times the warm and steady runs, the
    census, tail loop, class table and FDR alone, reports the peak device
    memory and profiles one steady run of each engine;
11. the domain stage on phase 10's matrix A session (3,971 x 4,373, the
    loop engine), its terms given seeded GO-like names:
    ``define_top_attributes``, ``define_domains`` (which must take the
    intersection-GEMM engine under 'auto': 96 top terms or more) and
    ``trim_domains``. Checks, on the card: the intersections equal the host
    f64 ``b.T @ b`` of the downloaded indicator; the condensed jaccard of
    512 sampled top terms is bitwise scipy's ``pdist``; the device counts
    and maxima equal the host loop of ``safepy_tpu/domains.py:175-183`` on
    the downloaded indicator and f32 NES; ``indicator_csc`` equals the
    dense indicator; re-clustering at threshold 0.6 runs no second GEMM;
    the session's attributes, node2domain and domains equal those of a CPU
    session handed the same indicator, NES and counts through the setters.
    Times (min of 3) the stage and its parts, reports the peak device
    memory and profiles one stage (the ``domains:`` lines);
12. the band GO path: phase 6's network (49,920 nodes, band storage) with
    a binary matrix of 4,373 terms of matrix A's size law (seeded, 10%
    unannotated genes) through the fused binary ``run_pipeline``. 'auto'
    must take the class table (``table-band``) and
    ``hypergeom_engine='loop'`` the f64 tail loop in host chunks
    (``hostchunks-band``), each with one ``close_diag``, ``relax_panel``
    and ``relax_skew_sym`` a FW round; their indicators and counts equal,
    p within 1e-6 (their log sf ulps printed). The indicator band is bitwise
    phase 6's; the census equals a host ``scipy.sparse`` product of
    ``neighborhoods_sparse`` with the matrix; 10,000 sampled cells of each
    engine within 1e-6 of scipy's ``hypergeom.sf``; the stages equal the
    fused run; the FDR run is ``fdr_bh_logsf_np`` of the unadjusted
    log-survival within 1 f32 ulp on sampled rows; the domain stage runs on
    the ``table-band`` session through the CSC view, which must equal
    ``np.nonzero`` of the int8 download. Times the warm and steady runs, the host passes, the operand
    prep, the table's and the tail loop's first and last chunks, FDR and
    the domain stage, reports the peak memory and profiles one steady run
    of each engine (the ``band GO`` lines);
13. the A7 remainder (run after phase 12, before phase 9's report), each
    part's times printed beside the card: (c) ``band_relax='bf'`` on phase
    6's network through ``run_pipeline``: the relax recorded ('bf'), the
    slot width, the rounds and the budget; the indicator band against phase
    6's FW band (each differing cell printed with its distance to the
    radius in f32 ulps, and refused beyond one ulp); the counts equal to
    phase 6's; BF's relax alone against the FW's, and a profile of it; then
    with ``bf_max_iters`` replaced by one round the run falls back to the
    FW ('bf->fw', one ``close_diag``, ``relax_panel`` and ``relax_skew_sym``
    a round). (d) ``band_indicator_bits=True`` on the same network: the
    quantitative run's band is phase 6's packed, its scores and counts
    phase 6's; a ``table-band`` run of phase 12's matrix gives phase 12's
    indicator, counts and log sf bitwise; peaks against theirs. (b) the
    euclidean band at 49,920 uniform points with kept distances: 512
    distance and indicator rows equal to a host f32 computation with JAX's
    arithmetic, the stages equal to the fused run under the same
    permutations, and 256 binary terms of phase 12's size law through the
    staged band GO engine within 1e-6 of scipy on 10,000 sampled cells.
    (a) the euclidean band at 1,000,000 uniform points (about 125 a
    neighborhood, one normal attribute with 30% NaN, 1,000 permutations,
    ``keep_node_distances=False``, the defaults otherwise): it must take
    band storage (band 6,655, bt 52, W 13,440) and the bit-packed
    indicator (1.70 GB); 512 seeded rows equal the host's, and the count
    of their cells within one f32 ulp of the radius is printed; the same
    session with ``band_indicator_bits=False`` gives the packed band's
    bytes, scores and counts. Times the warm and steady runs, the
    indicator build, the null, the scores and the compaction alone in both
    forms, reports both peaks and profiles one steady run. No euclidean
    path launches a hand-written kernel;
14. the file-driven workflow (run after phase 13, before phase 9's
    report), its files written with numpy and scipy into a temporary
    directory: an INI (``layoutAlgorithm = spring_tpu``, ``randomSeed``),
    phase 4's network as a 3-column ``.txt`` of gene keys and as a MATLAB
    session with its coordinates, phase 4's attribute as a ``.txt`` (NaN
    rows blank) and GO matrix A of phase 10 as a 3,971 x 4,373 ``.txt``.
    (a) ``SAFE(path_to_ini_file=...)``, ``load_network`` (the native
    parse and the exact energy layout on the card, reproducible from its
    seed), ``load_attributes``, ``run_pipeline``: the engine and window,
    the launches, the parse, layout and edge-length times (min of 3), the
    GO file's parse (min of 2), the steady wall, the indicator against
    scipy Dijkstra's on the layout, and the layout's neighborhood
    preservation against the port's CPU layout of the same graph and seed
    (computed on a host thread during phases 14 and 15, compared after
    phase 15; within 0.05). The ``.mat`` twin
    with phase 4's attribute and seed gives phase 4's arrays,
    neighborhoods, scores and counts. GO matrix A from its file on the
    twin equals phase 10's matrix; ``compute_pvalues``, the domain stage
    and ``print_output_files`` follow, and the three TSVs read back with
    ``csv`` equal the session's arrays. ``cli.main`` in-process pickles
    the NES of a facade run of the same INI. (b) the sampled energy layout
    (2,048 repulsors) of phase 6's 49,920-node network on the card: its
    time and preservation statistic;
15. the host extras (run after phase 14, before phase 9's report) on the
    sessions of phases 4 (Example_1), 11 (GO matrix A with its domains)
    and 12 (the band GO session, 49,920 x 4,373), each time and size
    printed beside the card: (a) ``SAFE.save`` of each, unpickled here:
    no tensor in the pickle, every public array bitwise equal (the band's
    bytes for the band session, whose file must stay within 10% of its
    band, f32 log-survival, int8 indicator and attribute matrix, with no
    dense N x N); a process started with ``CUDA_VISIBLE_DEVICES=""``
    unpickles phase 11's file and its ``nes``, ``nes_binary``,
    ``_nes_column`` and ``node2domain`` equal the card session's; the
    unpickled phase 11 session re-clustered at 0.5 and trimmed equals the
    original so treated. (b) ``save_session`` / ``load_session(...,
    device='cuda')`` of each: arrays bitwise (the band in its dtype),
    tables equal (node2domain's NES as its JSON rounds it),
    ``define_top_attributes`` resumed with the original's top terms and no
    launch. (c) ``plot_data.domain_mixture_colors`` of phase 11's session
    within 1e-12 of the host formula on the downloaded indicator; every
    97th band NES and indicator column equal to the full device matrices,
    an out-of-range column refused. (d) one steady Example_1 run as its
    stages under ``StageTimer`` inside ``profiling.trace``: 32/64/32
    launches, and the Chrome trace's kernel events of each kernel. (e)
    ``utils.make_go`` on a seeded ontology of 12,000 biological-process
    terms (depth 12, one to three parents, 2,000 other-namespace and 200
    obsolete terms) and 3,971 loci of phase 4's keys: the matrix equal to
    a depth-first closure, then its TSV loaded into phase 4's session and
    ``compute_pvalues`` (hypergeometric, no launch). (f)
    ``tools/cuda_validate.py`` in-process: ``VERIFY OK``. chip_smoke
    imports no matplotlib;
16. the memory planner (``hbm.py``, run after phase 15) on phase 12's band
    GO session: ``device_hbm_budget()``; cold runs (caches dropped) with
    each residency forced ('device', 'f16', 'host'), the allocator sampled
    at each phase end (``hbm.record_peak``): each phase's rise of
    ``max_memory_allocated`` and of ``max_memory_reserved`` beside the
    plan's modeled peak, none of the allocated rises above its model, one
    launch of ``close_diag``, ``relax_panel`` and ``relax_skew_sym`` a FW
    round; 'host' bitwise 'device', 'f16' the device values rounded to
    f16, indicator and counts equal; 'auto' with ``hbm_budget_bytes``
    between the modeled device and f16 census peaks takes f16, between f16
    and host host, with the forced runs' results; a budget of 1e8 B raises
    the plan's ``ValueError`` with no allocation and no launch; the
    chunked operand prep bitwise the device prep, each peak beside its
    model; each residency run again with the process capped
    (``torch.cuda.set_per_process_memory_fraction``) at what it held
    before plus the plan's largest phase peak, completing with the
    uncapped run's results (the ``planner`` lines);
17. the dense engines on a mesh at the Example_1 width (3,971 nodes, npad
    4,096, 1,000 permutations, GO matrix A): the kernels at the sharded
    FW's shapes, built as its rounds build their operands, bitwise their
    plain versions, CUDA-event times beside the bound: ``relax_full`` at
    the world-2 slab (2,048 x 4,096) and the 2 x 2 tile (2,048 x 2,048);
    ``relax_panel``'s pivot rows at 128 x 4,096 and 128 x 2,048 and its
    pivot columns at 4,096 x 128 and 2,048 x 128 (column views of the
    world-1 and world-2 slabs) and 2,048 x 128 (the 2 x 2 mesh's reduced
    panel); ``close_diag`` on a pivot tile viewed in a 128 x 4,096 panel
    and on a 2 x 2 mesh's reduced tile; a one-rank 'data'
    mesh over NCCL in this process, then one spawn of 2 gloo processes on
    the card running the 'data', 'perm' and 'attr' meshes in turn, and
    one of 4 for a 2 x 2 ('row', 'col') mesh: the sharded FW bitwise
    ``ops.apsp(d0)`` (classic, ``relax_full``) with 32 launches of
    ``close_diag`` and ``relax_full`` and 64 of ``relax_panel`` a rank;
    every rank's neighborhoods identical to phase 4's; the null counts
    equal to the ranks' seeded streams replayed on one device and summed,
    999 permutations on the 'perm' mesh rounded to 1,000; the 'attr'
    run's census, log sf, indicator and counts bitwise phase 10's run of
    matrix A. The walls (min of 3), the sharded FW alone and the gloo
    start-up per rank (the ``mesh`` lines), and each kernel's device time
    (profiler) at those shapes;
18. the rest of the row-sharded band engine (run after phase 17) at full
    width: ``relax_band_rows`` at every window cut the world-2 ranks
    launch on phase 6's band (bitwise plain, device time, bound, and each
    rank's B3 time over the FW); then on a one-rank 'data' mesh over NCCL
    in this process and on two gloo processes on the card: band GO of
    phase 12's matrix (49,920 x 4,373) by the sharded class table
    (``table-band-sharded``; walls min of 3, of 2 a rank at world 2) and
    the sharded f64 tail loop (``hypergeom_engine='loop'``,
    ``loop-band-sharded``; one run), each with
    one ``close_diag`` and ``relax_panel`` a FW round and
    ``relax_band_row`` as phase 8 counts it, the indicator band,
    nes_binary and counts equal to phase 12's ``table-band`` run (the
    class table's log sf bitwise), the stored results in host memory,
    and each rank's allocated rise printed beside the per-rank plan
    (``hbm.band_go_shard_hbm_plan``: JAX's per-shard terms and the port's
    transients) and the host bytes a rank, which the rise must not exceed,
    each world-2 rank's rise below world 1's; at world 2 the class table
    again under ``hbm_budget_bytes`` 3.0 GB, between the world-2 plan and
    the 4.555 GB that the plan counted while every rank assembled the
    results on its card, with phase 12's results (the ``band mesh
    capped`` line); the bit-packed band of phase 6's attribute
    (``band_indicator_bits=True``): phase 13 (d)'s bytes, its scores within
    1e-5 and its counts (exactly at world 1, within near-tie flips at
    world 2, as phase 8); the packed euclidean band at 1,000,000 points at
    world 1 (phase 13 (a)'s bytes, scores, counts) and at 49,920 points on
    the two ranks (a single-device run's); then
    ``safepy_tpu_torch.dryrun.dryrun(2, device="cuda")``, its six legs on
    two gloo ranks on the card (the ``band mesh`` lines);
9. print a JSON line of the kernels (times, bounds, launches of every
   path: each FW kernel's and the class table's, counted at the launch and
   reset before each path; phase 10's as ``go_binary_loop`` and ``go_binary_table``, phase
   12's as ``band_go_table`` and ``band_go_hostchunks``, phase 13's as
   ``band_bf``, ``band_bf_fallback``, ``band_packed``,
   ``band_packed_table`` and the ``euclid_band_*`` paths, phase 14's as
   ``file_example1``, ``file_mat_twin`` and ``file_cli``, phase 15's as
   ``profiled_example1``, ``checkpoint_resume`` and ``make_go_binary``,
   phase 16's as ``planner_*``, phase 17's as ``mesh_*``, phase 18's as
   ``band_go_table_sharded_*``, ``band_go_loop_sharded_*``,
   ``band_packed_sharded_*`` and ``euclid_band_packed_sharded_*``, the
   phase-17 shapes of ``relax_full``, ``relax_panel`` and ``close_diag``
   as their ``mesh_shapes`` and phase 18's window cuts of
   ``relax_band_row`` as its ``window_cuts_world2``), then the
   card, then the result line. The domain stage runs no hand-written kernel:
   its products are ``torch.matmul``; the layouts are plain torch, as JAX
   keeps them in ``jnp``.

Imports torch, numpy, scipy and the port only; needs one card, nvcc, g++
(the host edge-list parser) and nvidia-smi. Phase 8 starts two processes
and joins them; phase 14 one host thread; phase 15 one process; phase 17
two, then four, and joins them; phase 18 two, then two more (the dry
run), and joins them.
"""

from __future__ import annotations

import csv
import gc
import hashlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import scipy.io as spio
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy.sparse import coo_matrix, csc_matrix, issparse
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.sparse.csgraph import dijkstra, shortest_path
from scipy.spatial import cKDTree
from scipy.spatial.distance import pdist
from scipy.stats import hypergeom
from torch.profiler import ProfilerActivity, profile

from safepy_tpu_torch import SAFE, cli, hbm, native, ops
from safepy_tpu_torch import checkpoint as ck
from safepy_tpu_torch import domains as domains_mod
from safepy_tpu_torch import pipeline as pipe
from safepy_tpu_torch.io import attributes as attr_io
from safepy_tpu_torch.io import edgelist
from safepy_tpu_torch.io import layout as layout_mod
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.io.record import NetworkRecord
from safepy_tpu_torch.ops import apsp_bandstore as bst
from safepy_tpu_torch.ops import apsp_cuda as K
from safepy_tpu_torch.ops import domains_device as dd
from safepy_tpu_torch.ops import enrich_band as eb
from safepy_tpu_torch.ops import hypergeom_table as htab
from safepy_tpu_torch.ops.fdr import fdr_bh_logsf, fdr_bh_logsf_np
from safepy_tpu_torch.ops.hypergeom import (_sf_parts, finalize_logsf_device,
                                            lgamma_table, tail_iterations)
from safepy_tpu_torch.ops.hypergeom_table import (build_logsf_table,
                                                  table_lookup)
from safepy_tpu_torch.ops.apsp import pad_distances
from safepy_tpu_torch.ops.apsp_banded import (apsp_banded_fw,
                                              apsp_banded_unpermuted,
                                              banded_order, window_width)
from safepy_tpu_torch.ops.neighborhoods import (_initial_distances,
                                                dense_initial_distances,
                                                inclusive_radius,
                                                initial_distances_device)
from safepy_tpu_torch.ops.permutation import (default_batch_size,
                                              prepare_valid, scan_counts)
from safepy_tpu_torch.parallel import band_sharded as bsh
from safepy_tpu_torch.parallel import (apsp_sharded, apsp_sharded_2d,
                                       hypergeom_counts_sharded, make_mesh)
from safepy_tpu_torch.parallel.permutation_sharded import rank_seed

N_NODES, KNN, N_EDGES = 3971, 16, 28202   # bench.py:23-24,60
SEED_GRAPH, SEED_ATTR, SEED_NULL = 0, 1, 1885  # bench.py:65,145,152
BAND_NODES, BAND_KNN, SEED_BAND_ATTR = 49920, 9, 2  # bench.py:326,343-344
N_PERM = 1000
N_SOURCES, SEED_SOURCES = 512, 3  # Dijkstra rows checked at band scale
# phase 10: two GO-like binary matrices of the Costanzo GO biological-process
# width (4,373 terms) on the Example_1 network, 10% unannotated genes
GO_ATTRS, GO_NAN_SHARE, GO_SAMPLES = 4373, 0.1, 10000
SEED_GO_A, SEED_GO_B, SEED_GO_SAMPLES = 21, 22, 23
# phase 11: top terms whose condensed jaccard is held against scipy's pdist
DOMAIN_SAMPLES, SEED_GO_NAMES = 512, 24
# phase 12: a GO matrix of matrix A's size law on phase 6's network
SEED_BAND_GO = 25
# phase 13: the euclidean band at a million points (a scatter/UMAP input),
# and at phase 6's size with kept distances and a GO matrix of 256 terms
EUCLID_NODES, EUCLID_ROWS, SEED_EUCLID = 1_000_000, 512, 26
EUCLID_GO_TERMS = 256
GO_WORDS = ("regulation", "of", "transport", "cell", "cycle", "protein",
            "the", "DNA", "repair", "to", "metabolic", "process", "via",
            "signaling", "positive", "negative", "membrane", "RNA")
# phase 14: the card layout's neighborhood-preservation statistic against
# the CPU layout's of the same graph and seed (float32 reductions round
# differently on the two, and 1,000 Adam steps carry the difference)
PRESERVATION_MARGIN = 0.05
BLOCK = 128
SRC = "safepy_tpu_torch/csrc/minplus.cu"
# phase 3's class tables (csrc/hypergeom_table.cu) at the 0.05 threshold:
# the band GO chunk of genome scale (M 18,440 annotated genes; 212 term
# sizes among 3-300, zero-padded to C 256; R = S_max = 256) and the dense
# fused route at Example_1's population (R 4,096, S_max 128, C 64)
TABLE_SRC = "safepy_tpu_torch/csrc/hypergeom_table.cu"
TABLE_LOG_THR, SEED_TABLE = float(np.log(0.05)), 5
TABLE_CASES = {"gobp_chunk": (18440, 256, 256), "dense": (3971, 4096, 128)}


def build_network(n=N_NODES, k=KNN, edge_budget=N_EDGES, seed=SEED_GRAPH):
    """bench.py:60 ``build_network`` in numpy/scipy: uniform coordinates in
    [-1, 1]^2, k-nearest-neighbour edges taken node by node up to the edge
    budget (None: all of them), Euclidean edge lengths. Returns (coords,
    edges, lengths, weights)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = set()
    for i in range(n):
        for j in nn[i, 1:]:
            edges.add((min(i, int(j)), max(i, int(j))))
            if edge_budget and len(edges) >= edge_budget:
                break
        if edge_budget and len(edges) >= edge_budget:
            break
    edges = np.array(sorted(edges), dtype=np.int64)
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def build_attribute(n=N_NODES, seed=SEED_ATTR):
    """bench.py:145-147: one normal attribute with 33% NaN."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.33, 0] = np.nan
    return vals


def build_band_attribute(n=BAND_NODES, seed=SEED_BAND_ATTR):
    """bench.py:457-458: one normal attribute with 30% NaN."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan
    return vals


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, inner=10, warmup=2, reps=5) -> float:
    """Median milliseconds per call of ``fn``, from ``inner`` back-to-back
    calls between two CUDA events (the host clock after a synchronise
    elsewhere). What a caller pays per call, host overhead included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def device_ms(fn, symbol, calls=10) -> float | None:
    """Mean device time per call of the CUDA kernel ``symbol`` launched by
    ``fn``, from torch.profiler (CUPTI); None where no such event shows."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages() if symbol in e.key)
    return total / calls / 1e3 if total else None


def device_ms_max(fn, symbol, tries=3) -> float | None:
    """:func:`device_ms`, the largest of ``tries`` readings: the profiler
    drops events at times (PERF.md section 7), which lowers or empties a
    reading and never raises one."""
    reads = [x for x in (device_ms(fn, symbol) for _ in range(tries)) if x]
    return max(reads) if reads else None


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", None)
                 or getattr(event, "self_cuda_time_total", 0.0))


def inf_laced(gen, shape, device, inf_share=0.3):
    x = torch.rand(shape, generator=gen, device=device)
    x[torch.rand(shape, generator=gen, device=device) < inf_share] = float("inf")
    return x


def max_abs_err(got, want) -> float:
    """Bitwise check: raise unless equal; return max |got - want| (0.0)."""
    if not torch.equal(got, want):
        fin = torch.isfinite(got) & torch.isfinite(want)
        bad = int((got != want).sum())
        raise AssertionError(f"kernel differs from its plain version at {bad} "
                             f"entries; inf pattern equal: "
                             f"{bool(torch.equal(fin, torch.isfinite(want)))}")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its min-plus candidates over the FP32 add+min issue rate. A candidate
# is one FP32 add and one FP32 min, two instructions on the CUDA cores,
# which issue 33.5 T instructions/s (the 67 TFLOP/s FP32 peak of NVIDIA's
# H100 SXM data sheet counts an FMA as two operations): 16.7 T candidates/s.
# The min issues at half the add's rate, 64 lanes a clock an SM, which is
# the same 16.7 T/s at 132 SMs and 1.98 GHz; addmin_rate measures the rate
# reached (phase 3).
HBM_BYTES_PER_S = 3.35e12
CANDIDATES_PER_S = 16.7e12
F32 = 4
# close_diag's 128 steps are dependent and run on one SM: its one-SM floor is
# 2 B^2 FP32 instructions a step over the SM's 128 FP32 lanes, at its clock
FP32_LANES_PER_SM = 128


def bound(candidates, nbytes):
    """(bound_ms, bound_by) of ``candidates`` min-plus candidates that must
    move ``nbytes``."""
    ops_ms = candidates / CANDIDATES_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


PROBE_CHAINS = 32  # chains a thread of csrc/minplus.cu addmin_probe_kernel


def addmin_rate(device, iters=4096, per_sm=4):
    """Phase 3: the card's FP32 add + min rate in candidates/s, from the
    register-only probe kernel (one add and one min a candidate, as in the
    min-plus kernels, and no memory access), ``per_sm`` CTAs of 256 threads
    for every SM, timed with CUDA events (median of 5 runs of 5 launches).
    Returns (rate, details)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * per_sm
    out = torch.empty(blocks * 256, device=device)
    ms = time_ms(lambda: native.launch("addmin_probe", K._ptr(out), 0.5, iters,
                                       blocks, K._stream(out)),
                 device, inner=5)
    if not torch.isfinite(out).all():
        raise AssertionError("add+min probe wrote non-finite values")
    rate = blocks * 256 * PROBE_CHAINS * iters / (ms * 1e-3)
    return rate, dict(sms=sms, ctas=blocks, iters=iters, ms=ms)


def relax_work(m, n, k, tiles_in=None, tiles_out=None, tile=BLOCK):
    """(candidates, bytes) of relaxing an (m, n) output against (m, k) and
    (k, n) operands; a tiled kernel that reads ``tiles_in`` and writes
    ``tiles_out`` (tile x tile) tiles of C counts only those."""
    if tiles_in is None:
        return m * n * k, (m * k + k * n + 2 * m * n) * F32
    return (tiles_in * tile * tile * k,
            (m * k + k * n + (tiles_in + tiles_out) * tile * tile) * F32)


def close_diag_cases(gen, blk, device):
    """Pivot tiles close_diag meets: a zero diagonal, +inf diagonal entries,
    all-+inf padding rows and columns, and a view at an offset into a wider
    matrix whose row stride is no multiple of 4."""
    def base():
        t = inf_laced(gen, (blk, blk), device)
        t.diagonal().zero_()
        return t
    inf_diag, padding, wide = base(), base(), inf_laced(
        gen, (blk + 3, 2 * blk + 5), device)
    inf_diag.diagonal()[::3] = float("inf")
    padding[blk - 40:] = float("inf")
    padding[:, blk - 40:] = float("inf")
    view = wide[3:, 5:5 + blk]
    view.diagonal().zero_()
    return {"zero_diag": base(), "inf_diag": inf_diag, "inf_padding": padding,
            "strided_view": view}


def sm_clock_mhz() -> float:
    """The SM's maximum clock, as nvidia-smi reports it (e.g. '1980 MHz')."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0].split()[0])


def check_kernels(device, window=1024, npad=4096, band_tiles=6):
    """Phase 3: each kernel against its plain version at the main path's
    shapes (block 128, window 1024 inside a 4096 matrix, dense 4096)."""
    gen = torch.Generator(device=device).manual_seed(7)
    b = BLOCK
    out = {}

    # close_diag on a pivot tile with a zero diagonal (the report's case),
    # then on the other tiles the rounds meet, at block 128 and 64
    tile = inf_laced(gen, (b, b), device)
    tile.diagonal().zero_()
    errs = [max_abs_err(K.close_diag(tile), K.close_diag_plain(tile))]
    shapes = {"tile": [b, b]}
    for blk in (b, 64):
        for case, t in close_diag_cases(gen, blk, device).items():
            errs.append(max_abs_err(K.close_diag(t), K.close_diag_plain(t)))
            if device.type == "cuda":
                shapes[f"{case}_{blk}_device_ms"] = device_ms(
                    lambda: K.close_diag(t), "close_diag_kernel")
    out["close_diag"] = dict(
        err=max(errs), ms=time_ms(lambda: K.close_diag(tile), device),
        plain_ms=time_ms(lambda: K.close_diag_plain(tile), device, inner=2),
        work=(b ** 3, 2 * b * b * F32), shapes=shapes)
    if device.type == "cuda":
        out["close_diag"]["device_ms"] = device_ms(
            lambda: K.close_diag(tile), "close_diag_kernel")
        clock_hz = sm_clock_mhz() * 1e6
        out["close_diag"]["bound_one_sm_ms"] = (
            b * (2 * b * b / FP32_LANES_PER_SM) / clock_hz * 1e3)
        shapes["sm_clock_max_mhz"] = clock_hz / 1e6

    # relax_panel in its two forms: rows min(P, diag (x) P), cols min(Q, Q (x) diag)
    diag = K.close_diag_plain(tile)
    p = inf_laced(gen, (b, window), device)
    q = inf_laced(gen, (window, b), device)
    errs = [max_abs_err(K.relax_panel(p, diag, p), K.relax_panel_plain(p, diag, p)),
            max_abs_err(K.relax_panel(q, q, diag), K.relax_panel_plain(q, q, diag))]
    rows_ms = time_ms(lambda: K.relax_panel(p, diag, p), device)
    cols_ms = time_ms(lambda: K.relax_panel(q, q, diag), device)
    rows_plain = time_ms(lambda: K.relax_panel_plain(p, diag, p), device,
                         inner=2)
    cols_plain = time_ms(lambda: K.relax_panel_plain(q, q, diag), device,
                         inner=2)
    rows, cols = relax_work(b, window, b), relax_work(window, b, b)
    out["relax_panel"] = dict(
        err=max(errs), ms=rows_ms + cols_ms, plain_ms=rows_plain + cols_plain,
        work=(rows[0] + cols[0], rows[1] + cols[1]),
        shapes={"rows_128x1024_ms": rows_ms, "rows_plain_ms": rows_plain,
                "cols_1024x128_ms": cols_ms, "cols_plain_ms": cols_plain})
    # the band path's pivot row (bt 12, W 3,200)
    pb = inf_laced(gen, (b, 25 * b), device)
    out["relax_panel"]["err"] = max(
        out["relax_panel"]["err"],
        max_abs_err(K.relax_panel(pb, diag, pb),
                    K.relax_panel_plain(pb, diag, pb)))
    if device.type == "cuda":
        out["relax_panel"]["device_ms"] = device_ms(
            lambda: (K.relax_panel(p, diag, p), K.relax_panel(q, q, diag)),
            "relax_panel_kernel")
        sh = out["relax_panel"]["shapes"]
        sh["rows_device_ms"] = device_ms(lambda: K.relax_panel(p, diag, p),
                                         "relax_panel_kernel")
        sh["cols_device_ms"] = device_ms(lambda: K.relax_panel(q, q, diag),
                                         "relax_panel_kernel")
        sh["band_rows_128x3200_ms"] = time_ms(
            lambda: K.relax_panel(pb, diag, pb), device)
        sh["band_rows_128x3200_device_ms"] = device_ms(
            lambda: K.relax_panel(pb, diag, pb), "relax_panel_kernel")

    # relax_window_sym: the slice's window and the dense 4096 round, in
    # place; each over its tile list, in the form the wrapper picks for its
    # length, beside its own bound
    d = inf_laced(gen, (npad, npad), device)
    d = torch.minimum(d, d.T).contiguous()
    lo = npad // 2 - window // 2
    cases = {"window": (lo, window, band_tiles), "dense": (0, npad, npad // b)}
    shapes, errs = {}, []
    for name, (lo_, w_, bt) in cases.items():
        nbw = w_ // b
        tiles = len(K.window_tiles(nbw, min(bt, nbw - 1)))
        shapes[f"{name}_tiles"] = tiles
        shapes[f"{name}_form"] = "plain" if device.type != "cuda" else (
            "whole" if K.window_sym_whole(tiles, b, device) else "sub-tile")
        shapes[f"{name}_bound_ms"] = bound(*relax_work(
            w_, w_, b, tiles, 2 * tiles - nbw))[0]
        qw = inf_laced(gen, (w_, b), device)
        pw = inf_laced(gen, (b, w_), device)
        got, want = d.clone(), d.clone()
        K.relax_window_sym(qw, pw, got, lo_, w_, bt)
        K.relax_window_sym_plain(qw, pw, want, lo_, w_, bt)
        errs.append(max_abs_err(got, want))
        # relaxing again with the same panels is idempotent: same work, same bits
        shapes[f"{name}_ms"] = time_ms(
            lambda: K.relax_window_sym(qw, pw, got, lo_, w_, bt), device)
        shapes[f"{name}_plain_ms"] = time_ms(
            lambda: K.relax_window_sym_plain(qw, pw, want, lo_, w_, bt),
            device, inner=2)
        shapes[f"{name}_shape"] = [w_, w_, bt]
        if device.type == "cuda":
            # both forms' kernels: relax_window_sym(_sub)_kernel
            shapes[f"{name}_device_ms"] = device_ms(
                lambda: K.relax_window_sym(qw, pw, got, lo_, w_, bt),
                "relax_window_sym")
        errs.append(max_abs_err(got, want))
    nbw = window // b
    upper = shapes["window_tiles"]
    out["relax_window_sym"] = dict(err=max(errs), ms=shapes["window_ms"],
                                   plain_ms=shapes["window_plain_ms"],
                                   work=relax_work(window, window, b, upper,
                                                   2 * upper - nbw),
                                   device_ms=shapes.get("window_device_ms"),
                                   shapes=shapes)
    return out


# (tag, bt, block, extra columns of the band beyond W): the window of a
# relax_skew case is a view at column extra // 5 of such a band, so its row
# stride exceeds W where extra > 0. The first case is the report's shape.
# At block 128, bt 12 lists enough tiles for the kernels to take whole
# tiles a CTA; the smaller bt and block 64 take 64x64 sub-tiles.
SKEW_CASES = (("slice", 12, BLOCK, 0), ("small", 2, BLOCK, 0),
              ("bt0", 0, BLOCK, 0), ("bt1", 1, BLOCK, 0),
              ("slice_strided", 12, BLOCK, 40), ("bt0_block64", 0, 64, 0),
              ("bt1_block64", 1, 64, 0), ("bt3_block64", 3, 64, 0),
              ("bt12_block64", 12, 64, 0), ("bt2_block64_strided", 2, 64, 40))


def check_skew_kernels(device, cases=SKEW_CASES, timed=("slice", "small")):
    """Phase 3, band storage: relax_skew_sym and relax_skew against their
    plain versions on a +inf-laced symmetric window inside a band (rows
    above and below it, wider rows where the case says), at the 49,920-node
    band shape (bt 12, W 3,200) and at bt 0, 1 and 2 at block 128, at bt 0,
    1, 2, 3 and 12 at block 64; the ``timed`` cases also timed."""
    gen = torch.Generator(device=device).manual_seed(11)
    out = {}
    for name, kernel, plain, symbol in (
            ("relax_skew_sym", K.relax_skew_sym, K.relax_skew_sym_plain,
             "relax_skew_sym_kernel"),
            ("relax_skew", K.relax_skew, K.relax_skew_plain,
             "relax_skew_kernel")):
        shapes, errs = {}, []
        for tag, bt, b, extra in cases:
            w = (2 * bt + 1) * b
            c0 = extra // 5
            s = inf_laced(gen, (w + 2 * b, w + extra), device)
            win = s[b:b + w, c0:c0 + w]
            win.copy_(torch.minimum(win, win.T))
            p = inf_laced(gen, (b, w), device)
            q = bst.skew_pivot_column(win, bt, b)
            got, want = s.clone(), s.clone()
            gw, ww = got[b:b + w, c0:c0 + w], want[b:b + w, c0:c0 + w]
            kernel(gw, q, p, bt)
            plain(ww, q, p, bt)
            errs.append(max_abs_err(got, want))
            shapes[f"{tag}_shape"] = [w, w, bt, b, s.stride(0)]
            if tag not in timed:
                continue
            # relaxing again with the same operands is idempotent
            shapes[f"{tag}_ms"] = time_ms(lambda: kernel(gw, q, p, bt), device)
            shapes[f"{tag}_plain_ms"] = time_ms(lambda: plain(ww, q, p, bt),
                                                device, inner=2)
            shapes[f"{tag}_device_ms"] = device_ms(
                lambda: kernel(gw, q, p, bt), symbol)
            errs.append(max_abs_err(got, want))
        tag, bt, b, _ = cases[0]
        w = (2 * bt + 1) * b
        if name == "relax_skew_sym":  # upper wedge; its jj >= 1 tiles mirrored
            tiles = sum(2 * bt + 1 - jj for jj in range(bt + 1))
            written = 2 * tiles - (2 * bt + 1)
        else:  # every tile whose pivot-row tile lies in the slab
            tiles = written = sum(abs(o + j - 2 * bt) <= bt
                                  for o in range(2 * bt + 1)
                                  for j in range(2 * bt + 1))
        out[name] = dict(err=max(errs), ms=shapes[f"{tag}_ms"],
                         plain_ms=shapes[f"{tag}_plain_ms"],
                         device_ms=shapes[f"{tag}_device_ms"],
                         work=relax_work(w, w, b, tiles, written, tile=b),
                         shapes=shapes)
    return out


def check_band_row_kernel(device, cases=((12, "slice"), (2, "small"))):
    """Phase 3, row-sharded band FW (B3): relax_band_row on one +inf-laced
    window row, Q a tile of C and P a slice of an inf-extended pivot row,
    and relax_band_rows, a round's window rows in place in one launch, the
    whole window and windows cut at their first and last rows, each against
    its plain version, at the 49,920-node band shape (block 128, bt 12, W
    3,200) and at bt 2 (W 640). The report's row is the whole window of the
    slice, the launch the sharded rounds make."""
    gen = torch.Generator(device=device).manual_seed(17)
    b = BLOCK
    shapes, errs = {}, []
    for bt, tag in cases:
        nt = 2 * bt + 1
        w = nt * b
        c = inf_laced(gen, (b, w), device)
        p_ext = inf_laced(gen, (b, w + 2 * bt * b), device)
        q, p = c[:, (2 * bt - 1) * b:2 * bt * b], p_ext[:, b:b + w]
        errs.append(max_abs_err(K.relax_band_row(q, p, c),
                                K.relax_band_row_plain(c, q, p)))
        shapes[f"{tag}_row_ms"] = time_ms(lambda: K.relax_band_row(q, p, c),
                                          device)
        shapes[f"{tag}_row_plain_ms"] = time_ms(
            lambda: K.relax_band_row_plain(c, q, p), device, inner=2)
        shapes[f"{tag}_row_device_ms"] = device_ms(
            lambda: K.relax_band_row(q, p, c), "relax_band_row_kernel")
        shapes[f"{tag}_row_shape"] = [b, w, b]
        # the rows of a round inside a slab, with a block-row above and below
        for lo, hi in ((0, nt), (bt // 2, nt), (0, nt - bt // 2)):
            slab = inf_laced(gen, ((hi - lo + 2) * b, w), device)
            got, want = slab.clone(), slab.clone()
            K.relax_band_rows(got[b:-b], p_ext, lo, hi)
            K.relax_band_rows_plain(want[b:-b], p_ext, lo, hi)
            errs.append(max_abs_err(got, want))
        rows = got[b:-b]
        # relaxing again: new Q snapshots, the same work
        shapes[f"{tag}_rows_ms"] = time_ms(
            lambda: K.relax_band_rows(rows, p_ext, lo, hi), device)
        shapes[f"{tag}_rows_plain_ms"] = time_ms(
            lambda: K.relax_band_rows_plain(rows, p_ext, lo, hi), device,
            inner=1, reps=3)
        shapes[f"{tag}_rows_device_ms"] = device_ms(
            lambda: K.relax_band_rows(rows, p_ext, lo, hi),
            "relax_band_row_kernel")
        shapes[f"{tag}_rows_shape"] = [hi - lo, b, w, b]
    # the report's call: the whole window of the slice, as a sharded round
    # at world 1 makes it
    bt = cases[0][0]
    nt = 2 * bt + 1
    w = nt * b
    p_ext = inf_laced(gen, (b, w + 2 * bt * b), device)
    rows = inf_laced(gen, (nt * b, w), device)
    ms = time_ms(lambda: K.relax_band_rows(rows, p_ext, 0, nt), device)
    plain_ms = time_ms(lambda: K.relax_band_rows_plain(rows, p_ext, 0, nt),
                       device, inner=1, reps=3)
    dev_ms = device_ms(lambda: K.relax_band_rows(rows, p_ext, 0, nt),
                       "relax_band_row_kernel")
    return {"relax_band_row": dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
        work=(nt * b * w * b, (2 * nt * b * w + b * (w + 2 * bt * b)) * F32),
        shapes=dict(shapes, window_rows=[nt, b, w, b]))}


# (w, band_tiles) of window relax lists from Example_1's 35 tiles to the
# dense FW's 528, for the two forms' crossover (block 128)
FORM_CASES = ((1024, 6), (4096, 4), (4096, 8), (4096, 10), (4096, 31))


def window_sym_forms(device, cases=FORM_CASES):
    """Phase 3 on the card: relax_window_sym's kernel in both list forms
    (whole tiles, 32x32 sub-tiles) at each list length of ``cases``, each
    bitwise against the plain version; {tiles: (whole device ms, sub-tile
    device ms, the form the wrapper takes)}."""
    gen = torch.Generator(device=device).manual_seed(19)
    b = BLOCK
    out = {}
    for w, bt in cases:
        d = inf_laced(gen, (w, w), device)
        d = torch.minimum(d, d.T).contiguous()
        q, p = inf_laced(gen, (w, b), device), inf_laced(gen, (b, w), device)
        want = d.clone()
        K.relax_window_sym_plain(q, p, want, 0, w, bt)
        tiles = K._device_window_tiles(w // b, min(bt, w // b - 1), device)
        row = []
        for whole in (1, 0):
            got = d.clone()

            def launch():
                native.launch("relax_window_sym", K._ptr(tiles),
                              tiles.shape[0], K._ptr(q), K._ptr(p),
                              K._ptr(got), w, 0, w, b, whole, K._stream(got))
            launch()
            max_abs_err(got, want)
            row.append(device_ms(launch, "relax_window_sym", calls=20))
        whole = K.window_sym_whole(tiles.shape[0], b, device)
        out[tiles.shape[0]] = (*row, "whole" if whole else "sub-tile")
    return out


# (w, band_tiles) of banded relax_full lists (both triangles) from
# Example_1's 62 tiles through 154, 304 and 518 to every tile of 4096^2
FULL_FORM_CASES = ((1024, 6), (4096, 2), (3072, 7), (4096, 9), (4096, 31))


def full_relax_forms(device, cases=FULL_FORM_CASES):
    """Phase 3 on the card: three kernels over the banded relax_full's tile
    list at each length of ``cases`` (block 128, square windows, contiguous
    operands), each bitwise against the plain version: the banded kernel's
    two forms (64x64 sub-tiles, whole tiles on the tile engine), and
    relax_window_sym's 32x32 sub-tiles on the panel body over the same
    mirror-free list; {tiles: (their device ms in that order, the form the
    wrapper takes)}."""
    gen = torch.Generator(device=device).manual_seed(23)
    b = BLOCK
    out = {}
    for w, bt in cases:
        d = inf_laced(gen, (w, w), device)
        q, p = inf_laced(gen, (w, b), device), inf_laced(gen, (b, w), device)
        want = d.clone()
        K.relax_full_plain(q, p, want, bt)
        tiles = K._device_full_tiles(w // b, w // b, bt, device)
        nt = tiles.shape[0]
        row = []
        for symbol, launch in (
                ("relax_full_banded_sub_kernel",
                 lambda got: native.launch(
                     "relax_full_banded", K._ptr(tiles), nt, K._ptr(q), b,
                     K._ptr(p), w, K._ptr(got), w, w, w, b, 0,
                     K._stream(got))),
                ("relax_full_banded_whole_kernel",
                 lambda got: native.launch(
                     "relax_full_banded", K._ptr(tiles), nt, K._ptr(q), b,
                     K._ptr(p), w, K._ptr(got), w, w, w, b, 1,
                     K._stream(got))),
                ("relax_window_sym_sub_kernel",
                 lambda got: native.launch(
                     "relax_window_sym", K._ptr(tiles), nt, K._ptr(q),
                     K._ptr(p), K._ptr(got), w, 0, w, b, 0,
                     K._stream(got)))):
            got = d.clone()
            launch(got)
            max_abs_err(got, want)
            # relaxing again with the same operands is idempotent
            row.append(device_ms(lambda: launch(got), symbol, calls=20))
            max_abs_err(got, want)
        whole = K.full_banded_whole(nt, w, w, b, device)
        out[nt] = (*row, "whole" if whole else "sub-tile")
    return out


def check_full_kernels(device, window=1024, npad=4096, band_tiles=6):
    """Phase 3, op-level path: relax_full over the dense 4096 matrix (k 128)
    and banded on the 1,024 window (band_tiles 6) inside it, in place; one
    4096 x 4096 x 4096 minplus_product, whose plain version (a 4,096-step
    loop) is timed once."""
    gen = torch.Generator(device=device).manual_seed(13)
    b = BLOCK
    out = {}
    d = inf_laced(gen, (npad, npad), device)
    lo = npad // 2 - window // 2
    for name, lo_, w, bt in (("relax_full", 0, npad, None),
                             ("relax_full_banded", lo, window, band_tiles)):
        q = inf_laced(gen, (w, b), device)
        p = inf_laced(gen, (b, w), device)
        got, want = d.clone(), d.clone()
        gw, ww = got[lo_:lo_ + w, lo_:lo_ + w], want[lo_:lo_ + w, lo_:lo_ + w]
        K.relax_full(q, p, gw, bt)
        K.relax_full_plain(q, p, ww, bt)
        errs = [max_abs_err(got, want)]
        # relaxing again with the same panels is idempotent: same bits
        ms = time_ms(lambda: K.relax_full(q, p, gw, bt), device)
        plain_ms = time_ms(lambda: K.relax_full_plain(q, p, ww, bt), device,
                           inner=2)
        # the banded kernel's two forms: relax_full_banded_(sub|whole)_kernel
        dev_ms = device_ms(lambda: K.relax_full(q, p, gw, bt),
                           "relax_full_kernel" if bt is None
                           else "relax_full_banded")
        errs.append(max_abs_err(got, want))
        nt = w // b
        tiles = nt * nt if bt is None else len(K.full_tiles(nt, nt, bt))
        shapes = {"window": [w, w, b], "band_tiles": bt, "tiles": tiles}
        if bt is not None and device.type == "cuda":
            shapes["form"] = ("whole" if K.full_banded_whole(tiles, w, w, b,
                                                             device)
                              else "sub-tile")
        out[name] = dict(err=max(errs), ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms,
                         work=relax_work(w, w, b, tiles, tiles),
                         shapes=shapes)
    # a ragged product with negative entries (the op level takes any f32),
    # rows of a and columns of b at +inf, b a view of row stride 1,303
    ar = inf_laced(gen, (1000, 777), device) * 4 - 2
    br = (inf_laced(gen, (777, 1303), device) * 4 - 2)[:, 1:1301]
    ar[::7] = float("inf")
    br[:, ::5] = float("inf")
    ragged_err = max_abs_err(K.minplus_product(ar, br),
                             K.minplus_product_plain(ar, br))
    del ar, br
    a = inf_laced(gen, (npad, npad), device)
    bm = inf_laced(gen, (npad, npad), device)
    got = K.minplus_product(a, bm)
    sync(device)
    t0 = time.perf_counter()
    want = K.minplus_product_plain(a, bm)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, want)
    del want
    out["minplus_product"] = dict(
        err=max(err, ragged_err), plain_ms=plain_ms,
        ms=time_ms(lambda: K.minplus_product(a, bm), device, inner=3,
                   warmup=1, reps=3),
        device_ms=device_ms(lambda: K.minplus_product(a, bm),
                            "minplus_product_kernel", calls=3),
        work=(npad ** 3, 3 * npad * npad * F32),
        shapes={"mkn": [npad, npad, npad], "plain": "one call",
                "ragged_mkn_negative": [1000, 777, 1300]})
    return out


def table_classes(tag):
    """The class totals ``K_dist`` (f64, zero-padded) of a TABLE_CASES case."""
    if tag == "dense":
        return np.r_[np.arange(3, 120, 2), [0.0] * 5]
    out = np.zeros(256)
    out[:212] = np.sort(np.random.default_rng(SEED_TABLE).choice(
        np.arange(3, 301), 212, replace=False))
    return out


def check_table_kernel(device, cases=TABLE_CASES):
    """Phase 3's class table: the kernel (``build_logsf_table`` on a CUDA
    ``K_dist``, one launch a table) ``torch.equal`` to the slot loop
    ``htab._build_logsf_table_torch`` run on the same card, at each case;
    per call (CUDA events) and device time, the loop's time as plain, and
    the bound: the f32 table written once at the HBM rate."""
    out = {}
    for tag, (M, R, S_max) in cases.items():
        K_dist = torch.as_tensor(table_classes(tag), device=device)
        C = len(K_dist)
        kw = dict(R=R, S_max=S_max, C=C)

        def kernel():
            return build_logsf_table(K_dist, M, TABLE_LOG_THR, **kw)

        def plain():
            return htab._build_logsf_table_torch(K_dist, M, TABLE_LOG_THR,
                                                 **kw)
        reset_launches()
        got = kernel()
        if device.type == "cuda" and launch_counts() != dict(
                {name: 0 for name in K.LAUNCHES}, logsf_table=1):
            raise AssertionError(f"table {tag}: launches {launch_counts()}")
        want = plain()
        if not torch.equal(got, want):
            bad = int(((got != want) & ~(got.isnan() & want.isnan())).sum())
            raise AssertionError(f"table {tag}: {bad} cells differ from the "
                                 "slot loop's")
        del got, want
        nbytes = 4 * R * S_max * C
        out[tag] = dict(
            M=M, shape=[S_max, C, R], bytes=nbytes,
            ms=time_ms(kernel, device),
            device_ms=(device_ms(kernel, "logsf_table_kernel")
                       if device.type == "cuda" else None),
            plain_ms=time_ms(plain, device, inner=1, warmup=1, reps=3),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def directed_knn(coords, k=KNN):
    """Dense f32 matrix of the arcs i -> each of i's k nearest neighbours,
    of Euclidean length, not mirrored (duplicates min-reduced), and the
    scipy CSR matrix of the same arcs."""
    n = len(coords)
    _, nn = cKDTree(coords).query(coords, k=k + 1)
    u = np.repeat(np.arange(n), k)
    v = nn[:, 1:].ravel()
    d = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(d, 0.0)
    np.minimum.at(d, (u, v), np.hypot(*(coords[u] - coords[v]).T)
                  .astype(np.float32))
    off = np.isfinite(d) & ~np.eye(n, dtype=bool)
    iu, iv = np.nonzero(off)
    return d, coo_matrix((d[iu, iv].astype(np.float64), (iu, iv)),
                         shape=(n, n)).tocsr()


def run_ops_path(device, net, vals, num_permutations=N_PERM, steady=3):
    """Phase 7: the op-level path (``ops.apsp`` with the JAX defaults, the
    squaring, the classic banded FW, the flagship step of
    ``__graft_entry__.entry()``) at the Example_1 width, on the undirected
    network and on a directed 16-NN matrix of the same coordinates."""
    coords, edges, lengths, _ = net
    n = len(coords)
    nb = -(-n // BLOCK)
    npad = nb * BLOCK
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())  # SAFE's default
    r = float(inclusive_radius(nr))
    out = {}

    def launched(fn):
        reset_launches()
        res = fn()
        sync(device)
        return res, launch_counts()

    def best(fn):
        times = []
        for _ in range(steady):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    # undirected: the classic FW (B5) == the mirror-halved one (B7)
    d0 = torch.as_tensor(dense_initial_distances(n, edges, lengths),
                         device=device)
    classic, out["fw_launches"] = launched(lambda: ops.apsp(d0))
    check_launches(device, out["fw_launches"], close_diag=nb,
                   relax_panel=2 * nb, relax_full=nb)
    if not torch.equal(classic, ops.apsp(d0, symmetric=True)):
        raise AssertionError("classic and symmetric FW differ")
    oracle = dijkstra_indicator(coords, edges, lengths, r)
    if not np.array_equal((classic <= r).cpu().numpy(), oracle):
        raise AssertionError("classic FW indicator differs from Dijkstra's")

    # the classic banded window (B6) == the symmetric one (B7), in the
    # geometric banded order
    order, band = banded_order(coords, nr * (1 + 1e-5))
    window = out["window"] = window_width(n, band)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    rank_dev = torch.as_tensor(rank, device=device)
    pe = torch.as_tensor(rank[edges], device=device)
    init = _initial_distances(pe[:, 0], pe[:, 1],
                              torch.as_tensor(lengths, device=device),
                              num_nodes=n, size=npad)
    banded, out["banded_launches"] = launched(
        lambda: apsp_banded_fw(init.clone(), window=window, symmetric=False))
    check_launches(device, out["banded_launches"], close_diag=nb,
                   relax_panel=2 * nb, relax_full_banded=nb)
    if not torch.equal(banded, apsp_banded_fw(init.clone(), window=window)):
        raise AssertionError("classic and symmetric banded FW differ")

    # squaring (B1): the same neighborhoods, distances within 1e-6
    sq, out["sq_launches"] = launched(
        lambda: ops.apsp(d0, method="pallas_squaring"))
    check_launches(device, out["sq_launches"],
                   minplus_product=int(np.ceil(np.log2(n))))
    if not np.array_equal((sq <= r).cpu().numpy(), oracle):
        raise AssertionError("squaring indicator differs from Dijkstra's")
    fin = torch.isfinite(classic)
    if not torch.equal(fin, torch.isfinite(sq)):
        raise AssertionError("squaring and FW reach different pairs")
    pos = fin & (classic > 0)
    out["sq_rel"] = float(((sq - classic).abs()[pos] / classic[pos]).max())
    if out["sq_rel"] > 1e-6:
        raise AssertionError(f"squaring differs from FW by {out['sq_rel']}")
    del sq

    # directed: classic dense and banded against scipy's directed Dijkstra
    dd, arcs = directed_knn(coords)
    dd_dev = torch.as_tensor(dd, device=device)
    want = dijkstra(arcs, directed=True, limit=r) <= r
    dfw, out["dir_launches"] = launched(lambda: ops.apsp(dd_dev))
    check_launches(device, out["dir_launches"], close_diag=nb,
                   relax_panel=2 * nb, relax_full=nb)
    if not np.array_equal((dfw <= r).cpu().numpy(), want):
        raise AssertionError("directed FW indicator differs from Dijkstra's")
    db = pad_distances(torch.as_tensor(dd[np.ix_(order, order)],
                                       device=device), BLOCK)
    db, out["dir_banded_launches"] = launched(
        lambda: apsp_banded_fw(db, window=window, symmetric=False))
    check_launches(device, out["dir_banded_launches"], close_diag=nb,
                   relax_panel=2 * nb, relax_full_banded=nb)
    db = db[:n, :n].index_select(0, rank_dev).index_select(1, rank_dev)
    if not np.array_equal((db <= r).cpu().numpy(), want):
        raise AssertionError("directed banded indicator differs from "
                             "Dijkstra's")
    wrong = ops.apsp(dd_dev, symmetric=True)
    out["sym_wrong"] = int((wrong != dfw).sum())
    out["sym_shorter"] = int((wrong < dfw).sum())
    out["sym_wrong_within_r"] = int(((wrong <= r) != (dfw <= r)).sum())
    out["dir_asymmetric"] = int((dfw != dfw.T).sum())
    del wrong, dfw, db, dd_dev

    out["fw_s"] = best(lambda: ops.apsp(d0))
    out["sym_s"] = best(lambda: ops.apsp(d0, symmetric=True))
    out["sq_s"] = best(lambda: ops.apsp(d0, method="pallas_squaring"))
    out["banded_s"] = best(lambda: apsp_banded_fw(init.clone(), window=window,
                                                  symmetric=False))
    out["banded_sym_s"] = best(lambda: apsp_banded_fw(init.clone(),
                                                      window=window))

    # the flagship step (__graft_entry__.py:43-51) at this width
    vals_t = torch.as_tensor(vals, dtype=torch.float32, device=device)
    valid = torch.as_tensor(np.flatnonzero(np.isfinite(vals).any(axis=1)),
                            device=device)
    batch = default_batch_size(int(valid.numel()), vals.shape[1],
                               num_permutations)

    def step():
        dist = ops.apsp(d0)
        nbr = (dist <= r).to(torch.float32)
        obs = ops.compute_neighborhood_score(nbr, vals_t, "sum")
        nbr_valid, v, m = prepare_valid(nbr, vals_t, valid)
        gen = torch.Generator(device=device).manual_seed(SEED_NULL)
        cn, cp = scan_counts(nbr_valid, v, m, obs, score_type="sum",
                             num_permutations=num_permutations,
                             batch_size=batch, generator=gen)
        return nbr, obs, cn, cp

    (nbr, obs, cn, cp), out["step_launches"] = launched(step)
    check_launches(device, out["step_launches"], close_diag=nb,
                   relax_panel=2 * nb, relax_full=nb)
    if not np.array_equal(nbr.cpu().numpy().astype(bool), oracle):
        raise AssertionError("flagship neighborhoods differ from Dijkstra's")
    if tuple(obs.shape) != vals.shape or not torch.isfinite(obs).all():
        raise AssertionError(f"flagship scores must be finite, {vals.shape}")
    if not ((cn + cp) >= num_permutations).all():
        raise AssertionError("flagship counts_neg + counts_pos < P")
    out["step_s"] = best(step)
    out["step_rows"] = int(valid.numel())
    return out


def reset_launches():
    """Zero the launch counts of every hand-written kernel: the FW's
    (``ops.apsp_cuda``) and the class table's (``ops.hypergeom_table``)."""
    K.reset_launches()
    htab.reset_launches()


def launch_counts() -> dict:
    """Every hand-written kernel's launches since :func:`reset_launches`."""
    return dict(K.LAUNCHES, **htab.LAUNCHES)


def check_launches(device, launches, engine=None, **counts):
    """On the card, raise unless each FW kernel launched ``counts[name]``
    times and every other FW kernel not at all; with the hypergeometric
    ``engine`` that ran, also unless the class table's kernel launched
    where the engine builds class tables (``table-*``) and only there (on
    the CPU nothing launches)."""
    if device.type != "cuda":
        return
    want = {name: 0 for name in K.LAUNCHES}
    want.update(counts)
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"kernel launches {got}, expected {want}")
    tables = launches.get("logsf_table", 0)
    if engine is not None and (tables > 0) != engine.startswith("table"):
        raise AssertionError(f"{tables} class-table kernel launches under "
                             f"the {engine} engine")


def dijkstra_indicator(coords, edges, lengths, radius):
    n = len(coords)
    a = coo_matrix((lengths, tuple(edges.T)), shape=(n, n))
    return shortest_path(a.maximum(a.T), method="D", directed=False) <= radius


def run_slice(device, net, vals, num_permutations=N_PERM, steady=3):
    """Phase 4 and 5: the main path through the facade, banded then dense."""
    def session(mode):
        sf = SAFE(device=device, verbose=False)
        sf.apsp_mode = mode
        sf.random_seed = SEED_NULL
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        return sf

    def timed_run(sf):
        sync(device)
        t0 = time.perf_counter()
        sf.run_pipeline(num_permutations=num_permutations)
        sync(device)
        return time.perf_counter() - t0

    coords, edges, lengths, _ = net
    n = len(coords)
    nb = -(-n // BLOCK)  # FW rounds
    sf = session("auto")
    reset_launches()
    warm_s = timed_run(sf)
    launches = launch_counts()
    if sf.apsp_engine_used != "banded-window":
        raise AssertionError(f"banded plan not taken: {sf.apsp_engine_used}")
    check_launches(device, launches, close_diag=nb, relax_panel=2 * nb,
                   relax_window_sym=nb)
    steady_s = [timed_run(sf) for _ in range(steady)]

    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    r = float(inclusive_radius(nr))
    nbr = sf.neighborhoods
    oracle = dijkstra_indicator(coords, edges, lengths, r)
    if not np.array_equal(nbr.astype(bool), oracle):
        raise AssertionError(f"indicator differs from scipy Dijkstra at "
                             f"{int((nbr.astype(bool) != oracle).sum())} pairs")
    finite = np.isfinite(sf.ns)
    both = sf.counts_neg + sf.counts_pos
    if not (both[finite] >= sf.num_permutations).all():
        raise AssertionError("counts_neg + counts_pos < P where ns is finite")
    if sf.ns.shape != vals.shape or not finite.all() or not np.isfinite(
            sf.nes).all():
        raise AssertionError("sum scores and NES must be finite, of shape "
                             f"{vals.shape}")

    phases = phase_times(sf, device, num_permutations)

    full = session("full")
    reset_launches()
    full_s = timed_run(full)
    dense_launches = launch_counts()
    if full.apsp_engine_used != "dense":
        raise AssertionError(f"dense plan not taken: {full.apsp_engine_used}")
    if not np.array_equal(full.neighborhoods, nbr):
        raise AssertionError("dense and banded neighborhoods differ")

    # the band-storage engine on the same network and seed
    band = session("band")
    reset_launches()
    band_s = timed_run(band)
    band_launches = launch_counts()
    if band.apsp_engine_used != "band-storage":
        raise AssertionError(f"band storage not taken: {band.apsp_engine_used}")
    if device.type == "cuda" and band_launches["relax_skew_sym"] != nb:
        raise AssertionError(f"band launches {band_launches}")
    if not np.array_equal(band.neighborhoods, nbr):
        raise AssertionError("band-storage and banded neighborhoods differ")
    if not np.allclose(band.ns, sf.ns, rtol=1e-5, atol=1e-5):
        raise AssertionError("band-storage scores differ from banded beyond "
                             "1e-5")
    delta = int(np.abs(band.counts_neg - sf.counts_neg).sum()
                + np.abs(band.counts_pos - sf.counts_pos).sum())
    if delta > 1e-5 * sf.ns.size * num_permutations:
        raise AssertionError(f"band-storage counts differ by {delta}")
    band_steady_s = min(timed_run(band) for _ in range(steady))

    return dict(
        launches=launches, dense_launches=dense_launches,
        band_run_s=band_s, band_steady_s=band_steady_s,
        band_launches=band_launches, band_count_delta=delta,
        window=sf.window_used, warm_s=warm_s, steady_s=steady_s,
        steady_min_s=min(steady_s), dense_run_s=full_s, **phases,
        mean_neighborhood=float(nbr.sum(axis=1).mean()),
        enriched=int(sf.nes_binary.sum()), session=sf)


def phase_times(sf, device, num_permutations, reps=3):
    """Min-of-reps host seconds of the APSP phase (banded FW + un-permute +
    mask) and of the null phase (scan_counts) at the run's own inputs."""
    coords, edges, lengths, _ = sf._graph_arrays
    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    init, inv_rank, window = sf._banded_plan(coords, edges, lengths,
                                             len(coords), nr)
    radius = inclusive_radius(nr)
    n2a = sf._node2attribute_device()
    valid = torch.as_tensor(np.flatnonzero(~np.isnan(sf.node2attribute).all(1)),
                            device=device)
    nbr_valid, v, m = prepare_valid(sf._neighborhoods_dev, n2a, valid)
    obs = torch.as_tensor(sf.ns, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED_NULL)

    def best(fn):
        out = []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            out.append(time.perf_counter() - t0)
        return min(out)

    return dict(
        apsp_s=best(lambda: apsp_banded_unpermuted(init, inv_rank, radius,
                                                   window=window)),
        null_s=best(lambda: scan_counts(nbr_valid, v, m, obs,
                                        score_type="sum",
                                        num_permutations=num_permutations,
                                        batch_size=num_permutations,
                                        generator=gen)),
        valid_rows=int(valid.numel()))


def run_band_slice(device, num_permutations=N_PERM, steady=3):
    """Phase 6: the band-storage path at 49,920 nodes through the facade."""
    net = build_network(n=BAND_NODES, k=BAND_KNN, edge_budget=None)
    coords, edges, lengths, _ = net
    n = len(coords)
    sf = SAFE(device=device, verbose=False)
    sf.keep_node_distances = False
    sf.random_seed = SEED_NULL
    sf.neighborhood_radius = float(np.sqrt(125.0 / (np.pi * n)))
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=build_band_attribute(n))

    def timed_run():
        sync(device)
        t0 = time.perf_counter()
        sf.run_pipeline(num_permutations=num_permutations)
        sync(device)
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    warm_s = timed_run()
    launches = launch_counts()
    if sf.apsp_engine_used != "band-storage":
        raise AssertionError(f"band storage not taken: {sf.apsp_engine_used}")
    nb = -(-n // BLOCK)
    check_launches(device, launches, close_diag=nb, relax_panel=nb,
                   relax_skew_sym=nb)
    steady_s = [timed_run() for _ in range(steady)]
    peak_bytes = torch.cuda.max_memory_allocated(device)
    if sf.node_distances is not None:
        raise AssertionError("keep_node_distances=False kept the distances")

    # indicator rows of seeded sources against scipy Dijkstra (no dense
    # oracle fits at this size)
    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    r = float(inclusive_radius(nr))
    a = coo_matrix((lengths, tuple(edges.T)), shape=(n, n)).tocsr()
    src = np.random.default_rng(SEED_SOURCES).choice(n, N_SOURCES,
                                                     replace=False)
    d = dijkstra(a.maximum(a.T), directed=False, indices=src, limit=r)
    nbr = sf.neighborhoods_sparse()
    got = nbr[src].toarray() != 0
    if not np.array_equal(got, d <= r):
        raise AssertionError(f"indicator rows differ from scipy Dijkstra at "
                             f"{int((got != (d <= r)).sum())} pairs")
    finite = np.isfinite(sf.ns)
    both = sf.counts_neg + sf.counts_pos
    if not (both[finite] >= num_permutations).all():
        raise AssertionError("counts_neg + counts_pos < P where ns is finite")
    if sf.ns.shape != (n, 1) or not finite.all():
        raise AssertionError(f"sum scores must be finite, of shape {(n, 1)}")

    band_m = sf._neighborhoods_dev
    out = dict(launches=launches, warm_s=warm_s, steady_s=steady_s,
               steady_min_s=min(steady_s), peak_gb=peak_bytes / 1e9,
               band=band_m.band, bt=band_m.bt,
               width=(2 * band_m.bt + 1) * BLOCK,
               mean_neighborhood=float(nbr.sum() / n),
               enriched=int(sf.nes_binary.sum()), nodes=n,
               edges=len(edges), session=sf)
    out.update(band_phase_times(sf, device, num_permutations))

    # the non-symmetric band FW on the same initial band: same indicator
    plan = next(p for p in sf._bandstore_cache.values() if p is not None)
    s = bst.band_init_from_edges(plan["u"], plan["v"], plan["w"], n=n,
                                 band=plan["band"])
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    bst.apsp_band_fw(s, bt=band_m.bt, symmetric=False)
    sync(device)
    out["classic_fw_s"] = time.perf_counter() - t0
    out["classic_launches"] = launch_counts()
    if (device.type == "cuda"
            and out["classic_launches"]["relax_skew"] != nb):
        raise AssertionError(f"relax_skew launches {out['classic_launches']}")
    if not torch.equal(bst.band_threshold(s, inclusive_radius(nr)),
                       band_m.data):
        raise AssertionError("classic and symmetric band FW indicators differ")
    return out


def band_phase_times(sf, device, num_permutations, reps=3):
    """Min-of-reps host seconds of the band FW front (init, FW, threshold,
    stats) and of the null tail (scores, compaction, counts, un-permute) at
    the run's own inputs, as ``SAFE._run_pipeline_band_null`` feeds them."""
    coords, edges, lengths, _ = sf._graph_arrays
    n = len(coords)
    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    plan = sf._band_storage_plan(coords, edges, lengths, n, nr)
    radius = inclusive_radius(nr)
    band = plan["band"]
    bt = band // BLOCK + 1
    vals_perm = np.asarray(sf.node2attribute, np.float32)[
        np.argsort(plan["rank"])]
    valid_perm = np.isfinite(vals_perm).any(axis=1)
    starts, w_c = bst.compaction_plan(valid_perm, n=n, bt=bt)
    V, A = int(valid_perm.sum()), vals_perm.shape[1]
    tail_args = [torch.as_tensor(x, device=device) for x in (
        vals_perm, vals_perm[valid_perm], valid_perm, starts)]

    def front():
        return pipe.band_neighborhoods(plan["u"], plan["v"], plan["w"],
                                       radius, n=n, band=band,
                                       keep_distances=False)

    def tail():
        gen = torch.Generator(device=device).manual_seed(SEED_NULL)
        return pipe._band_perm_tail(
            s_ind, *tail_args, plan["rank_dev"], gen, bt=bt, block=BLOCK,
            score_type="sum", num_permutations=num_permutations,
            batch_size=default_batch_size(V, A, num_permutations), w_c=w_c,
            precision="highest")

    def best(fn):
        out = []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            out.append(time.perf_counter() - t0)
        return min(out)

    s_ind = front()[1]
    return dict(front_s=best(front), tail_s=best(tail), w_c=w_c,
                valid_rows=V)


def _band_session(device, ref, mesh=None):
    """A session with the settings, network and attribute of ``ref`` (the
    phase-6 session), on ``mesh`` when given."""
    sf = SAFE(device=device, verbose=False)
    for name in ("apsp_mode", "keep_node_distances", "random_seed",
                 "neighborhood_radius"):
        setattr(sf, name, getattr(ref, name))
    sf.mesh = mesh
    sf.load_network(network_file=ref._graph_arrays)
    sf.load_attributes(attribute_file=ref.node2attribute)
    return sf


def _ghosted_init(sf, world):
    """The initial band of ``sf``'s band plan in the sharded global frame
    (g_pad block-rows for ``world`` ranks; the pad rows +inf)."""
    coords, edges, lengths, _ = sf._graph_arrays
    n = len(coords)
    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    plan = sf._band_storage_plan(coords, edges, lengths, n, nr)
    s = bst.band_init_from_edges(plan["u"], plan["v"], plan["w"], n=n,
                                 band=plan["band"])
    *_, g_pad, _ = bsh.sharded_band_geometry(n, plan["band"], world)
    out = torch.full((g_pad * BLOCK, s.shape[1]), float("inf"),
                     device=s.device)
    out[:s.shape[0]] = s
    return out, n, plan["band"], s.shape[0]


def band_digest(t) -> str:
    return hashlib.blake2b(t.cpu().numpy().tobytes(), digest_size=16).hexdigest()


def run_sharded_world1(device, ref, steady=3):
    """Phase 8, world 1: the phase-6 network and attribute through
    ``SAFE(mesh=<one-rank 'data' mesh over NCCL>).run_pipeline``, the
    row-sharded band engine. Checks the launches (each round: one
    ``close_diag``, one ``relax_panel``, one ``relax_band_row``), the
    indicator band bitwise and the counts exactly against phase 6's, the
    scores within 1e-5; times the warm and steady runs and the sharded FW
    alone, reports the peak memory and profiles one steady run."""
    rdv = native.BUILD_DIR / "chip_smoke_world1_rendezvous"
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh({"data": 1}, device_type=device.type)
        return _sharded_world1(device, ref, mesh, steady)
    finally:
        dist.destroy_process_group()


def _sharded_world1(device, ref, mesh, steady):
    sf = _band_session(device, ref, mesh)

    def timed_run():
        sync(device)
        t0 = time.perf_counter()
        sf.run_pipeline(num_permutations=N_PERM)
        sync(device)
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    warm_s = timed_run()
    launches = launch_counts()
    if (sf.apsp_engine_used, sf._band_relax_used) != ("band-storage", "fw"):
        raise AssertionError(f"sharded band engine not taken: "
                             f"{sf.apsp_engine_used}, {sf._band_relax_used}")
    band_m = sf._neighborhoods_dev
    nb, bt = -(-band_m.n // BLOCK), band_m.bt
    check_launches(device, launches, close_diag=nb, relax_panel=nb,
                   relax_band_row=nb)  # one launch for a round's rows
    steady_s = [timed_run() for _ in range(steady)]
    peak_bytes = torch.cuda.max_memory_allocated(device)
    if not torch.equal(band_m.data.cpu(), ref._neighborhoods_dev.data.cpu()):
        raise AssertionError("sharded indicator band differs from phase 6's")
    if not np.allclose(sf.ns, ref.ns, rtol=1e-5, atol=1e-5):
        raise AssertionError("sharded scores differ from phase 6's beyond "
                             "1e-5")
    if not (np.array_equal(sf.counts_neg, ref.counts_neg)
            and np.array_equal(sf.counts_pos, ref.counts_pos)):
        raise AssertionError("sharded counts differ from phase 6's")

    s0, n, band, rows = _ghosted_init(sf, 1)
    fw_s = []
    for _ in range(steady):
        s = s0.clone()
        sync(device)
        t0 = time.perf_counter()
        bsh.apsp_band_fw_sharded(s, mesh=mesh, n=n, band=band)
        sync(device)
        fw_s.append(time.perf_counter() - t0)
    out = dict(launches=launches, warm_s=warm_s, steady_s=steady_s,
               steady_min_s=min(steady_s), peak_gb=peak_bytes / 1e9,
               fw_s=min(fw_s), fw_band=band_digest(s[:rows]),
               ind_digest=band_digest(band_m.data), bt=bt, nb=nb,
               ns=sf.ns, counts_neg=sf.counts_neg,
               counts_pos=sf.counts_pos)
    out["profile"] = profile_steady(sf)
    return out


def _gloo_rank(rank, world, case_dir, device_type):
    """One rank of phase 8's world 2: gloo over CUDA tensors, every rank on
    card 0. The sharded FW on the phase-6 initial band, then the facade run;
    the results go to ``case_dir``."""
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"file://{case_dir}/rendezvous", rank=rank,
        world_size=world)
    try:
        mesh = make_mesh({"data": world}, device_type=device.type)
        d = np.load(os.path.join(case_dir, "inputs.npz"))
        ref = SimpleNamespace(
            apsp_mode=str(d["apsp_mode"]), keep_node_distances=False,
            random_seed=SEED_NULL, neighborhood_radius=float(d["radius"]),
            _graph_arrays=tuple(d[k] for k in ("coords", "edges", "lengths",
                                               "weights")),
            node2attribute=d["vals"])
        sf = _band_session(device, ref, mesh)
        s, n, band, rows = _ghosted_init(sf, world)
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        bsh.apsp_band_fw_sharded(s, mesh=mesh, n=n, band=band)
        sync(device)
        fw_s = time.perf_counter() - t0
        fw_launches = launch_counts()
        fw_band = band_digest(s[:rows])
        del s
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        sf.run_pipeline(num_permutations=int(d["num_permutations"]))
        sync(device)
        run_s = time.perf_counter() - t0
        np.savez(os.path.join(case_dir, f"rank{rank}.npz"), fw_s=fw_s,
                 fw_band=fw_band, run_s=run_s,
                 ind_digest=band_digest(sf._neighborhoods_dev.data),
                 ns=sf.ns, counts_neg=sf.counts_neg,
                 counts_pos=sf.counts_pos,
                 fw_launches=json.dumps(fw_launches),
                 run_launches=json.dumps(launch_counts()))
    finally:
        dist.destroy_process_group()


def window_cuts(nb, bt, world):
    """Per rank, {(o_lo, o_hi): rounds}: the window rows each of its
    ``relax_band_rows`` launches relaxes over the FW rounds
    (``band_sharded._band_fw_rounds``), for ``world`` equal row slabs of
    the ghosted band (``band_sharded.sharded_band_geometry``)."""
    local_rows = -(-(nb + 2 * bt) // world)
    cuts = [{} for _ in range(world)]
    for kb in range(nb):
        for my in range(world):
            o_lo = max(my * local_rows - kb, 0)
            o_hi = min((my + 1) * local_rows - kb, 2 * bt + 1)
            if o_lo < o_hi:
                cuts[my][(o_lo, o_hi)] = cuts[my].get((o_lo, o_hi), 0) + 1
    return cuts


def window_rounds(nb, bt, world):
    """Per rank, the FW rounds in which it holds a row of the pivot window
    (one ``relax_band_rows`` launch each)."""
    return [sum(c.values()) for c in window_cuts(nb, bt, world)]


def run_sharded_world2(device, ref, w1, world=2):
    """Phase 8, world 2: two processes on the one card, gloo over CUDA
    tensors (NCCL refuses two ranks on one GPU), through
    ``torch.multiprocessing.spawn``; a rank's exception makes ``spawn``
    raise. Each rank runs the sharded FW on the phase-6 initial band and
    then the facade run; the assembled band and indicator must equal world
    1's bitwise, the scores within 1e-5, the counts within near-tie flips
    (the rows are contracted in other groups)."""
    case_dir = native.BUILD_DIR / "chip_smoke_gloo"
    shutil.rmtree(case_dir, ignore_errors=True)
    case_dir.mkdir(parents=True)
    coords, edges, lengths, weights = ref._graph_arrays
    np.savez(case_dir / "inputs.npz", coords=coords, edges=edges,
             lengths=lengths, weights=weights, vals=ref.node2attribute,
             radius=ref.neighborhood_radius, apsp_mode=ref.apsp_mode,
             num_permutations=ref.num_permutations)
    t0 = time.perf_counter()
    mp.spawn(_gloo_rank, args=(world, str(case_dir), device.type),
             nprocs=world, join=True)
    wall_s = time.perf_counter() - t0
    ranks = [dict(np.load(case_dir / f"rank{r}.npz")) for r in range(world)]
    nb, bt = w1["nb"], w1["bt"]
    fw_launches = [json.loads(str(r["fw_launches"])) for r in ranks]
    run_launches = [json.loads(str(r["run_launches"])) for r in ranks]
    for launches in (fw_launches, run_launches):
        total = {k: sum(x[k] for x in launches) for k in launches[0]}
        if device.type == "cuda" and (total["close_diag"] != world * nb
                or total["relax_panel"] != world * nb
                or [x["relax_band_row"] for x in launches]
                != window_rounds(nb, bt, world)):
            raise AssertionError(f"world-{world} launches {launches}")
    delta = 0
    for r in ranks:
        if str(r["fw_band"]) != w1["fw_band"]:
            raise AssertionError(f"world-{world} FW band differs from world "
                                 "1's")
        if str(r["ind_digest"]) != w1["ind_digest"]:
            raise AssertionError(f"world-{world} indicator differs from "
                                 "world 1's")
        if not np.allclose(r["ns"], w1["ns"], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"world-{world} scores differ beyond 1e-5")
        delta = max(delta, int(np.abs(r["counts_neg"] - w1["counts_neg"]).sum()
                               + np.abs(r["counts_pos"] - w1["counts_pos"])
                               .sum()))
    if delta > 1e-5 * w1["ns"].size * ref.num_permutations:
        raise AssertionError(f"world-{world} counts differ by {delta}")
    if any(not np.array_equal(r["counts_neg"], ranks[0]["counts_neg"])
           for r in ranks):
        raise AssertionError("the ranks' counts differ")
    return dict(wall_s=wall_s, fw_s=[float(r["fw_s"]) for r in ranks],
                run_s=[float(r["run_s"]) for r in ranks],
                fw_launches=fw_launches, run_launches=run_launches,
                count_delta=delta)


def build_go_matrix(coords, sizes, seed, nan_share=GO_NAN_SHARE):
    """A binary (N, len(sizes)) GO-like annotation matrix: term j has
    ``sizes[j]`` members, drawn among the 2 sizes[j] annotated nodes
    nearest a random centre (members near centres, as
    examples/example_2_go_annotations.py:17-24 draws them, so that domains
    of enrichment exist); the rows of unannotated genes are NaN."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    nan_rows = rng.random(n) < nan_share
    ann = np.flatnonzero(~nan_rows)
    tree = cKDTree(coords[ann])
    out = np.zeros((n, len(sizes)))
    for j, s in enumerate(sizes):
        _, near = tree.query(rng.uniform(-0.8, 0.8, 2),
                             k=min(2 * int(s), len(ann)))
        out[ann[rng.choice(near, int(s), replace=False)], j] = 1.0
    out[nan_rows] = np.nan
    return out


def go_matrices(coords, attrs=GO_ATTRS):
    """Phase 10's two matrices. A: term sizes log-uniform on 3-300 (the
    class table would be 4,096 x 512 x 512 cells, over the 3e8 budget, so
    'auto' takes the f64 tail loop); B: at most 64 distinct sizes of at most
    120 (4,096 x 128 x 64 = 33.5 M cells: the class table)."""
    rng = np.random.default_rng(SEED_GO_A)
    sizes_a = np.rint(np.exp(rng.uniform(np.log(3), np.log(300), attrs)))
    rng = np.random.default_rng(SEED_GO_B)
    sizes_b = rng.choice(np.unique(np.rint(np.geomspace(3, 120, 64))), attrs)
    return (build_go_matrix(coords, sizes_a, SEED_GO_A),
            build_go_matrix(coords, sizes_b, SEED_GO_B))


def f32_ulps(got, want) -> float:
    """Largest |got - want| in f32 ulps of ``want`` (equal values,
    infinities and NaNs included, count 0)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(np.where(same, 0.0, diff / np.spacing(np.abs(want))).max())


def sampled_scipy_err(sf, samples=GO_SAMPLES, seed=SEED_GO_SAMPLES):
    """Largest |p - scipy.stats.hypergeom.sf(k - 1, M, K, n)| over
    ``samples`` random cells of a binary run, the census (k, n) of each cell
    summed on the device from the run's own indicator (exact f32
    integers)."""
    n2a = sf.node2attribute
    n, a = n2a.shape
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, samples), rng.integers(0, a, samples)
    finite = np.isfinite(n2a)
    nan0 = np.where(finite, n2a, 0.0)
    dev = sf.device
    nbr = sf._neighborhoods_dev[torch.as_tensor(rows, device=dev)]
    cells = torch.as_tensor(nan0[:, cols].T, dtype=torch.float32, device=dev)
    k = (nbr * cells).sum(dim=1).cpu().numpy()
    size = (nbr @ torch.as_tensor(finite.any(axis=1), dtype=torch.float32,
                                  device=dev)).cpu().numpy()
    want = hypergeom.sf(k - 1, int(finite.any(axis=1).sum()),
                        nan0.sum(axis=0)[cols], size)
    return float(np.abs(sf.pvalues_pos[rows, cols] - want).max())


def run_go_path(device, net, steady=3, fdr_rows=512):
    """Phase 10: the binary GO path at the Example_1 network (banded
    window): the fused binary ``run_pipeline`` on matrix A (loop engine) and
    B (class table), B again on the loop engine, the stages on A, FDR on A;
    the checks of the module doc; walls, parts, peak memory, a profile of
    one steady run of each engine."""
    t_phase = time.perf_counter()
    mat_a, mat_b = go_matrices(net[0])
    nb = -(-len(net[0]) // BLOCK)
    out = {}

    def session(vals, **settings):
        sf = SAFE(device=device, verbose=False)
        for k, v in settings.items():
            setattr(sf, k, v)
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        return sf

    def timed(sf):
        sync(device)
        t0 = time.perf_counter()
        sf.run_pipeline()
        sync(device)
        return time.perf_counter() - t0

    def best(fn):
        times = []
        for _ in range(steady):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    def fused(name, vals, engine):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sf = session(vals)
        reset_launches()
        warm = timed(sf)
        launches = launch_counts()
        if sf._hypergeom_engine_used != engine:
            raise AssertionError(f"matrix {name}: {sf._hypergeom_engine_used}"
                                 f" taken, {engine} expected")
        check_launches(device, launches, engine, close_diag=nb,
                       relax_panel=2 * nb, relax_window_sym=nb)
        walls = [timed(sf) for _ in range(steady)]
        peak = (torch.cuda.max_memory_allocated(device) / 1e9
                if device.type == "cuda" else None)
        p = sf.pvalues_pos
        if (p.shape != vals.shape or not np.isfinite(p).all()
                or sf.nes_binary.shape != vals.shape):
            raise AssertionError(f"matrix {name}: p-values must be finite, "
                                 f"of shape {vals.shape}")
        err = sampled_scipy_err(sf)
        if err > 1e-6:
            raise AssertionError(f"matrix {name}: p differs from scipy by "
                                 f"{err} on sampled cells")
        out[name] = dict(engine=engine, launches=launches, warm_s=warm,
                         steady_s=walls, steady_min_s=min(walls),
                         peak_gb=peak, scipy_err=err,
                         enriched=int(sf.nes_binary.sum()),
                         attributes_enriched=int(
                             (sf.attributes["num_neighborhoods_enriched"] > 0)
                             .sum()))
        return sf

    a = fused("A", mat_a, "loop-dense-fused")
    b = fused("B", mat_b, "table-dense-fused")

    # B on the loop engine: the same indicator and counts as the table's
    b_loop = session(mat_b, hypergeom_engine="loop")
    timed(b_loop)
    if b_loop._hypergeom_engine_used != "loop-dense-fused":
        raise AssertionError("hypergeom_engine='loop' not taken")
    if not (np.array_equal(b_loop.nes_binary, b.nes_binary)
            and np.array_equal(b_loop.attributes["num_neighborhoods_enriched"],
                               b.attributes["num_neighborhoods_enriched"])):
        raise AssertionError("matrix B: loop and table indicators differ")
    out["B_loop_vs_table_p"] = float(np.abs(b_loop.pvalues_pos
                                            - b.pvalues_pos).max())
    if out["B_loop_vs_table_p"] > 1e-6:
        raise AssertionError(f"matrix B: loop and table p-values differ by "
                             f"{out['B_loop_vs_table_p']}")
    del b_loop

    # the stages on A: the fused run's neighborhoods and indicator
    staged = session(mat_a)
    sync(device)
    t0 = time.perf_counter()
    staged.define_neighborhoods()
    staged.compute_pvalues()
    sync(device)
    out["staged_s"] = time.perf_counter() - t0
    if staged._hypergeom_engine_used != "loop-dense-staged":
        raise AssertionError(f"staged engine {staged._hypergeom_engine_used}")
    if not (np.array_equal(staged.neighborhoods, a.neighborhoods)
            and np.array_equal(staged.nes_binary, a.nes_binary)):
        raise AssertionError("staged and fused neighborhoods or indicators "
                             "differ")
    out["staged_vs_fused_p"] = float(np.abs(staged.pvalues_pos
                                            - a.pvalues_pos).max())
    if out["staged_vs_fused_p"] > 1e-6:
        raise AssertionError(f"staged and fused p-values differ by "
                             f"{out['staged_vs_fused_p']}")
    del staged

    # FDR on A: the host log-space BH of the unadjusted log-survival, on
    # sampled rows (BH adjusts each row alone)
    fsf = session(mat_a, multiple_testing=True)
    out["fdr_run_s"] = timed(fsf)
    rows = torch.as_tensor(np.random.default_rng(SEED_GO_SAMPLES).choice(
        len(net[0]), fdr_rows, replace=False), device=device)
    adj, nbin, _ = fdr_bh_logsf_np(a._logsf_dev[rows].cpu().numpy(),
                                   np.log(0.05))
    out["fdr_ulps"] = f32_ulps(fsf._logsf_dev[rows].cpu().numpy(), adj)
    if out["fdr_ulps"] > 1 or not np.array_equal(
            fsf._nes_binary_dev[rows].cpu().numpy(), nbin):
        raise AssertionError(f"FDR differs from fdr_bh_logsf_np: "
                             f"{out['fdr_ulps']} ulps or the indicator")
    out["fdr_enriched"] = int(fsf.nes_binary.sum())
    del fsf

    # the parts alone at A's (and B's) own inputs
    n2a = a._node2attribute_device()
    finite = torch.isfinite(n2a)
    nan0 = torch.where(finite, n2a, torch.zeros_like(n2a))
    nnn = finite.any(dim=1).to(torch.float32)
    nbr = a._neighborhoods_dev
    M = int(nnn.sum())
    # the facade's host passes over the (N, A) f64 matrix each binary run
    # (M and the term totals, safe.py:1729-1731)
    out["host_prep_s"] = best(lambda: (
        np.any(~np.isnan(mat_a), axis=1).sum(),
        np.nansum(mat_a, axis=0, dtype=np.float64)))
    out["census_s"] = best(lambda: (nbr @ nnn, nbr @ nan0))
    counts, nsize = nbr @ nan0, nbr @ nnn
    shape = counts.shape
    k_max = int(np.nanmax(np.nansum(mat_a, axis=0)))
    iters = tail_iterations(M, min(k_max, M))
    lgt = torch.as_tensor(lgamma_table(M), device=device)
    out["tail_iterations"] = iters
    out["tail_s"] = best(lambda: finalize_logsf_device(_sf_parts(
        counts.double(), M, nan0.sum(dim=0).double()[None].expand(shape),
        nsize.double()[:, None].expand(shape), lgt, iters), 0.05))
    kw = b._dense_table_kwargs(np.nansum(mat_b, axis=0), M, 0)
    r, s_max, c = out["table_spec"] = kw["table_spec"]
    log_thr = float(np.log(0.05))
    b_nbr = b._neighborhoods_dev
    b_n2a = b._node2attribute_device()
    b_counts = b_nbr @ torch.where(torch.isfinite(b_n2a), b_n2a,
                                   torch.zeros_like(b_n2a))
    out["table_build_s"] = best(lambda: build_logsf_table(
        kw["table_K_dist"], M, log_thr, R=r, S_max=s_max, C=c))
    table = build_logsf_table(kw["table_K_dist"], M, log_thr, R=r,
                              S_max=s_max, C=c)
    out["table_lookup_s"] = best(lambda: table_lookup(
        table, b_counts, b_nbr @ nnn, kw["table_colc"],
        float(np.float32(log_thr)), S_max=s_max, R=r, C=c))
    logsf = a._logsf_dev
    out["fdr_s"] = best(lambda: fdr_bh_logsf(logsf, log_thr))
    del counts, nsize, table, b_counts
    if device.type == "cuda":
        out["A_profile"] = profile_steady(a)
        out["B_profile"] = profile_steady(b)
    out["A_session"] = a  # phase 11 runs the domain stage on it
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def go_term_names(a, seed=SEED_GO_NAMES):
    """GO-like names of ``a`` terms, stopwords included, for the labels."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(GO_WORDS, rng.integers(2, 6))) + f" {j}"
            for j in range(a)]


def run_domain_stage(device, sf, net, steady=3, samples=DOMAIN_SAMPLES):
    """Phase 11: the domain stage on a binary session's device indicator and
    NES; the checks, times and peak memory of the module doc."""
    t_phase = time.perf_counter()
    if sf._nes_binary_dev is None or sf._nes_device() is None:
        raise AssertionError("the session holds no device indicator and NES")
    sf.attributes["name"] = go_term_names(len(sf.attributes["name"]))
    out = {}
    calls = []
    gemm = dd.enrichment_intersections

    def counted(*args, **kwargs):
        calls.append(1)
        return gemm(*args, **kwargs)

    def fresh():
        """The state a new run leaves: no host indicator, CSC view or
        intersections yet."""
        sf._nes_binary_np = sf._nes_binary_i8_np = None
        sf._nes_binary_csc = sf._domains_inter_cache = None

    def best(fn, before=None):
        times = []
        for _ in range(steady):
            if before is not None:
                before()
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    def stage():
        sf.define_top_attributes()
        sf.define_domains()
        sf.trim_domains()

    dd.enrichment_intersections = counted
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        base = (torch.cuda.memory_allocated(device) / 1e9
                if device.type == "cuda" else None)
        out["stage_s"] = best(stage, fresh)
        out["peak_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                          if device.type == "cuda" else None)
        out["base_gb"] = base
        out["top_s"] = best(sf.define_top_attributes, fresh)
        if device.type == "cuda":
            fresh()
            out["profile"] = profile_steady(sf, run=stage)

        # the checks, on one fresh stage
        fresh()
        calls.clear()
        sf.define_top_attributes()
        top = np.asarray(sf.attributes["top"])
        out["top"] = int(top.sum())
        if not domains_mod.uses_gemm(sf.cluster_engine,
                                     sf.attribute_distance_metric,
                                     out["top"]):
            raise AssertionError(f"{out['top']} top terms: 'auto' does not "
                                 "take the GEMM engine")
        sf.define_domains()
        inter = sf._domains_inter_cache
        if len(calls) != 1 or inter is None:
            raise AssertionError(f"{len(calls)} intersection GEMMs, cache "
                                 f"{type(inter).__name__}")
        b = sf._nes_binary_small()
        b64 = b.astype(np.float64)
        t0 = time.perf_counter()
        if not np.array_equal(inter, b64.T @ b64):
            raise AssertionError("the intersections differ from the host "
                                 "f64 product")
        out["host_product_s"] = time.perf_counter() - t0
        top_idx = np.flatnonzero(top)
        cols = np.sort(np.random.default_rng(SEED_GO_NAMES).choice(
            top_idx, min(samples, len(top_idx)), replace=False))
        if not np.array_equal(
                dd.jaccard_condensed_from_counts(inter[np.ix_(cols, cols)]),
                pdist(b64[:, cols].T, metric="jaccard")):
            raise AssertionError("the condensed jaccard differs from pdist")
        dom = np.asarray(sf.attributes["domain"])
        unique = np.unique(dom)
        nes32 = sf._nes_device().cpu().numpy()
        counts_h = np.stack([b[:, dom == d].sum(axis=1) for d in unique],
                            axis=1).astype(np.float64)
        with np.errstate(invalid="ignore"):
            max_h = np.stack(
                [np.nanmax(np.where(np.isnan(nes32[:, dom == d]), -np.inf,
                                    nes32[:, dom == d]),
                           axis=1, initial=-np.inf) for d in unique],
                axis=1).astype(np.float64)
        counts_d, max_d = dd.domain_aggregates(
            sf._nes_binary_dev, sf._nes_device(),
            np.searchsorted(unique, dom), len(unique))
        if not (np.array_equal(counts_d, counts_h)
                and np.array_equal(max_d, max_h)
                and np.array_equal(sf.node2domain.counts, counts_h)):
            raise AssertionError("the device aggregates differ from the "
                                 "host loop")
        csc = dd.indicator_csc(sf._nes_binary_dev,
                               sf.attributes["num_neighborhoods_enriched"])
        if not np.array_equal(csc.toarray(), b):
            raise AssertionError("indicator_csc differs from the indicator")
        out["domains_075"] = int((unique != 0).sum())
        sf.define_domains(attribute_distance_threshold=0.6)
        out["domains_060"] = int((np.unique(sf.attributes["domain"])
                                  != 0).sum())
        sf.define_domains(attribute_distance_threshold=0.75)
        if len(calls) != 1 or sf._domains_inter_cache is not inter:
            raise AssertionError("re-clustering ran another intersection "
                                 "GEMM")
        pre_attrs = dict(sf.attributes)
        pre_n2d = sf.node2domain
        sf.trim_domains()
    finally:
        dd.enrichment_intersections = gemm

    # the parts alone, at this run's inputs
    b_dev, nes_dev = sf._nes_binary_dev, sf._nes_device()
    out["gemm_s"] = best(lambda: dd.enrichment_intersections(b_dev))
    sub = inter[np.ix_(top_idx, top_idx)]
    out["condensed_s"] = best(lambda: dd.jaccard_condensed_from_counts(sub))
    condensed = dd.jaccard_condensed_from_counts(sub)

    def cluster():
        z = linkage(condensed, method="average")
        return fcluster(z, np.max(z[:, 2] * 0.75), criterion="distance")

    out["linkage_s"] = best(cluster)
    dom_pos = np.searchsorted(unique, dom)
    out["aggregates_s"] = best(lambda: dd.domain_aggregates(
        b_dev, nes_dev, dom_pos, len(unique)))
    out["trim_s"] = best(lambda: domains_mod.trim_domains(
        dict(pre_attrs), pre_n2d, min_size=sf.attribute_enrichment_min_size,
        verbose=False))

    # a CPU session handed the same indicator, NES and counts
    cpu = SAFE(device="cpu", verbose=False)
    cpu.load_network(network_file=net)
    cpu.load_attributes(attribute_file=np.zeros((len(b), b.shape[1])))
    cpu.attributes["name"] = list(sf.attributes["name"])
    cpu.nes_binary = sf.nes_binary
    cpu.nes = sf.nes
    cpu.attributes["num_neighborhoods_enriched"] = np.array(
        sf.attributes["num_neighborhoods_enriched"])
    cpu.define_top_attributes()
    cpu.define_domains()
    cpu.trim_domains()
    same = all(np.array_equal(sf.attributes[k], cpu.attributes[k])
               for k in ("top", "num_connected_components",
                         "num_large_connected_components", "domain"))
    same &= all(np.array_equal(getattr(sf.node2domain, k),
                               getattr(cpu.node2domain, k))
                for k in ("domains", "counts", "primary_domain",
                          "primary_nes"))
    same &= (np.array_equal(sf.domains["id"], cpu.domains["id"])
             and sf.domains["label"] == cpu.domains["label"])
    if not same:
        raise AssertionError("the CUDA domain stage differs from the CPU "
                             "session's")
    kept = np.asarray(sf.attributes["domain"])
    per_domain = np.bincount(kept[kept > 0])[1:]
    per_primary = np.bincount(sf.node2domain.primary_domain)[1:]
    out.update(domains_trimmed=len(sf.domains["id"]) - (0 in sf.domains["id"]),
               attrs_per_domain=(int(per_domain.min()), int(per_domain.max())),
               nodes_per_domain=(int(per_primary.min()),
                                 int(per_primary.max())),
               largest_label=sf.domains["label"][list(sf.domains["id"]).index(
                   int(np.argmax(np.bincount(kept)[1:])) + 1)],
               phase_s=time.perf_counter() - t_phase,
               session=sf)  # phase 15 saves it
    return out


def f32_ulps_dev(got, want) -> float:
    """Largest |got - want| in f32 ulps of ``want``, on the device (equal
    values count 0)."""
    w = want.to(torch.float32)
    ulp = (torch.nextafter(w.abs(), torch.tensor(float("inf"),
                                                 device=w.device))
           - w.abs()).double()
    diff = (got.double() - w.double()).abs()
    return float(torch.where(got == w, 0.0, diff / ulp).max())


LOGSF_ROW_STRIDE = 16  # phase 18 holds every 16th row of the loop's log sf


def logsf_rows(logsf) -> np.ndarray:
    """Every ``LOGSF_ROW_STRIDE``-th row of an (n, A) log sf, on the host:
    what phase 18 holds the sharded tail loop's log sf to."""
    return logsf[::LOGSF_ROW_STRIDE].cpu().numpy()


def f32_ulps_np(got, want) -> float:
    """Largest |got - want| in f32 ulps of ``want`` (equal values count
    0), on the host."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(np.where(same, 0.0, diff / np.spacing(np.abs(want))).max())


def band_census(sf, mat):
    """The census of a band session on the host: (counts (N, A), sizes
    (N,), K (A,), M) from a scipy.sparse product of ``neighborhoods_sparse``
    (original frame) with the annotation matrix."""
    n, a = mat.shape
    finite = np.isfinite(mat)
    r, c = np.nonzero(mat == 1.0)
    ann = csc_matrix((np.ones(len(r)), (r, c)), shape=(n, a))
    nbr = sf.neighborhoods_sparse()
    counts = (nbr @ ann).toarray()
    sizes = nbr @ finite.any(axis=1).astype(np.float64)
    return counts, sizes, np.asarray(ann.sum(axis=0)).ravel(), int(
        finite.any(axis=1).sum())


def band_device_census(sf, cols=512):
    """The census the band engines compute, (N, A) f32 in the original frame:
    banded products of the cached int8 operands, column chunk by chunk."""
    bm = sf._neighborhoods_dev
    nan0, _, _, ok, _ = sf._band_hyper_operands_cached(np.argsort(bm.rank))
    if not ok:
        raise AssertionError("the band operands are not binary")
    npad = bm.data.shape[0] - 2 * bm.bt * BLOCK
    rank = torch.as_tensor(bm.rank, device=bm.data.device)
    out = np.empty(tuple(nan0.shape), np.float32)
    for j in range(0, nan0.shape[1], cols):
        x = eb._pad_rows_to(nan0[:, j:j + cols].to(torch.float32), npad)
        out[:, j:j + cols] = bst.band_matmul(bm.data, x, bt=bm.bt)[
            rank].cpu().numpy()
    return out


def phase12_matrix(coords, attrs=GO_ATTRS):
    """Phase 12's binary matrix: ``attrs`` terms of matrix A's size law
    (log-uniform on 3-300) from ``SEED_BAND_GO``."""
    rng = np.random.default_rng(SEED_BAND_GO)
    sizes = np.rint(np.exp(rng.uniform(np.log(3), np.log(300), attrs)))
    return build_go_matrix(coords, sizes, SEED_BAND_GO)


def run_band_go(device, ref, attrs=GO_ATTRS, steady=3, fdr_rows=512,
                samples=GO_SAMPLES):
    """Phase 12: the band GO path on phase 6's network (session ``ref``) with
    a binary matrix of ``attrs`` terms (matrix A's size law); the checks,
    walls, parts, peak memory and profiles of the module doc."""
    t_phase = time.perf_counter()
    net = ref._graph_arrays
    coords = net[0]
    n = len(coords)
    nb = -(-n // BLOCK)
    t0 = time.perf_counter()
    mat = phase12_matrix(coords, attrs)
    out = dict(nodes=n, attrs=attrs, matrix_s=time.perf_counter() - t0)
    cuda = device.type == "cuda"

    def session(**settings):
        sf = SAFE(device=device, verbose=False)
        for k in ("apsp_mode", "keep_node_distances", "neighborhood_radius"):
            setattr(sf, k, getattr(ref, k))
        for k, v in settings.items():
            setattr(sf, k, v)
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=mat)
        return sf

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return time.perf_counter() - t0

    def best(fn, reps=steady):
        return min(timed(fn) for _ in range(reps))

    def fused(engine, **settings):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        sf = session(**settings)
        reset_launches()
        warm = timed(sf.run_pipeline)
        launches = launch_counts()
        if sf._hypergeom_engine_used != engine:
            raise AssertionError(f"{sf._hypergeom_engine_used} taken, "
                                 f"{engine} expected")
        check_launches(device, launches, engine, close_diag=nb,
                       relax_panel=nb, relax_skew_sym=nb)
        walls = [timed(sf.run_pipeline) for _ in range(steady)]
        return sf, dict(engine=engine, launches=launches, warm_s=warm,
                        steady_s=walls, steady_min_s=min(walls),
                        peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                                 if cuda else None))

    table, out["table"] = fused("table-band")
    bm = table._neighborhoods_dev
    if not torch.equal(bm.data, ref._neighborhoods_dev.data):
        raise AssertionError("the indicator band differs from phase 6's")
    counts_np = np.asarray(table.attributes["num_neighborhoods_enriched"])

    # the census against a host scipy.sparse product; sampled cells against
    # scipy's hypergeom.sf
    t0 = time.perf_counter()
    host, nsize, K_host, M = band_census(table, mat)
    out["host_census_s"] = time.perf_counter() - t0
    if not np.array_equal(band_device_census(table), host):
        raise AssertionError("the band census differs from the host "
                             "scipy.sparse product")
    rng = np.random.default_rng(SEED_GO_SAMPLES)
    rows, cols = rng.integers(0, n, samples), rng.integers(0, attrs, samples)
    want = hypergeom.sf(host[rows, cols] - 1, M, K_host[cols], nsize[rows])
    idx = (torch.as_tensor(rows, device=device),
           torch.as_tensor(cols, device=device))

    def scipy_err(sf):
        p = np.exp(sf._logsf_dev[idx].double().cpu().numpy())
        return float(np.abs(p - want).max())

    out["table"]["scipy_err"] = scipy_err(table)
    if out["table"]["scipy_err"] > 1e-6:
        raise AssertionError(f"table-band p differs from scipy by "
                             f"{out['table']['scipy_err']}")
    out["table"].update(enriched=int(counts_np.sum()),
                        attributes_enriched=int((counts_np > 0).sum()),
                        mean_neighborhood=float(nsize.mean()))

    # the f64 tail loop in host chunks: the same indicator and counts
    loop, out["hostchunks"] = fused("hostchunks-band",
                                    hypergeom_engine="loop")
    if not (torch.equal(loop._nes_binary_dev, table._nes_binary_dev)
            and np.array_equal(loop.attributes["num_neighborhoods_enriched"],
                               counts_np)):
        raise AssertionError("hostchunks-band and table-band indicators or "
                             "counts differ")
    out["hostchunks"]["scipy_err"] = scipy_err(loop)
    out["loop_vs_table_p"] = float((loop._logsf_dev.double().exp()
                                    - table._logsf_dev.double().exp())
                                   .abs().max())
    out["loop_vs_table_ulps"] = f32_ulps_dev(loop._logsf_dev,
                                             table._logsf_dev)
    loop_logsf = logsf_rows(loop._logsf_dev)  # phase 18's f64 tail reference
    # p is held; the log sf's ulps are reported: the loop's complement
    # branch rounds log pmf to f32 before its exp, an error that grows with
    # |log pmf|, where the table rounds an f64 value once
    if (out["loop_vs_table_p"] > 1e-6
            or out["hostchunks"]["scipy_err"] > 1e-6):
        raise AssertionError(f"hostchunks-band p differs from table-band's "
                             f"by {out['loop_vs_table_p']}, from scipy by "
                             f"{out['hostchunks']['scipy_err']}")

    # the parts alone, at this run's inputs
    order = np.argsort(bm.rank)
    out["host_operands_s"] = best(
        lambda: SAFE._hypergeom_host_operands(mat, order))
    n2a_dev = table._node2attribute_device()
    out["prep_s"] = best(lambda: eb.band_hyper_operands_device(n2a_dev,
                                                               order))
    nan0_d, nnn_d, K_d, _, _ = table._band_hyper_operands_cached(order)
    K_np = K_d.cpu().numpy()
    npad = bm.data.shape[0] - 2 * bm.bt * BLOCK
    nsize_d = bst.band_matmul(bm.data, eb._pad_rows_to(nnn_d[:, None], npad),
                              bt=bm.bt)[:, 0]
    plan = htab.plan(K_np, float(nsize_d.max()), M)
    out["table_plan"] = dict(chunks=len(plan["chunks"]),
                             total_cells=plan["total_cells"],
                             geometry=sorted({(c["R"], c["S_max"], c["C"])
                                              for c in plan["chunks"]}))
    rank_d = torch.as_tensor(bm.rank, device=device)
    log_thr = float(np.log(0.05))

    def table_chunk(ch):
        # the engine on a plan of this chunk alone: its census, table,
        # lookup and placement, with the sizes' contraction and the
        # outputs' allocation
        return eb.hypergeom_band_table(
            bm.data, nan0_d, nnn_d, M, 0.05, bt=bm.bt, rank_np=bm.rank,
            K_np=K_np, plan=dict(plan, chunks=[ch]))

    out["table_chunk_s"] = [best(lambda ch=ch: table_chunk(ch))
                            for ch in (plan["chunks"][0], plan["chunks"][-1])]
    out["table_all_s"] = best(lambda: eb.hypergeom_band_table(
        bm.data, nan0_d, nnn_d, M, 0.05, bt=bm.bt, rank_np=bm.rank,
        K_np=K_np, plan=plan))
    nan0_h, nnn_h, _ = SAFE._hypergeom_host_operands(mat, order)
    K_sorted = np.sort(nan0_h.sum(axis=0), kind="stable")
    chunk = SAFE._hypergeom_attr_chunk(n, attrs)
    out["attr_chunk"] = chunk
    starts = [min(c * chunk, attrs - chunk) for c in range(-(-attrs // chunk))]
    out["chunk_iters"] = [eb._iteration_bucket(tail_iterations(
        M, min(int(max(1.0, K_sorted[s:s + chunk].max())), M)))
        for s in starts]
    lgt = torch.as_tensor(lgamma_table(M), device=device)
    order_a = np.argsort(nan0_h.sum(axis=0), kind="stable")

    nnn_t = torch.as_tensor(nnn_h, device=device)
    out["tail_chunk_s"] = []
    for i in (0, len(starts) - 1):  # the smallest terms, the largest
        cols_a = order_a[starts[i]:starts[i] + chunk]
        x = torch.as_tensor(nan0_h[:, cols_a], device=device)
        k_c = torch.as_tensor(K_sorted[starts[i]:starts[i] + chunk],
                              device=device)
        out["tail_chunk_s"].append(best(lambda: eb.hypergeom_core_band(
            bm.data, x, nnn_t, k_c, lgt, M, 0.05,
            iterations=out["chunk_iters"][i], bt=bm.bt, rank=rank_d)))
    row_chunk = SAFE._fdr_row_chunk(tuple(table._logsf_dev.shape))
    out["fdr_s"] = best(lambda: fdr_bh_logsf(table._logsf_dev, log_thr,
                                             row_chunk=row_chunk))
    del nan0_h, nnn_h, x
    if cuda:
        out["table"]["profile"] = profile_steady(table)
        out["hostchunks"]["profile"] = profile_steady(loop)
    del loop

    # the stages: the fused run's results
    staged = session()
    out["staged_s"] = timed(lambda: (staged.define_neighborhoods(),
                                     staged.compute_pvalues()))
    if staged._hypergeom_engine_used != "table-band-staged":
        raise AssertionError(f"staged engine {staged._hypergeom_engine_used}")
    if not (torch.equal(staged._neighborhoods_dev.data, bm.data)
            and torch.equal(staged._logsf_dev, table._logsf_dev)
            and torch.equal(staged._nes_binary_dev, table._nes_binary_dev)
            and np.array_equal(
                staged.attributes["num_neighborhoods_enriched"], counts_np)):
        raise AssertionError("the stages differ from the fused run")
    del staged

    # FDR: the host log-space BH of the unadjusted log-survival, on sampled
    # rows (BH adjusts each row alone)
    fsf = session(multiple_testing=True)
    out["fdr_run_s"] = timed(fsf.run_pipeline)
    rows = torch.as_tensor(np.random.default_rng(SEED_GO_SAMPLES).choice(
        n, fdr_rows, replace=False), device=device)
    adj, nbin, _ = fdr_bh_logsf_np(table._logsf_dev[rows].cpu().numpy(),
                                   np.log(0.05))
    out["fdr_ulps"] = f32_ulps(fsf._logsf_dev[rows].cpu().numpy(), adj)
    if out["fdr_ulps"] > 1 or not np.array_equal(
            fsf._nes_binary_dev[rows].cpu().numpy(), nbin):
        raise AssertionError(f"FDR differs from fdr_bh_logsf_np: "
                             f"{out['fdr_ulps']} ulps or the indicator")
    out["fdr_enriched"] = int(np.sum(
        fsf.attributes["num_neighborhoods_enriched"]))
    del fsf

    # the domain stage on the table-band session, through the CSC view
    table.attributes["name"] = go_term_names(attrs)
    t0 = time.perf_counter()
    csc = table._nes_binary_for_top()
    out["csc_s"] = time.perf_counter() - t0
    if not issparse(csc):
        raise AssertionError("define_top_attributes did not take the CSC "
                             "view")
    r, c = np.nonzero(table._nes_binary_dev.cpu().numpy())
    want_csc = csc_matrix((np.ones(len(r), np.int8), (r, c)),
                          shape=csc.shape)
    if (csc != want_csc).nnz or not np.all(csc.data == 1):
        raise AssertionError("the CSC view differs from np.nonzero of the "
                             "int8 download")
    out["top_s"] = timed(table.define_top_attributes)
    out["domains_s"] = timed(table.define_domains)
    out["trim_s"] = timed(table.trim_domains)
    top = np.asarray(table.attributes["top"])
    out.update(top=int(top.sum()),
               domains=len(table.domains["id"]) - (0 in table.domains["id"]),
               phase_s=time.perf_counter() - t_phase,
               session=table, matrix=mat,  # phase 13 (d) compares with them
               loop_logsf=loop_logsf)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the euclidean band form, the sparse Bellman-Ford relax and the
# bit-packed indicator band
# ---------------------------------------------------------------------------

def peak_reset(device):
    """Reset the allocator's peak; the bytes allocated now (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def peak_gb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def timed_s(device, fn):
    """Host seconds of ``fn`` between two synchronises."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def best_s(device, fn, reps=3):
    return min(timed_s(device, fn) for _ in range(reps))


def euclid_points(n, seed=SEED_EUCLID):
    """n uniform points in [-1, 1]^2 and one normal attribute with 30% NaN
    (phase 6's law)."""
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
    return coords, build_band_attribute(n, seed + 1)


def euclid_session(device, coords, vals, **settings):
    """A euclidean-metric session on scatter points (no edges) with phase
    6's radius law: about 125 points a neighborhood."""
    sf = SAFE(device=device, verbose=False)
    sf.node_distance_metric = "euclidean"
    sf.neighborhood_radius = float(np.sqrt(125.0 / (np.pi * len(coords))))
    sf.random_seed = SEED_NULL
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.load_network(network_file=(coords, np.zeros((0, 2), np.int64), None,
                                  None))
    sf.load_attributes(attribute_file=vals)
    return sf


def euclid_radius(sf) -> np.float32:
    x = sf._graph_arrays[0][:, 0]
    return np.float32(sf.neighborhood_radius * (x.max() - x.min()))


def euclid_host_rows(coords, src, r, chunk=8):
    """The strict ``d < r`` rows of the points ``src`` against every point
    on the host, in JAX's f32 arithmetic as the port takes it
    (``ops.apsp_bandstore._euclid_distances``: fma(dy, dy, dx dx) through
    f64, the f64 root rounded to f32), a chunk of rows at a time. Returns
    (the rows' neighbor index arrays, their distances, the count of cells
    within one f32 ulp of r)."""
    c32 = coords.astype(np.float32)
    r = np.float32(r)
    ulp = np.spacing(r)
    rows, dists, near = [], [], 0
    for i0 in range(0, len(src), chunk):
        s = src[i0:i0 + chunk]
        dx = c32[s, 0][:, None] - c32[None, :, 0]
        dy = c32[s, 1][:, None] - c32[None, :, 1]
        ssq = (dy.astype(np.float64) ** 2
               + (dx * dx).astype(np.float64)).astype(np.float32)
        d = np.sqrt(ssq.astype(np.float64)).astype(np.float32)
        near += int((np.abs(d - r) <= ulp).sum())
        for row in d:
            j = np.flatnonzero(row < r)
            rows.append(j)
            dists.append(row[j])
    return rows, dists, near


def band_rows(bm, src):
    """Rows of the original nodes ``src`` of a band (int8, bit-packed or f32
    distances): per row the original indices of its nonzero (finite)
    cells, sorted, and their values."""
    order = np.argsort(bm.rank)
    pos = bm.rank[src]
    g = torch.as_tensor(bm.bt * bm.block + pos, device=bm.data.device)
    host = bm.data[g].cpu().numpy()
    if host.dtype == np.uint8:
        host = np.unpackbits(host, axis=1, bitorder="little")
    rows, vals = [], []
    for k, p in enumerate(pos):
        c = np.flatnonzero(np.isfinite(host[k]) if np.isinf(bm.fill)
                           else host[k] != 0)
        j = (p // bm.block - bm.bt) * bm.block + c
        keep = (j >= 0) & (j < bm.n)
        idx = order[j[keep]]
        srt = np.argsort(idx)
        rows.append(idx[srt])
        vals.append(host[k][c[keep]][srt])
    return rows, vals


def same_rows(got, want) -> int:
    """Count of the rows whose index arrays differ."""
    return sum(not np.array_equal(a, b) for a, b in zip(got, want))


def packed_equals(packed, plain, rows=1 << 14) -> bool:
    """Is the bit-packed band the int8 band packed? Compared a chunk of
    rows at a time, so that no unpacked copy of a large band exists."""
    return all(torch.equal(bst.pack_bits_tile(plain[r0:r0 + rows]),
                           packed[r0:r0 + rows])
               for r0 in range(0, plain.shape[0], rows))


def run_euclid_1m(device, n=EUCLID_NODES, steady=3, rows=EUCLID_ROWS,
                  **settings):
    """Phase 13 (a): the euclidean band at ``n`` points through
    ``run_pipeline`` with the defaults ('auto' band storage, 'auto' packing)
    and ``keep_node_distances=False``; ``settings`` override (the CPU
    rehearsal forces the band and the packing at small n)."""
    t_phase = time.perf_counter()
    coords, vals = euclid_points(n)
    sf = euclid_session(device, coords, vals, keep_node_distances=False,
                        **settings)
    out = dict(nodes=n, valid_rows=int(np.isfinite(vals).sum()))
    base = peak_reset(device)
    reset_launches()
    out["warm_s"] = timed_s(device, sf.run_pipeline)
    out["launches"] = launch_counts()
    out["peak_packed_gb"], out["base_gb"] = peak_gb(device), (
        None if base is None else base / 1e9)
    check_launches(device, out["launches"])  # no FW: no kernel
    bm = sf._neighborhoods_dev
    if sf.apsp_engine_used != "band-storage" or bm.data.dtype != torch.uint8:
        raise AssertionError(f"the packed euclidean band was not taken: "
                             f"{sf.apsp_engine_used}, {bm.data.dtype}")
    width = (2 * bm.bt + 1) * BLOCK
    if n == EUCLID_NODES and (bm.band, bm.bt, width) != (6655, 52, 13440):
        raise AssertionError(f"band {bm.band}, bt {bm.bt}, W {width}")
    out.update(band=bm.band, bt=bm.bt, width=width,
               packed_gb=bm.data.numel() / 1e9,
               int8_gb=bst.band_nbytes(n, bm.band, itemsize=1) / 1e9)
    walls = [timed_s(device, sf.run_pipeline) for _ in range(steady)]
    out.update(steady_s=walls, steady_min_s=min(walls))
    if (sf.ns.shape != (n, 1) or not np.isfinite(sf.ns).all()
            or (sf.counts_neg + sf.counts_pos).min() < N_PERM):
        raise AssertionError("scores must be finite, of shape (n, 1), and "
                             "counts_neg + counts_pos at least P")

    # seeded rows of the unpacked indicator against the host
    r = euclid_radius(sf)
    src = np.random.default_rng(SEED_SOURCES).choice(n, rows, replace=False)
    t0 = time.perf_counter()
    want, _, out["near_radius_cells"] = euclid_host_rows(coords, src, r)
    out["host_rows_s"] = time.perf_counter() - t0
    got, _ = band_rows(bm, src)
    bad = same_rows(got, want)
    if bad:
        raise AssertionError(f"{bad} of {rows} indicator rows differ from "
                             f"the host's")
    out["mean_neighborhood"] = float(np.mean([len(w) for w in want]))

    # the parts alone, and the unpack in the contractions
    plan = sf._euclidean_band_plan(coords, n, float(r))
    rank = plan["rank"]
    coords_perm = torch.as_tensor(coords[np.argsort(rank)],
                                  dtype=torch.float32, device=device)
    bt = bm.bt
    out["build_packed_s"] = best_s(
        device, lambda: bst.euclidean_band_indicator(
            coords_perm, r, n=n, band=bm.band, packed=True))
    tail_args, kw = sf._band_null_operands(rank, bt, None)
    out["w_c"] = kw["w_c"]
    out["batch"] = kw["batch_size"]

    def null(band):
        gen = torch.Generator(device=device).manual_seed(SEED_NULL)
        return pipe._band_perm_tail(band, *tail_args[:-1], gen, bt=bt,
                                    block=BLOCK, **kw)

    out["null_packed_s"] = best_s(device, lambda: null(bm.data))
    vals_dev = tail_args[0]
    out["score_packed_s"] = best_s(device, lambda: eb.band_score(
        bm.data, vals_dev, bt=bt))
    valid_dev = tail_args[2]
    out["compact_packed_s"] = best_s(device, lambda: bst.apply_compaction(
        bm.data, valid_dev, kw["w_c"], bt=bt))
    if device.type == "cuda":
        t0 = time.perf_counter()
        out["profile"] = profile_steady(sf, host_ops=False)
        out["profile_s"] = time.perf_counter() - t0
    packed = bm.data
    ns, cn, cp = sf.ns.copy(), sf.counts_neg.copy(), sf.counts_pos.copy()
    out["mesh_ref"] = dict(band=band_digest(packed), ns=ns, counts_neg=cn,
                           counts_pos=cp)

    # the same session with the int8 band: equal bytes, scores and counts
    sf.band_indicator_bits = False
    peak_reset(device)
    reset_launches()
    out["int8_run_s"] = timed_s(device, sf.run_pipeline)
    out["int8_launches"] = launch_counts()
    out["peak_int8_gb"] = peak_gb(device)
    check_launches(device, out["int8_launches"])
    plain = sf._neighborhoods_dev.data
    if plain.dtype != torch.int8 or not packed_equals(packed, plain):
        raise AssertionError("the int8 band is not the packed band unpacked")
    del plain
    if not (np.array_equal(sf.ns, ns, equal_nan=True)
            and np.array_equal(sf.counts_neg, cn)
            and np.array_equal(sf.counts_pos, cp)):
        raise AssertionError("the int8 run's scores or counts differ from "
                             "the packed run's")
    out["int8_steady_s"] = timed_s(device, sf.run_pipeline)
    out["build_int8_s"] = best_s(
        device, lambda: bst.euclidean_band_indicator(coords_perm, r, n=n,
                                                     band=bm.band))
    plain = sf._neighborhoods_dev.data
    out["null_int8_s"] = best_s(device, lambda: null(plain))
    out["score_int8_s"] = best_s(device, lambda: eb.band_score(
        plain, vals_dev, bt=bt))
    out["compact_int8_s"] = best_s(device, lambda: bst.apply_compaction(
        plain, valid_dev, kw["w_c"], bt=bt))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_euclid_keep(device, n=BAND_NODES, terms=EUCLID_GO_TERMS,
                    rows=EUCLID_ROWS, samples=GO_SAMPLES):
    """Phase 13 (b): the euclidean band at ``n`` points with kept
    distances: the f32 band against the host on sampled rows, the stages
    against the fused run, and a binary matrix of ``terms`` terms of phase
    12's size law through the staged band GO engines against scipy."""
    t_phase = time.perf_counter()
    coords, vals = euclid_points(n, SEED_EUCLID + 2)
    sf = euclid_session(device, coords, vals, apsp_mode="band")
    V = int(np.isfinite(vals).sum())
    perm_idx = np.stack([np.random.default_rng(SEED_NULL + i).permutation(V)
                         for i in range(N_PERM // 10)])
    peak_reset(device)
    reset_launches()
    out = dict(nodes=n)
    out["fused_s"] = timed_s(device, lambda: sf.run_pipeline(
        perm_idx=perm_idx))
    out["launches"] = launch_counts()
    out["peak_gb"] = peak_gb(device)
    check_launches(device, out["launches"])
    bm, dm = sf._neighborhoods_dev, sf._node_distances_dev
    if bm.data.dtype != torch.int8 or dm is None:
        raise AssertionError("kept distances: an int8 band and an f32 band "
                             "expected")
    r = euclid_radius(sf)
    src = np.random.default_rng(SEED_SOURCES).choice(n, rows, replace=False)
    want, want_d, out["near_radius_cells"] = euclid_host_rows(coords, src, r)
    got, got_d = band_rows(dm, src)
    if same_rows(got, want) or not all(np.array_equal(a, b)
                                       for a, b in zip(got_d, want_d)):
        raise AssertionError("distance band rows differ from the host's")
    if same_rows(band_rows(bm, src)[0], want):
        raise AssertionError("indicator rows differ from the host's")

    staged = euclid_session(device, coords, vals, apsp_mode="band")
    out["staged_s"] = timed_s(device, lambda: (
        staged.define_neighborhoods(),
        staged.compute_pvalues(perm_idx=perm_idx)))
    if not (torch.equal(staged._neighborhoods_dev.data, bm.data)
            and np.array_equal(staged.ns, sf.ns, equal_nan=True)
            and np.array_equal(staged.counts_neg, sf.counts_neg)
            and np.array_equal(staged.counts_pos, sf.counts_pos)):
        raise AssertionError("the stages differ from the fused run")
    del staged

    rng = np.random.default_rng(SEED_BAND_GO)
    sizes = np.rint(np.exp(rng.uniform(np.log(3), np.log(300), terms)))
    mat = build_go_matrix(coords, sizes, SEED_BAND_GO)
    go = euclid_session(device, coords, mat, apsp_mode="band")
    reset_launches()
    out["go_s"] = timed_s(device, lambda: (go.define_neighborhoods(),
                                           go.compute_pvalues()))
    out["go_launches"] = launch_counts()
    check_launches(device, out["go_launches"], go._hypergeom_engine_used)
    if go._hypergeom_engine_used != "table-band-staged":
        raise AssertionError(f"engine {go._hypergeom_engine_used}")
    host, nsize, K_host, M = band_census(go, mat)
    rng = np.random.default_rng(SEED_GO_SAMPLES)
    rs, cs = rng.integers(0, n, samples), rng.integers(0, terms, samples)
    p = go.pvalues_pos[rs, cs]
    out["go_scipy_err"] = float(np.abs(p - hypergeom.sf(
        host[rs, cs] - 1, M, K_host[cs], nsize[rs])).max())
    if out["go_scipy_err"] > 1e-6:
        raise AssertionError(f"band GO p differs from scipy by "
                             f"{out['go_scipy_err']}")
    out.update(terms=terms, go_enriched=int(np.sum(
        go.attributes["num_neighborhoods_enriched"])),
        mean_neighborhood=float(nsize.mean()),
        phase_s=time.perf_counter() - t_phase)
    return out


def run_band_bf(device, ref, steady=3):
    """Phase 13 (c): ``band_relax='bf'`` on phase 6's network (session
    ``ref``): the relax recorded, the slots and rounds, the indicator band
    against phase 6's FW band (a differing cell only within one f32 ulp of
    the radius), the counts; then a budget of one round, which must fall
    back to the FW; BF's relax alone against the FW's."""
    t_phase = time.perf_counter()
    nb = -(-ref._num_nodes // BLOCK)
    sf = _band_session(device, ref)
    sf.band_relax = "bf"
    peak_reset(device)
    reset_launches()
    out = dict(warm_s=timed_s(device, lambda: sf.run_pipeline(
        num_permutations=N_PERM)))
    out["launches"] = launch_counts()
    out["peak_gb"] = peak_gb(device)
    check_launches(device, out["launches"])  # BF launches no FW kernel
    if sf._band_relax_used != "bf":
        raise AssertionError(f"relax {sf._band_relax_used}, 'bf' expected")
    out["steady_s"] = best_s(device, lambda: sf.run_pipeline(
        num_permutations=N_PERM), steady)
    coords, edges, lengths, _ = sf._graph_arrays
    nr = sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())
    plan = sf._band_storage_plan(coords, edges, lengths, len(coords), nr)
    nbr_s, dlt_s, wgt_s = plan["bf_slots"]
    out.update(slots=int(nbr_s.shape[1]), budget=int(plan["bf_max_iters"]))
    bt, r = plan["band"] // BLOCK + 1, inclusive_radius(nr)
    s0 = bst.band_init_from_edges(plan["u"], plan["v"], plan["w"],
                                  n=len(coords), band=plan["band"])
    s_bf, conv, out["iters"] = bst.apsp_band_bf(s0.clone(), nbr_s, dlt_s,
                                                wgt_s, r, bt=bt)
    if not conv:
        raise AssertionError("BF did not converge within its budget")
    s_fw = bst.apsp_band_fw(s0.clone(), bt=bt)
    got, want = sf._neighborhoods_dev.data, ref._neighborhoods_dev.data
    g, c = torch.nonzero(got != want, as_tuple=True)
    out["cells_differing"] = int(g.numel())
    # each differing cell's distance to the radius, in f32 ulps of it: the
    # nearer of its BF and FW distances
    ulps = (torch.minimum((s_bf[g, c].double() - float(r)).abs(),
                          (s_fw[g, c].double() - float(r)).abs())
            / float(np.spacing(np.float32(r)))).cpu().tolist()
    for gi, ci, u in zip(g.tolist(), c.tolist(), ulps):
        print(f"band BF: cell ({gi}, {ci}) differs from the FW band, "
              f"{u:.2f} f32 ulps from the radius", flush=True)
    if any(u > 1 for u in ulps):
        raise AssertionError("a BF indicator cell differs beyond one ulp of "
                             "the radius")
    if not ulps and not (
            np.array_equal(sf.counts_neg, ref.counts_neg)
            and np.array_equal(sf.counts_pos, ref.counts_pos)):
        raise AssertionError("BF counts differ from phase 6's")
    out["bf_alone_s"] = best_s(device, lambda: bst.apsp_band_bf(
        s0.clone(), nbr_s, dlt_s, wgt_s, r, bt=bt), steady)
    out["fw_alone_s"] = best_s(device, lambda: bst.apsp_band_fw(
        s0.clone(), bt=bt), steady)
    if device.type == "cuda":
        out["profile"] = profile_steady(None, run=lambda: bst.apsp_band_bf(
            s0.clone(), nbr_s, dlt_s, wgt_s, r, bt=bt))
    del s0, s_bf, s_fw

    # a budget of one round: BF gives way to the FW
    budget = bst.bf_max_iters
    bst.bf_max_iters = lambda *a, **k: 1
    try:
        fb = _band_session(device, ref)
        fb.band_relax = "bf"
        reset_launches()
        out["fallback_s"] = timed_s(device, lambda: fb.run_pipeline(
            num_permutations=N_PERM))
        out["fallback_launches"] = launch_counts()
    finally:
        bst.bf_max_iters = budget
    check_launches(device, out["fallback_launches"], close_diag=nb,
                   relax_panel=nb, relax_skew_sym=nb)
    if fb._band_relax_used != "bf->fw" or not (
            torch.equal(fb._neighborhoods_dev.data, want)
            and np.array_equal(fb.counts_neg, ref.counts_neg)):
        raise AssertionError(f"the fall-back run: {fb._band_relax_used}, or "
                             f"its results differ from phase 6's")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_band_packed(device, ref, go_ref, go_mat):
    """Phase 13 (d): phase 6's network with ``band_indicator_bits=True``:
    the quantitative run against phase 6's (band bytes, counts), and one
    ``table-band`` run of phase 12's matrix against phase 12's session
    ``go_ref`` (indicator, counts, log sf bitwise); peaks."""
    t_phase = time.perf_counter()
    nb = -(-ref._num_nodes // BLOCK)
    sf = _band_session(device, ref)
    sf.band_indicator_bits = True
    base = peak_reset(device)
    out = dict(base_gb=None if base is None else base / 1e9)
    reset_launches()
    out["quant_s"] = timed_s(device, lambda: sf.run_pipeline(
        num_permutations=N_PERM))
    out["quant_launches"] = launch_counts()
    out["quant_peak_gb"] = peak_gb(device)
    check_launches(device, out["quant_launches"], close_diag=nb,
                   relax_panel=nb, relax_skew_sym=nb)
    data = sf._neighborhoods_dev.data
    if data.dtype != torch.uint8 or not packed_equals(
            data, ref._neighborhoods_dev.data):
        raise AssertionError("the packed band is not phase 6's packed")
    if not (np.array_equal(sf.counts_neg, ref.counts_neg)
            and np.array_equal(sf.counts_pos, ref.counts_pos)
            and np.array_equal(sf.ns, ref.ns)):
        raise AssertionError("the packed run's scores or counts differ from "
                             "phase 6's")
    out["quant_steady_s"] = timed_s(device, lambda: sf.run_pipeline(
        num_permutations=N_PERM))
    del sf

    go = SAFE(device=device, verbose=False)
    for k in ("apsp_mode", "keep_node_distances", "neighborhood_radius"):
        setattr(go, k, getattr(ref, k))
    go.band_indicator_bits = True
    go.load_network(network_file=ref._graph_arrays)
    go.load_attributes(attribute_file=go_mat)
    base = peak_reset(device)
    out["table_base_gb"] = None if base is None else base / 1e9
    reset_launches()
    out["table_s"] = timed_s(device, go.run_pipeline)
    out["table_launches"] = launch_counts()
    out["table_peak_gb"] = peak_gb(device)
    check_launches(device, out["table_launches"], go._hypergeom_engine_used,
                   close_diag=nb, relax_panel=nb, relax_skew_sym=nb)
    if go._hypergeom_engine_used != "table-band":
        raise AssertionError(f"engine {go._hypergeom_engine_used}")
    if not (go._neighborhoods_dev.data.dtype == torch.uint8
            and torch.equal(go._nes_binary_dev, go_ref._nes_binary_dev)
            and torch.equal(go._logsf_dev, go_ref._logsf_dev)
            and np.array_equal(go.attributes["num_neighborhoods_enriched"],
                               go_ref.attributes[
                                   "num_neighborhoods_enriched"])):
        raise AssertionError("the packed table-band run differs from phase "
                             "12's")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def profile_steady(sf, top=8, run=None, host_ops=True):
    """Device busy time and idle share of one steady run (``run``, else
    ``sf.run_pipeline``), and its largest kernels, from torch.profiler
    (CUPTI). ``host_ops=False`` records the device's events only: at 10^5
    launches a run, the host ops' events cost the profiler minutes to
    aggregate."""
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        (run or sf.run_pipeline)()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies only: an aten op's row repeats its kernels' time
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device.sort(key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in device) / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                top=[(e.key[:60], e.count, _device_us(e) / 1e3)
                     for e in device[:top]])


# ---------------------------------------------------------------------------
# Phase 14: the file-driven workflow (INI, network and attribute files, the
# device spring layout, the TSV reports and the batch CLI)
# ---------------------------------------------------------------------------

def gene_keys(n):
    return np.array([f"G{i:05d}" for i in range(n)], dtype=object)


def preservation(coords, edges, L=15):
    """The share of edges whose endpoints are among each other's L nearest
    layout neighbours on at least one side
    (tests/test_layout_quality.py:29-38)."""
    coords = np.asarray(coords, np.float64)
    _, nn = cKDTree(coords).query(coords, k=L + 1)
    nn = nn[:, 1:]
    u, v = edges[:, 0], edges[:, 1]
    hit = (nn[u] == v[:, None]).any(axis=1) | (nn[v] == u[:, None]).any(axis=1)
    return float(hit.mean())


def write_file_inputs(tmp, net, vals, go_a, names):
    """Phase 14's files, with numpy and scipy only: phase 4's network as a
    3-column .txt of gene keys and as a MATLAB session (coordinates
    included), its attribute as a one-column .txt (NaN rows blank), GO
    matrix A as a .txt, and the INI. Returns their paths."""
    coords, edges, _, _ = net
    n = len(coords)
    keys = gene_keys(n)
    paths = SimpleNamespace(network=os.path.join(tmp, "network.txt"),
                            attribute=os.path.join(tmp, "attribute.txt"),
                            go=os.path.join(tmp, "go.txt"),
                            mat=os.path.join(tmp, "network.mat"),
                            ini=os.path.join(tmp, "example1.ini"))
    with open(paths.network, "w") as f:
        f.writelines(f"{keys[u]}\t{keys[v]}\t1.0\n" for u, v in edges)
    with open(paths.attribute, "w") as f:
        f.write("gene\tattribute\n")
        f.writelines(f"{keys[i]}\t{'' if np.isnan(x) else repr(float(x))}\n"
                     for i, x in enumerate(vals[:, 0]))
    digits = np.array(["0", "1"])
    blank = "\t" * (go_a.shape[1] - 1)
    with open(paths.go, "w") as f:
        f.write("gene\t" + "\t".join(names) + "\n")
        for i in range(n):
            row = go_a[i]
            f.write(keys[i] + "\t" + (blank if np.isnan(row[0]) else "\t".join(
                digits[row.astype(np.int64)])) + "\n")
    adjacency = coo_matrix((np.ones(2 * len(edges)),
                            (np.concatenate([edges[:, 0], edges[:, 1]]),
                             np.concatenate([edges[:, 1], edges[:, 0]]))),
                           shape=(n, n)).tocsc()
    spio.savemat(paths.mat, {"layout": {
        "edges": adjacency, "label": keys, "label_orf": keys,
        "x": coords[:, 0], "y": coords[:, 1]}})
    with open(paths.ini, "w") as f:
        f.write(f"[Input files]\nnetworkfile = {paths.network}\n"
                f"annotationfile = {paths.attribute}\n"
                "layoutAlgorithm = spring_tpu\n"
                f"[Analysis parameters]\nrandomSeed = {SEED_NULL}\n")
    return paths


def read_tsv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def check_reports(sf, out_dir):
    """Read the three TSV reports back with csv and hold them against the
    session's arrays."""
    dom = read_tsv(os.path.join(out_dir, "domain_properties_annotation.txt"))
    if dom[0] != ["domain", "id", "label"]:
        raise AssertionError(f"domain report header {dom[0]}")
    ids = [int(r[0]) for r in dom[1:]]
    if (ids != list(sf.domains["id"]) or [int(r[1]) for r in dom[1:]] != ids
            or [r[2] for r in dom[1:]] != list(sf.domains["label"])
            or 0 in ids):
        raise AssertionError("domain report differs from sf.domains")
    att = read_tsv(os.path.join(out_dir, "attribute_properties_annotation.txt"))
    head = att[0]
    col = {name: [r[j] for r in att[1:]] for j, name in enumerate(head)}
    a = sf.attributes
    if (head[1:] != list(a) or col["name"] != list(a["name"])
            or [float(x) for x in col["num_neighborhoods_enriched"]]
            != [float(x) for x in a["num_neighborhoods_enriched"]]
            or col["top"] != [str(bool(x)) for x in a["top"]]
            or [int(x) for x in col["domain"]] != list(a["domain"])):
        raise AssertionError("attribute report differs from sf.attributes")
    nod = read_tsv(os.path.join(out_dir, "node_properties_annotation.txt"))
    if nod[0] != ["", "id", "key", "label", "domain", "nes", "num_domains"]:
        raise AssertionError(f"node report header {nod[0]}")
    rows = nod[1:]
    n2d = sf.node2domain
    if ([r[2] for r in rows] != list(sf.graph.nodes["key"])
            or [int(r[4]) for r in rows] != list(n2d.primary_domain)
            or not np.array_equal(np.array([float(r[5]) for r in rows]),
                                  n2d.primary_nes)
            or not np.array_equal(np.array([float(r[6]) for r in rows]),
                                  sf.nodes["num_domains"])):
        raise AssertionError("node report differs from sf.node2domain")
    return dict(domains=len(ids), rows=(len(att) - 1, len(rows)))


def run_file_workflow(device, net, vals, ref, band_edges, tmp, steady=3):
    """Phase 14 (a) and (b), as the module docstring says. ``ref``: phase
    4's array-loaded session; ``band_edges``: phase 6's edge list."""
    t_phase = time.perf_counter()
    coords, edges, lengths, _ = net
    n = len(coords)
    go_a = go_matrices(coords)[0]
    names = go_term_names(go_a.shape[1])
    t0 = time.perf_counter()
    paths = write_file_inputs(tmp, net, vals, go_a, names)
    out = dict(write_s=time.perf_counter() - t0, launches={})

    # (a) 1: SAFE(path_to_ini_file=...) -> load_network (the native parse
    # and the exact energy layout on the card) -> load_attributes
    sf = SAFE(path_to_ini_file=paths.ini, verbose=False, device=device)
    if sf.layout_algorithm != "spring_tpu":
        raise AssertionError("the INI session is not the card's spring_tpu")
    out["load_network_s"] = timed_s(device, lambda: sf.load_network(
        node_key_attribute="key"))
    graph = sf.graph
    if graph.num_nodes != n or graph.number_of_edges() != len(edges):
        raise AssertionError(f"file network {graph}")
    if graph.nodes["x"].dtype != np.float32:
        raise AssertionError("the device layout did not give float32")
    out["parse_s"] = best_s(device, lambda: edgelist.parse_edgelist(
        paths.network, 3), reps=steady)
    rec = NetworkRecord(graph.num_nodes, graph.edges)
    out["layout_s"] = best_s(device, lambda: layout_mod.spring_layout_device(
        rec, seed=SEED_NULL, device=device), reps=steady)
    again = layout_mod.spring_layout_device(rec, seed=SEED_NULL, device=device)
    if not (np.array_equal(again[:, 0], graph.nodes["x"])
            and np.array_equal(again[:, 1], graph.nodes["y"])):
        raise AssertionError("the seeded device layout is not reproducible")
    laid = NetworkRecord(graph.num_nodes, graph.edges, dict(graph.nodes))
    out["lengths_s"] = best_s(device, lambda: layout_mod.calculate_edge_lengths(
        laid, verbose=False), reps=steady)
    if not np.array_equal(laid.edge_data["length"],
                          graph.edge_data["length"]):
        raise AssertionError("edge lengths differ from the session's")
    # GO width: the host parse of matrix A's file, before anything else
    # loads the host
    go_keys = list(gene_keys(n))
    out["go_parse_s"] = best_s(device, lambda: attr_io.read_attributes(
        paths.go, node_label_order=go_keys, verbose=False), reps=2)

    # the port's CPU layout of the same graph and seed, for the
    # preservation statistic, on a host thread while the card works
    cpu_layout = {}

    def cpu_reference():
        t0 = time.perf_counter()
        cpu_layout["xy"] = layout_mod.spring_layout_device(
            rec, seed=SEED_NULL, device="cpu")
        cpu_layout["s"] = time.perf_counter() - t0

    worker = threading.Thread(target=cpu_reference)
    worker.start()

    sf.load_attributes()
    if sf.node2attribute.dtype != np.float32:
        raise AssertionError("the attribute file did not read float32")
    reset_launches()
    out["warm_s"] = timed_s(device, sf.run_pipeline)
    out["launches"]["file_example1"] = launch_counts()
    out["engine"], out["window"] = sf.apsp_engine_used, sf.window_used
    # the certified banded window, or B7's dense form where the layout
    # fails the certificate: each round one close_diag, the pivot panels
    # and one relax_window_sym
    nb = -(-n // BLOCK)
    if sf.apsp_engine_used not in ("banded-window", "dense"):
        raise AssertionError(f"engine {sf.apsp_engine_used}")
    check_launches(device, out["launches"]["file_example1"], close_diag=nb,
                   relax_panel=2 * nb, relax_window_sym=nb)
    out["steady_s"] = min(timed_s(device, sf.run_pipeline)
                          for _ in range(steady))
    fc, fe, fl, _ = sf._graph_arrays
    r = float(inclusive_radius(sf.neighborhood_radius
                               * (fc[:, 0].max() - fc[:, 0].min())))
    if not np.array_equal(sf.neighborhoods.astype(bool),
                          dijkstra_indicator(fc, fe, fl, r)):
        raise AssertionError("file session's indicator differs from scipy "
                             "Dijkstra's on its own layout")
    finite = np.isfinite(sf.ns)
    if (sf.ns.shape != (n, 1) or not finite.any()
            or not (sf.counts_neg + sf.counts_pos)[finite].min()
            >= sf.num_permutations):
        raise AssertionError("file session's scores or counts are off")
    out["mean_neighborhood"] = float(sf.neighborhoods.sum(axis=1).mean())

    # (a) 2: the .mat twin of phase 4's network, phase 4's attribute and
    # seed: phase 4's results exactly
    tw = SAFE(path_to_ini_file=paths.ini, verbose=False, device=device)
    tw.load_network(network_file=paths.mat, node_key_attribute="key")
    tc, te, tl, _ = tw._graph_arrays
    if not (np.array_equal(tc, coords) and np.array_equal(te, edges)
            and np.array_equal(tl, lengths)):
        raise AssertionError("the .mat twin's arrays differ from phase 4's")
    tw.load_attributes(attribute_file=vals)
    reset_launches()
    out["mat_s"] = timed_s(device, tw.run_pipeline)
    out["launches"]["file_mat_twin"] = launch_counts()
    if not (np.array_equal(tw.neighborhoods, ref.neighborhoods)
            and np.array_equal(tw.ns, ref.ns, equal_nan=True)
            and np.array_equal(tw.counts_neg, ref.counts_neg)
            and np.array_equal(tw.counts_pos, ref.counts_pos)):
        raise AssertionError("the .mat twin's results differ from phase 4's")

    # (a) 3: GO matrix A from its file on the twin, the stages, the domain
    # stage and the reports
    t0 = time.perf_counter()
    tw.load_attributes(attribute_file=paths.go)
    out["go_load_s"] = time.perf_counter() - t0
    if not np.array_equal(tw.node2attribute, go_a, equal_nan=True):
        raise AssertionError("GO file values differ from phase 10's matrix A")
    reset_launches()
    out["go_pvalues_s"] = timed_s(device, tw.compute_pvalues)
    t0 = time.perf_counter()
    tw.define_top_attributes()
    tw.define_domains()
    tw.trim_domains()
    out["go_domains_s"] = time.perf_counter() - t0
    report_dir = os.path.join(tmp, "reports")
    os.makedirs(report_dir)
    out["reports_s"] = timed_s(device, lambda: tw.print_output_files(
        output_dir=report_dir))
    out.update(go_engine=tw._hypergeom_engine_used,
               go_enriched=int(np.asarray(
                   tw.attributes["num_neighborhoods_enriched"]).sum()),
               go_top=int(np.sum(tw.attributes["top"])),
               **check_reports(tw, report_dir))

    # (a) 4: the batch CLI in-process against a facade run of the INI
    pickle_path = os.path.join(tmp, "nes.p")
    reset_launches()
    t0 = time.perf_counter()
    if cli.main([paths.attribute, "--ini", paths.ini, "--output",
                 pickle_path, "--device", str(device)]) != 0:
        raise AssertionError("the CLI failed")
    out["cli_s"] = time.perf_counter() - t0
    out["launches"]["file_cli"] = launch_counts()
    with open(pickle_path, "rb") as f:
        cli_nes = pickle.load(f)
    fa = SAFE(path_to_ini_file=paths.ini, verbose=False, device=device)
    fa.load_network()
    fa.define_neighborhoods()
    fa.load_attributes(attribute_file=paths.attribute)
    fa.compute_pvalues(num_permutations=N_PERM)
    if not np.array_equal(cli_nes, fa.nes, equal_nan=True):
        raise AssertionError("the CLI's NES differ from the facade's")

    # (b) the sampled energy layout at band scale, on the card
    bn = int(band_edges.max()) + 1
    brec = NetworkRecord(bn, band_edges)
    out["band_layout_warm_s"] = timed_s(device, lambda: out.update(
        band_xy=layout_mod.spring_layout_device(brec, seed=SEED_NULL,
                                                device=device)))
    out["band_layout_s"] = timed_s(device, lambda: layout_mod.
                                   spring_layout_device(brec, seed=SEED_NULL,
                                                        device=device))
    out["band_nodes"], out["band_edges"] = bn, len(band_edges)
    out["band_preservation"] = preservation(out.pop("band_xy"), band_edges)

    out["phase_s"] = time.perf_counter() - t_phase

    def finish():
        """Join the CPU layout and compare the two layouts' preservation
        statistics; ``main`` calls it after phase 15, which runs while the
        CPU layout does."""
        t0 = time.perf_counter()
        worker.join()
        res = dict(cpu_layout_s=cpu_layout["s"],
                   join_wait_s=time.perf_counter() - t0,
                   preservation=preservation(np.column_stack(
                       [graph.nodes["x"], graph.nodes["y"]]), graph.edges),
                   preservation_cpu=preservation(cpu_layout["xy"],
                                                 graph.edges))
        if abs(res["preservation"] - res["preservation_cpu"]) \
                > PRESERVATION_MARGIN:
            raise AssertionError(f"card layout preservation "
                                 f"{res['preservation']} vs the CPU "
                                 f"layout's {res['preservation_cpu']}")
        return res

    out["finish"] = finish
    return out


# ---------------------------------------------------------------------------
# Phase 15: the host extras (save and checkpoints on the card, the plot
# data, profiling, make_go at GO scale, the validation battery)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
PUBLIC = ("node2attribute", "ns", "pvalues_neg", "pvalues_pos", "nes",
          "nes_binary")
# make_go's synthetic ontology: the GO biological-process branch's size
SEED_MAKE_GO = 27
MAKE_GO_BP, MAKE_GO_OTHER, MAKE_GO_OBSOLETE = 12000, 2000, 200
MAKE_GO_DEPTH, MAKE_GO_PER_LOCUS, MAKE_GO_ORPHANS = 12, 8, 40


def bitwise(x, y) -> bool:
    """The same shape, dtype and bits (NaN payloads included)."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype.kind == "f":
        kind = f"i{x.dtype.itemsize}"
        return np.array_equal(np.ascontiguousarray(x).view(kind),
                              np.ascontiguousarray(y).view(kind))
    if x.dtype == object:
        return all(np.array_equal(a, b) for a, b in zip(x, y))
    return np.array_equal(x, y)


def same_session(a, b, band: bool, what: str):
    """Raise unless the public arrays of two sessions are bitwise equal
    (the band's bytes and frame for a band session, which has no dense
    view at this scale)."""
    names = PUBLIC + (() if band else ("neighborhoods", "node_distances"))
    for k in names:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (x is not None
                                          and not bitwise(x, y)):
            raise AssertionError(f"{what}: {k} differs")
    if band:
        bx, by = a._neighborhoods_dev, b._neighborhoods_dev
        if not (bitwise(bst._host(bx.data), bst._host(by.data))
                and np.array_equal(bx.rank, by.rank)
                and (bx.n, bx.band, bx.block) == (by.n, by.band, by.block)):
            raise AssertionError(f"{what}: the band differs")


def no_tensor(state) -> bool:
    """No torch tensor in a session's state (band wrappers included)."""
    for v in state.values():
        if isinstance(v, torch.Tensor) or (isinstance(v, bst.BandedMatrix)
                                           and isinstance(v.data,
                                                          torch.Tensor)):
            return False
        if isinstance(v, (dict, list, tuple)) and any(
                isinstance(x, torch.Tensor)
                for x in (v.values() if isinstance(v, dict) else v)):
            return False
    return True


def drop_host_views(sf):
    """Forget the host copies a session derives from its device results
    (the f64 views, the int8 download, the deferred device NES), as a new
    run leaves it."""
    sf._nes_np = sf._pvalues_pos_np = None
    sf._nes_binary_np = sf._nes_binary_i8_np = None
    if sf._nes_from_logsf:
        sf._nes_dev = None


WORKSTATION = """
import pickle, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
assert not torch.cuda.is_available()
with open({path!r}, "rb") as f:
    sf = pickle.load(f)
n2d = sf.node2domain
np.savez({out!r}, nes=sf.nes, nes_binary=sf.nes_binary,
         column=sf._nes_column({j}), counts=n2d.counts, domains=n2d.domains,
         primary_domain=n2d.primary_domain, primary_nes=n2d.primary_nes,
         device=np.array(str(sf.device)))
"""


def run_saves(device, sessions, tmp):
    """Phase 15 (a): ``save`` of each session on the card, unpickled in
    this process: no tensor, every public array bitwise; the band session's
    file within 10% of its band and compact statistics (and attribute
    matrix); the domain session read by a process that sees no card, then
    re-clustered at 0.5 beside the original."""
    out = {}
    for name, (sf, band) in sessions.items():
        path = os.path.join(tmp, f"{name}.p")
        t0 = time.perf_counter()
        sf.save(output_file=path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            back = pickle.load(f)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        if not no_tensor(back.__dict__) or back.device != sf.device:
            raise AssertionError(f"{name}: the pickle holds a tensor, or "
                                 f"its device is {back.device}")
        row = dict(bytes=size, save_s=save_s, load_s=load_s)
        if band:
            n = sf._num_nodes
            if any(isinstance(v, np.ndarray) and v.size >= n * n
                   for v in back.__dict__.values()):
                raise AssertionError(f"{name}: a dense N x N was pickled")
            compact = (back._neighborhoods_dev.data.nbytes
                       + back._logsf_np.nbytes
                       + back._nes_binary_i8_np.nbytes
                       + back.node2attribute.nbytes)
            row["budget_bytes"] = int(1.1 * compact)
            if size > 1.1 * compact:
                raise AssertionError(f"{name}: {size} bytes pickled, over "
                                     f"1.1 x {compact}")
        t0 = time.perf_counter()
        same_session(back, sf, band, f"{name} pickle")
        row["compare_s"] = time.perf_counter() - t0
        if name == "domains":
            j = int(np.flatnonzero(sf.attributes["top"])[0])
            res = os.path.join(tmp, "workstation.npz")
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-c", WORKSTATION.format(
                    repo=REPO, path=path, out=res, j=j)],
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, cwd=REPO,
                check=True, timeout=600)
            row["workstation_s"] = time.perf_counter() - t0
            with np.load(res) as w:
                n2d = sf.node2domain
                ok = (bitwise(w["nes"], sf.nes)
                      and bitwise(w["nes_binary"], sf.nes_binary)
                      and bitwise(w["column"], sf.nes[:, j])
                      and bitwise(w["counts"], n2d.counts)
                      and bitwise(w["domains"], n2d.domains)
                      and bitwise(w["primary_domain"], n2d.primary_domain)
                      and bitwise(w["primary_nes"], n2d.primary_nes)
                      and str(w["device"]) == str(sf.device))
            if not ok:
                raise AssertionError("the workstation's views differ")
            os.remove(res)
            for s in (sf, back):
                s.define_domains(attribute_distance_threshold=0.5)
                s.trim_domains()
            if not (bitwise(back.node2domain.counts, sf.node2domain.counts)
                    and bitwise(back.node2domain.primary_nes,
                                sf.node2domain.primary_nes)
                    and bitwise(back.attributes["domain"],
                                sf.attributes["domain"])
                    and back.domains["label"] == sf.domains["label"]):
                raise AssertionError("re-clustering the unpickled session "
                                     "differs from the original's")
            row["domains_050"] = len(sf.domains["id"])
        os.remove(path)
        del back
        out[name] = row
    return out


def json_rounded(values):
    """What a checkpoint's JSON gives back for f64 values (ten decimals,
    read as read_json reads them)."""
    return np.array([ck._ujson_float(ck._json_float(v)) for v in values])


def same_tables(back, sf, what):
    for col in ("name", "top", "domain", "num_neighborhoods_enriched"):
        if col in sf.attributes and not np.array_equal(
                np.asarray(back.attributes[col]),
                np.asarray(sf.attributes[col])):
            raise AssertionError(f"{what}: attributes[{col!r}] differs")
    if sf.node2domain is not None:
        a, b = back.node2domain, sf.node2domain
        if not (bitwise(a.counts, b.counts) and bitwise(a.domains, b.domains)
                and bitwise(a.primary_domain, b.primary_domain)
                and bitwise(a.primary_nes, json_rounded(b.primary_nes))):
            raise AssertionError(f"{what}: node2domain differs")
    if sf.domains is not None and not (
            np.array_equal(back.domains["id"], sf.domains["id"])
            and list(back.domains["label"]) == list(sf.domains["label"])):
        raise AssertionError(f"{what}: domains differ")


def run_checkpoints(device, sessions, tmp):
    """Phase 15 (b): ``save_session`` / ``load_session(device='cuda')`` of
    each session: its arrays bitwise (a band in its dtype), its tables
    equal (the NES of node2domain as its JSON rounds it), and
    ``define_top_attributes`` resumes on the loaded session with the
    original's result, launching no kernel."""
    out, resume = {}, {name: 0 for name in launch_counts()}
    for name, (sf, band) in sessions.items():
        base = os.path.join(tmp, f"{name}_ck")
        t0 = time.perf_counter()
        ck.save_session(sf, base)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(base + ext)
                   for ext in (".npz", ".meta.json"))
        reset_launches()
        t0 = time.perf_counter()
        back = ck.load_session(base, graph=sf.graph, verbose=False,
                               device=device.type)
        load_s = time.perf_counter() - t0
        if band:
            dtype = bst._host(sf._neighborhoods_dev.data).dtype
            if back._neighborhoods_dev.data.dtype != dtype:
                raise AssertionError(f"{name}: the band came back "
                                     f"{back._neighborhoods_dev.data.dtype}")
        same_session(back, sf, band, f"{name} checkpoint")
        same_tables(back, sf, f"{name} checkpoint")
        if "top" not in sf.attributes:
            sf.define_top_attributes()
        t0 = time.perf_counter()
        back.define_top_attributes()
        resume_s = time.perf_counter() - t0
        for k, v in launch_counts().items():
            resume[k] += v
        if not np.array_equal(back.attributes["top"], sf.attributes["top"]):
            raise AssertionError(f"{name}: the resumed top attributes "
                                 "differ")
        for ext in (".npz", ".meta.json"):
            os.remove(base + ext)
        del back
        out[name] = dict(bytes=size, save_s=save_s, load_s=load_s,
                         resume_s=resume_s)
    check_launches(device, resume)
    return out, resume


def host_mixture(b, domain_of_attr, rgb):
    """The domain-mixture colors written out on the host from an indicator
    (reference safe.py:884-904)."""
    ids = np.unique(domain_of_attr)
    counts = np.stack([b[:, domain_of_attr == d].sum(axis=1) for d in ids],
                      axis=1).astype(np.float64)
    total = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        mix = counts @ rgb[:len(ids)] / total
    bright = mix.sum(axis=1)
    mix[~np.isfinite(bright)] = 0.0
    mean = np.nanmean(mix[:, :-1])
    gain = 0.1 / mean if mean else 1.0
    return np.clip(mix * gain if gain > 1 else mix, None, 1)


def run_plot_data(dom, band_go):
    """Phase 15 (c): the plot data, no matplotlib imported."""
    from safepy_tpu_torch.plot_data import domain_mixture_colors

    dom_of_attr = np.asarray(dom.attributes["domain"])
    rgb = np.random.default_rng(SEED_MAKE_GO).random(
        (len(np.unique(dom_of_attr)), 4))
    got = domain_mixture_colors(dom, rgb)
    want = host_mixture(dom._nes_binary_dev.cpu().numpy(), dom_of_attr, rgb)
    err = float(np.abs(got - want).max())
    if err > 1e-12:
        raise AssertionError(f"domain mixture colors differ by {err}")
    drop_host_views(band_go)
    full_nes = band_go._nes_device().cpu().numpy().astype(np.float64)
    full_bin = band_go._nes_binary_dev.cpu().numpy()
    drop_host_views(band_go)
    a = full_bin.shape[1]
    cols = range(0, a, 97)
    t0 = time.perf_counter()
    for j in cols:
        if not (bitwise(band_go._nes_column(j), full_nes[:, j])
                and bitwise(band_go._nes_binary_column(j), full_bin[:, j])):
            raise AssertionError(f"column {j} differs from the full matrix")
    columns_s = time.perf_counter() - t0
    if band_go._nes_np is not None or band_go._nes_binary_np is not None:
        raise AssertionError("a column view made the (N, A) host matrix")
    for view in (band_go._nes_column, band_go._nes_binary_column):
        try:
            view(a)
        except IndexError:
            continue
        raise AssertionError("an out-of-range column did not raise")
    return dict(mixture_err=err, columns=len(cols), columns_s=columns_s)


def run_profiled_stages(device, sf, log_dir):
    """Phase 15 (d): one steady Example_1 run as its two stages under
    StageTimer (``sync=`` a device tensor) inside ``trace()``: the launch
    counter's 32/64/32, and the Chrome trace's events of each kernel."""
    from safepy_tpu_torch.profiling import StageTimer, trace

    timer = StageTimer()
    anchor = sf._node2attribute_device()
    nb = -(-sf._num_nodes // BLOCK)
    sf.define_neighborhoods()  # warm: the stages' first call
    reset_launches()
    with trace(log_dir) as prof:
        with timer.stage("define_neighborhoods", sync=anchor):
            sf.define_neighborhoods()
        with timer.stage("compute_pvalues", sync=anchor):
            sf.compute_pvalues(num_permutations=N_PERM)
    launches = launch_counts()
    check_launches(device, launches, close_diag=nb, relax_panel=2 * nb,
                   relax_window_sym=nb)
    path = prof.trace_path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if str(e.get("cat", "")).lower() == "kernel"]
    counted = {k: sum(k in e.get("name", "") for e in kernels)
               for k in ("relax_window_sym", "relax_panel", "close_diag")}
    if device.type == "cuda" and not all(counted.values()):
        raise AssertionError(f"the trace names no kernel of {counted}")
    return dict(stages=dict(timer.stages), launches=launches,
                trace_events=counted, trace_mb=os.path.getsize(path) / 1e6,
                report=timer.report())


def synthetic_ontology(keys, seed=SEED_MAKE_GO):
    """A seeded OBO and GAF at the GO biological-process branch's size: a
    DAG of MAKE_GO_BP terms in MAKE_GO_DEPTH levels under one root (one to
    three parents a term, on the levels above), other-namespace and
    obsolete terms (never a parent), ``MAKE_GO_PER_LOCUS`` direct
    annotations a locus on average (some to other-namespace and obsolete
    terms), a few loci with none. Returns (obo text, gaf text, the BP
    parents by term, the direct annotations by locus)."""
    rng = np.random.default_rng(seed)
    bp = MAKE_GO_BP
    level = np.concatenate([[0], 1 + (np.arange(bp - 1) * (MAKE_GO_DEPTH - 1)
                                      // (bp - 1))])
    ids = [f"GO:{i:07d}" for i in range(bp + MAKE_GO_OTHER
                                        + MAKE_GO_OBSOLETE)]
    parents = {}
    lines = ["format-version: 1.2", ""]
    for i in range(bp):
        above = np.flatnonzero(level < level[i])
        ps = (sorted(set(rng.choice(above, rng.integers(1, 4)).tolist()))
              if level[i] else [])
        parents[ids[i]] = [ids[p] for p in ps]
        lines += ["[Term]", f"id: {ids[i]}", f"name: process {i}",
                  "namespace: biological_process"]
        lines += [f"is_a: {ids[p]} ! process {p}" for p in ps] + [""]
    for i in range(bp, bp + MAKE_GO_OTHER):
        lines += ["[Term]", f"id: {ids[i]}", f"name: component {i}",
                  "namespace: cellular_component", ""]
    for i in range(bp + MAKE_GO_OTHER, len(ids)):
        lines += ["[Term]", f"id: {ids[i]}", f"name: obsolete process {i}",
                  "namespace: biological_process",
                  f"is_a: {ids[int(rng.integers(bp))]} ! process", ""]
    lines += ["[Typedef]", "id: part_of", "name: part of"]
    gaf = ["!gaf-version: 2.1"]
    direct = {}
    orphans = set(rng.choice(len(keys), MAKE_GO_ORPHANS, replace=False)
                  .tolist())
    for g, key in enumerate(keys):
        if g in orphans:
            terms = rng.integers(bp, len(ids), 2)  # none in the branch
        else:
            terms = rng.integers(0, len(ids), rng.integers(
                1, 2 * MAKE_GO_PER_LOCUS))
        direct[key] = [ids[t] for t in terms]
        gaf += [f"SGD\t{key}\t{key}\t\t{ids[t]}\tREF\tIEA\t\tP\t\t\t"
                "protein\ttaxon:4932\t20200101\tSGD" for t in terms]
    return "\n".join(lines) + "\n", "\n".join(gaf) + "\n", parents, direct


def plain_go_matrix(parents, direct):
    """The propagated locus x term matrix by depth-first search up the
    parents, empty terms dropped, orphan loci on the root."""
    loci, terms = sorted(direct), sorted(parents)
    col = {t: i for i, t in enumerate(terms)}
    m = np.zeros((len(loci), len(terms)), np.int64)
    memo = {}

    def up(t):
        if t not in memo:
            seen, stack = {t}, [t]
            while stack:
                for p in parents[stack.pop()]:
                    if p not in seen:
                        seen.add(p)
                        stack.append(p)
            memo[t] = [col[x] for x in seen]
        return memo[t]

    for r, locus in enumerate(loci):
        for t in direct[locus]:
            if t in parents:
                m[r, up(t)] = 1
    keep = m.sum(axis=0) > 0
    m, kept = m[:, keep], [t for t, k in zip(terms, keep) if k]
    root = next(t for t in parents if not parents[t])
    m[m.sum(axis=1) == 0, kept.index(root)] = 1
    return m, loci, kept


def run_make_go(device, sf, tmp):
    """Phase 15 (e): make_go on a seeded ontology of the GO branch's size
    against the depth-first closure, then its TSV through load_attributes
    into phase 4's session and compute_pvalues (hypergeometric), which
    launches no kernel."""
    from safepy_tpu_torch.utils import make_go

    keys = gene_keys(sf._num_nodes)
    t0 = time.perf_counter()
    obo_text, gaf_text, parents, direct = synthetic_ontology(keys)
    obo, gaf = os.path.join(tmp, "go.obo"), os.path.join(tmp, "sgd.gaf")
    with open(obo, "w") as f:
        f.write(obo_text)
    with open(gaf, "w") as f:
        f.write(gaf_text)
    out = dict(inputs_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    go = make_go.get_go_graph(obo)
    annotations = make_go.read_annotations(gaf)
    out["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    matrix = make_go.make_go_matrix(path_to_obo=obo, path_to_annotations=gaf)
    out["wall_s"] = time.perf_counter() - t0
    tsv = os.path.join(tmp, "go_p_matrix.txt")
    t0 = time.perf_counter()
    make_go.write_matrix_tsv(tsv, matrix)
    out["write_s"] = time.perf_counter() - t0
    want, loci, terms = plain_go_matrix(parents, direct)
    if not (matrix.index == loci and matrix.columns == terms
            and bitwise(matrix.values, want)):
        raise AssertionError("make_go's matrix differs from the depth-first "
                             "closure")
    out.update(terms=len(go["go_graph"]), rows=len(annotations[1]),
               shape=matrix.values.shape, tsv_mb=os.path.getsize(tsv) / 1e6)
    sf.graph.nodes[sf.node_key_attribute] = keys
    t0 = time.perf_counter()
    sf.load_attributes(attribute_file=tsv)
    out["load_s"] = time.perf_counter() - t0
    if not np.array_equal(sf.node2attribute, matrix.values):
        raise AssertionError("the TSV loaded into the session differs")
    reset_launches()
    out["pvalues_s"] = timed_s(device, sf.compute_pvalues)
    out["launches"] = launch_counts()
    check_launches(device, out["launches"])
    out.update(engine=sf._hypergeom_engine_used,
               enriched=int(np.sum(sf.attributes["num_neighborhoods_enriched"])))
    return out


def run_host_extras(device, example1, domains, band_go):
    """Phase 15 (a)-(f) on the sessions of phases 4, 11 and 12."""
    import importlib.util

    t_phase = time.perf_counter()
    sessions = {"example1": (example1, False), "domains": (domains, False),
                "band_go": (band_go, True)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["saves"] = run_saves(device, sessions, tmp)
        out["saves_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["checkpoints"], out["resume_launches"] = run_checkpoints(
            device, sessions, tmp)
        out["checkpoints_s"] = time.perf_counter() - t0
        out["plot"] = run_plot_data(domains, band_go)
        drop_host_views(band_go)
        out["profile"] = run_profiled_stages(device, example1,
                                             os.path.join(tmp, "trace"))
        t0 = time.perf_counter()
        out["make_go"] = run_make_go(device, example1, tmp)
        out["make_go_s"] = time.perf_counter() - t0
    spec = importlib.util.spec_from_file_location(
        "cuda_validate", os.path.join(REPO, "tools", "cuda_validate.py"))
    validate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(validate)
    t0 = time.perf_counter()
    if validate.validate(device.type) != "VERIFY OK":
        raise AssertionError("tools/cuda_validate.py did not verify")
    out["validate_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 16: the memory planner on phase 12's band GO session
# ---------------------------------------------------------------------------

PLAN_PHASES = ("prep", "relax", "census")


def _cold(sf):
    """Drop the session's device results and caches (the f32 upload, the
    operands), so that the next run builds everything again."""
    sf._release_device_results()
    sf._band_operands_cache = None
    sf._n2a_dev = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _planned_run(device, sf, cap=None):
    """One cold band GO run with the allocator sampled at each phase end
    (``hbm.record_peak``): (wall s, {phase: (modeled, measured allocated
    rise, measured reserved rise)}), the rises counted from the run's
    start. ``cap``: bytes the run may reserve beyond what the process
    holds at its start and cannot give back (reserved less
    ``hbm.releasable_cache_bytes``), as if ``device_hbm_budget()`` read
    exactly ``cap`` (``torch.cuda.set_per_process_memory_fraction``, lifted
    after the run); the allocator releases its free segments and retries
    before it raises ``torch.OutOfMemoryError``."""
    _cold(sf)
    hbm.HBM_TRACE.clear()
    start = hbm.record_peak("start", device)
    capped = cap is not None and device.type == "cuda"
    if capped:
        total = torch.cuda.get_device_properties(device).total_memory
        held = (torch.cuda.memory_reserved(device)
                - hbm.releasable_cache_bytes(device))
        torch.cuda.set_per_process_memory_fraction((held + cap) / total,
                                                   device)
    t0 = time.perf_counter()
    try:
        sf.run_pipeline()
        sync(device)
    finally:
        if capped:
            torch.cuda.set_per_process_memory_fraction(1.0, device)
    wall = time.perf_counter() - t0
    trace = {r["tag"]: r for r in hbm.HBM_TRACE}
    plan = sf._hbm_plan_last
    modeled = dict(prep=plan["prep_peak"], relax=plan["relax_peak"],
                   census=plan["census_final"]["census_peak"])
    peaks = {}
    for ph in PLAN_PHASES:
        rec = trace[ph]
        if rec.get("unavailable"):
            peaks[ph] = (modeled[ph], None, None)
        else:
            peaks[ph] = (modeled[ph],
                         rec["peak_allocated"] - start["allocated"],
                         rec["peak_reserved"] - start["reserved"])
    return wall, peaks


def _results(sf):
    """The band GO run's (log sf, indicator, enriched counts)."""
    return (sf._logsf_dev, sf._nes_binary_dev,
            np.asarray(sf.attributes["num_neighborhoods_enriched"]))


def run_planner(device, sf, mat):
    """Phase 16: ``hbm.py`` on phase 12's band GO session ``sf`` (the
    ``table-band`` session, 49,920 x 4,373) and its matrix ``mat``; the
    checks and numbers of the module doc."""
    t_phase = time.perf_counter()
    old_trace = os.environ.get("SAFEPY_TPU_HBM_TRACE")
    os.environ["SAFEPY_TPU_HBM_TRACE"] = "1"
    cuda = device.type == "cuda"
    out = dict(budget=hbm.device_hbm_budget(device), runs={})
    over = []  # (what, measured, modeled) above the model: raised at the end
    try:
        res = {}
        nb = -(-sf._neighborhoods_dev.n // BLOCK)
        for store in ("device", "f16", "host"):
            sf.logsf_store, sf.hbm_budget_bytes = store, None
            reset_launches()
            wall, peaks = _planned_run(device, sf)
            launches = launch_counts()
            check_launches(device, launches, sf._hypergeom_engine_used,
                           close_diag=nb, relax_panel=nb, relax_skew_sym=nb)
            if sf._hypergeom_engine_used != "table-band":
                raise AssertionError(f"{store}: {sf._hypergeom_engine_used}")
            if sf._hbm_plan_last["logsf_out"] != store:
                raise AssertionError(f"{store}: the plan took "
                                     f"{sf._hbm_plan_last['logsf_out']}")
            over += [(f"{store} {ph}", alloc, model)
                     for ph, (model, alloc, _) in peaks.items()
                     if alloc is not None and alloc > model]
            res[store] = _results(sf)
            out["runs"][store] = dict(wall_s=wall, peaks=peaks,
                                      launches=launches,
                                      plan=dict(sf._hbm_plan_last))
        (ld, bd, cd), (lf, bf, cf), (lh, bh, ch) = (
            res[s] for s in ("device", "f16", "host"))
        if not (ld.dtype == torch.float32 and lf.dtype == torch.float16
                and lh.device.type == "cpu"):
            raise AssertionError("the residencies' dtypes or devices")
        if not torch.equal(lh, ld.cpu()):
            raise AssertionError("'host' log sf differs from 'device'")
        if not torch.equal(lf, ld.half()):
            raise AssertionError("'f16' log sf is not 'device' rounded")
        if not (torch.equal(bf, bd) and torch.equal(bh.to(bd.device), bd)
                and np.array_equal(cf, cd) and np.array_equal(ch, cd)):
            raise AssertionError("the residencies' indicators or counts")

        # each residency again, the process capped at what it holds plus
        # the plan's largest phase peak: the model's admission must hold
        # with the allocator's segments and cache, not only its tensors
        out["capped"] = {}
        for store in ("device", "f16", "host"):
            cap = max(m for m, _, _ in out["runs"][store]["peaks"].values())
            sf.logsf_store, sf.hbm_budget_bytes = store, None
            wall, peaks = _planned_run(device, sf, cap=cap)
            lc, bc, cc = _results(sf)
            if not (torch.equal(lc, res[store][0])
                    and torch.equal(bc.to(bd.device), bd)
                    and np.array_equal(cc, cd)):
                raise AssertionError(f"{store}: the capped run differs from "
                                     "the uncapped one")
            out["capped"][store] = dict(cap=cap, wall_s=wall, peaks=peaks)

        # 'auto' under set budgets: between the modeled device and f16
        # census peaks f16, between f16 and host host
        census = {s: out["runs"][s]["peaks"]["census"][0]
                  for s in ("device", "f16", "host")}
        out["auto"] = {}
        for want, hi, lo in (("f16", "device", "f16"),
                             ("host", "f16", "host")):
            budget = (census[hi] + census[lo]) // 2
            sf.logsf_store, sf.hbm_budget_bytes = "auto", budget
            t0 = time.perf_counter()
            sf.run_pipeline()
            sync(device)
            got = sf._hbm_plan_last["logsf_out"]
            if got != want:
                raise AssertionError(f"'auto' at {budget} B took {got}, "
                                     f"{want} expected")
            lg, bg_, cg = _results(sf)
            if not (torch.equal(lg, res[want][0])
                    and torch.equal(bg_.to(bd.device), bd)
                    and np.array_equal(cg, cd)):
                raise AssertionError(f"'auto' ({want}) differs from the "
                                     "forced run")
            out["auto"][want] = dict(budget=budget,
                                     wall_s=time.perf_counter() - t0)

        # a budget below every mode: the ValueError before any allocation
        # or launch (the previous results held here, so that the run's
        # release of them frees nothing)
        order = np.argsort(sf._neighborhoods_dev.rank)
        held = (sf._neighborhoods_dev, sf._logsf_dev, sf._nes_binary_dev,
                sf._nes_dev, sf._node_distances_dev)
        sf.logsf_store, sf.hbm_budget_bytes = "auto", 10 ** 8
        sync(device)
        before = torch.cuda.memory_allocated(device) if cuda else None
        launches = launch_counts()
        try:
            sf.run_pipeline()
        except ValueError as e:
            out["refusal"] = str(e)
        else:
            raise AssertionError("a budget below every mode was admitted")
        sync(device)
        if cuda and torch.cuda.memory_allocated(device) != before:
            raise AssertionError("the refused run allocated")
        if launch_counts() != launches:
            raise AssertionError("the refused run launched a kernel")
        del held
        sf.logsf_store, sf.hbm_budget_bytes = "auto", None

        # the chunked prep against the device prep, each with its measured
        # peak beside the modeled one
        n, a = mat.shape
        _cold(sf)

        def prep(chunked):
            if cuda:
                sync(device)
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            if chunked:
                got = eb.band_hyper_operands_chunked(mat, order,
                                                     device=device)
            else:
                up = torch.as_tensor(np.asarray(mat, np.float32),
                                     device=device)
                got = eb.band_hyper_operands_device(up, order)
                del up
            sync(device)
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(device) - base
                    if cuda else None)
            return got, wall, peak

        full, full_s, full_peak = prep(False)
        chunk, chunk_s, chunk_peak = prep(True)
        for i in (0, 1, 2):
            if not torch.equal(full[i], chunk[i]):
                raise AssertionError(f"chunked prep output {i} differs")
        if full[3] is not True or chunk[3] is not True:
            raise AssertionError("the binary flag")
        out["prep"] = dict(
            device_s=full_s, chunked_s=chunk_s,
            device_peak=(hbm.prep_peak(n, a, chunked=False), full_peak),
            chunked_peak=(hbm.prep_peak(n, a, chunked=True), chunk_peak))
        for name in ("device_peak", "chunked_peak"):
            model, got = out["prep"][name]
            if got is not None and got > model:
                over.append((name, got, model))
        del full, chunk
        _cold(sf)
    finally:
        if old_trace is None:
            os.environ.pop("SAFEPY_TPU_HBM_TRACE", None)
        else:
            os.environ["SAFEPY_TPU_HBM_TRACE"] = old_trace
    if over:
        raise AssertionError(f"measured peaks above the model (what, "
                             f"measured B, modeled B): {over}; {out}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 17: the dense engines on a mesh at the Example_1 width
# ---------------------------------------------------------------------------

MESH_FW_PATHS = ("data", "row_col")  # the meshes that shard the FW


def nbr_digest(t) -> str:
    return band_digest(t.to(torch.int8))


def _mesh_work(device, mesh, tag, net, vals, go, steady=3):
    """What each rank of ``mesh`` runs in phase 17: on a mesh that shards
    the FW, the sharded FW alone (launches, digest, min of ``steady``)
    and the fused quantitative run (phase 4's inputs; 999 permutations on
    a 'perm' mesh, which round up); on an 'attr' mesh the fused binary run
    of GO matrix A and the sharded census. Returns the numbers and
    digests, prefixed with ``tag``."""
    coords, edges, lengths, _ = net
    n = len(coords)
    out = {}

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return time.perf_counter() - t0

    if tag in MESH_FW_PATHS:
        d0 = initial_distances_device(n, edges, lengths, device=device)
        fw = (apsp_sharded if tag == "data" else apsp_sharded_2d)
        reset_launches()
        dist_m = fw(d0, mesh)
        sync(device)
        out[f"{tag}_fw_launches"] = json.dumps(launch_counts())
        out[f"{tag}_fw_digest"] = band_digest(dist_m)
        del dist_m
        out[f"{tag}_fw_s"] = min(timed(lambda: fw(d0, mesh))
                                 for _ in range(steady))
    if tag == "attr":
        sf = SAFE(device=device, verbose=False)
        sf.mesh = mesh
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=go)
        reset_launches()
        out[f"{tag}_warm_s"] = timed(sf.run_pipeline)
        out[f"{tag}_launches"] = json.dumps(launch_counts())
        out[f"{tag}_engine"] = (f"{sf.apsp_engine_used}/"
                                f"{sf._hypergeom_engine_used}")
        out[f"{tag}_logsf"] = band_digest(sf._logsf_dev)
        out[f"{tag}_nbin"] = band_digest(sf._nes_binary_dev)
        out[f"{tag}_enriched"] = np.asarray(
            sf.attributes["num_neighborhoods_enriched"])
        out[f"{tag}_nbr"] = nbr_digest(sf._neighborhoods_dev)
        counts, _ = hypergeom_counts_sharded(sf._neighborhoods_dev, go,
                                             mesh=mesh)
        out[f"{tag}_census"] = band_digest(counts)
        del counts
    else:
        sf = SAFE(device=device, verbose=False)
        sf.random_seed = SEED_NULL
        sf.mesh = mesh
        sf.load_network(network_file=net)
        sf.load_attributes(attribute_file=vals)
        perms = 999 if tag == "perm" else N_PERM
        reset_launches()
        out[f"{tag}_warm_s"] = timed(lambda: sf.run_pipeline(
            num_permutations=perms))
        out[f"{tag}_launches"] = json.dumps(launch_counts())
        out[f"{tag}_engine"] = sf.apsp_engine_used
        out[f"{tag}_num_permutations"] = sf.num_permutations
        out[f"{tag}_nbr"] = nbr_digest(sf._neighborhoods_dev)
        out[f"{tag}_ns"] = sf.ns
        out[f"{tag}_counts_neg"] = sf.counts_neg
        out[f"{tag}_counts_pos"] = sf.counts_pos
    out[f"{tag}_steady_s"] = min(timed(sf.run_pipeline if tag == "attr"
                                       else lambda: sf.run_pipeline(
                                           num_permutations=perms))
                                 for _ in range(steady))
    return out


def _mesh_rank(rank, world, case_dir, device_type, spawned):
    """One gloo rank of phase 17 on card 0: every mesh of its world in
    turn; the results go to ``case_dir``."""
    entered = time.time()
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"file://{case_dir}/rendezvous", rank=rank,
        world_size=world)
    try:
        out = dict(entered=entered - spawned, ready=time.time() - spawned)
        d = np.load(os.path.join(case_dir, "inputs.npz"))
        net = tuple(d[k] for k in ("coords", "edges", "lengths", "weights"))
        meshes = ({"data": world}, {"perm": world}, {"attr": world}) \
            if world == 2 else ({"row": 2, "col": world // 2},)
        for axes in meshes:
            out.update(_mesh_work(device, make_mesh(
                axes, device_type=device.type), "_".join(axes), net,
                d["vals"], d["go"]))
        np.savez(os.path.join(case_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _replay(device, nbr, vals, ns, counts, world, perms):
    """Each of ``world`` ranks' seeded streams (``rank_seed``) replayed on
    one device over phase 4's neighborhoods ``nbr`` and attribute ``vals``
    and summed: the counts a sharded null must give (JAX's exact-replay
    test)."""
    n2a = torch.as_tensor(np.asarray(vals, np.float32), device=device)
    valid_rows = np.flatnonzero(np.isfinite(vals).any(axis=1))
    nv, v, m = prepare_valid(nbr, n2a,
                             torch.as_tensor(valid_rows, device=device))
    per_dev = -(-perms // world)
    batch = default_batch_size(len(valid_rows), 1, per_dev)
    obs = torch.as_tensor(ns, dtype=torch.float32, device=device)
    total = [0, 0]
    for r in range(world):
        g = torch.Generator(device=device).manual_seed(
            rank_seed(SEED_NULL, r))
        cn, cp = scan_counts(nv, v, m, obs, score_type="sum",
                             num_permutations=per_dev, batch_size=batch,
                             generator=g)
        total[0] = total[0] + cn.cpu().numpy()
        total[1] = total[1] + cp.cpu().numpy()
    return (np.array_equal(total[0], counts[0])
            and np.array_equal(total[1], counts[1])), per_dev * world


def check_mesh_kernels(device, npad=4096):
    """The kernels of the sharded FW at its shapes, each operand built as
    its rounds build it, bitwise against the plain version, with CUDA-event
    times beside the bound: {kernel: [row a shape]}.

    ``relax_full`` on the world-2 slab (2,048 x 4,096) and the 2 x 2 tile
    (2,048 x 2,048); ``relax_panel``'s pivot rows (128 x npad on a 'data'
    axis, 128 x npad/2 on the 2 x 2 mesh) and pivot columns (a column view
    of the world-1 and world-2 slabs, whose row stride is npad, and the
    2 x 2 mesh's reduced, contiguous panel); ``close_diag`` on a pivot tile
    viewed in the row panel (row stride npad) and on the 2 x 2 mesh's
    reduced tile."""
    gen = torch.Generator(device=device).manual_seed(17)
    b, half = BLOCK, npad // 2
    out = {"relax_full": [], "relax_panel": [], "close_diag": []}

    def row(kernel, shape, form, fn, plain, work, got, want):
        err = max_abs_err(got, want)
        b_ms, b_by = bound(*work)
        out[kernel].append(dict(
            shape=shape, form=form, ms=time_ms(fn, device),
            plain_ms=time_ms(plain, device, inner=1, reps=3),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            device_ms=(device_ms_max(fn, f"{kernel}_kernel")
                       if device.type == "cuda" else None)))

    for m, n in ((half, npad), (half, half)):
        q = inf_laced(gen, (m, b), device)
        p = inf_laced(gen, (b, n), device)
        d = inf_laced(gen, (m, n), device)
        got, want = d.clone(), d.clone()
        K.relax_full(q, p, got)
        K.relax_full_plain(q, p, want)
        work = d.clone()
        row("relax_full", [m, n, b], "slab" if n == npad else "tile",
            lambda: K.relax_full(q, p, work),
            lambda: K.relax_full_plain(q, p, work), relax_work(m, n, b),
            got, want)

    # the pivot tiles: a view at column offset half of a (128, npad)
    # panel (the 'data' rounds), and a contiguous reduced tile (2 x 2)
    panel = inf_laced(gen, (b, npad), device)
    panel[:, half:half + b].diagonal().zero_()
    tile = inf_laced(gen, (b, b), device)
    tile.diagonal().zero_()
    diags = {}
    for form, t in (("view_of_128x4096", panel[:, half:half + b]),
                    ("reduced_tile", tile)):
        diags[form] = K.close_diag_plain(t)
        row("close_diag", [b, b], form, lambda: K.close_diag(t),
            lambda: K.close_diag_plain(t), (b ** 3, 2 * b * b * F32),
            K.close_diag(t), diags[form])

    # pivot rows min(P, diag (x) P), pivot columns min(Q, Q (x) diag)
    p2 = inf_laced(gen, (b, half), device)
    slab1 = inf_laced(gen, (npad, npad), device)
    slab2 = inf_laced(gen, (half, npad), device)
    q2 = inf_laced(gen, (half, b), device)
    diag = diags["view_of_128x4096"]
    for form, p in (("rows_data", panel), ("rows_2x2", p2)):
        row("relax_panel", [b, p.shape[1], b], form,
            lambda: K.relax_panel(p, diag, p),
            lambda: K.relax_panel_plain(p, diag, p),
            relax_work(b, p.shape[1], b), K.relax_panel(p, diag, p),
            K.relax_panel_plain(p, diag, p))
    for form, q in (("cols_world1_view", slab1[:, half:half + b]),
                    ("cols_world2_view", slab2[:, half:half + b]),
                    ("cols_2x2", q2)):
        row("relax_panel", [q.shape[0], b, b], form,
            lambda: K.relax_panel(q, q, diag),
            lambda: K.relax_panel_plain(q, q, diag),
            relax_work(q.shape[0], b, b), K.relax_panel(q, q, diag),
            K.relax_panel_plain(q, q, diag))
    return out


def run_dense_mesh(device, ref, net, vals, go_a, go_ref):
    """Phase 17: the dense engines on a mesh at the Example_1 width; the
    checks and numbers of the module doc. ``ref``: phase 4's session (its
    neighborhoods; phase 15 loads other attributes into it); ``vals``:
    phase 4's attribute; ``go_a``: GO matrix A; ``go_ref``: digests of
    phase 10's single-device run of A."""
    t_phase = time.perf_counter()
    coords, edges, lengths, _ = net
    n = len(coords)
    nb = -(-n // BLOCK)
    d0 = initial_distances_device(n, edges, lengths, device=device)
    classic = band_digest(ops.apsp(d0))
    del d0
    ref_dev = ref._neighborhoods_device()
    ref_nbr = nbr_digest(ref_dev)
    fw_counts = dict(close_diag=nb, relax_panel=2 * nb, relax_full=nb)
    out = dict(kernels=check_mesh_kernels(device), runs={})
    census = band_digest(ref_dev.to(torch.float32)
                         @ torch.as_tensor(np.nan_to_num(go_a),
                                           dtype=torch.float32,
                                           device=device))

    def check(tag, r, world):
        """Every check of one rank's results on mesh ``tag``."""
        if tag in MESH_FW_PATHS:
            if str(r[f"{tag}_fw_digest"]) != classic:
                raise AssertionError(f"{tag}: the sharded FW differs from "
                                     "the classic FW")
            for key in ("fw_launches", "launches"):
                check_launches(device, json.loads(str(r[f"{tag}_{key}"])),
                               **fw_counts)
        if str(r[f"{tag}_nbr"]) != ref_nbr:
            raise AssertionError(f"{tag}: neighborhoods differ from phase "
                                 "4's")
        if tag == "attr":
            if not (str(r["attr_logsf"]) == go_ref["logsf"]
                    and str(r["attr_nbin"]) == go_ref["nbin"]
                    and np.array_equal(r["attr_enriched"],
                                       go_ref["enriched"])
                    and str(r["attr_census"]) == census):
                raise AssertionError("attr: the census or the log sf "
                                     "differs from phase 10's run of A")
            return
        perms = 999 if tag == "perm" else N_PERM
        ok, total = _replay(device, ref_dev, vals, r[f"{tag}_ns"],
                            (r[f"{tag}_counts_neg"], r[f"{tag}_counts_pos"]),
                            world, perms)
        if not ok:
            raise AssertionError(f"{tag}: the counts are not the ranks' "
                                 "streams replayed")
        if int(r[f"{tag}_num_permutations"]) != total:
            raise AssertionError(f"{tag}: num_permutations "
                                 f"{r[f'{tag}_num_permutations']}, {total} "
                                 "expected")

    # world 1 over NCCL in this process
    rdv = native.BUILD_DIR / "chip_smoke_mesh1_rendezvous"
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.time()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        ready = time.time() - t0
        w1 = _mesh_work(device, make_mesh({"data": 1},
                                          device_type=device.type),
                        "data", net, vals, go_a)
    finally:
        dist.destroy_process_group()
    check("data", w1, 1)
    out["runs"]["world1"] = dict(w1, ready=ready)

    # worlds 2 and 4 over gloo, every rank on this card
    case_dir = native.BUILD_DIR / "chip_smoke_mesh"
    for world in (2, 4):
        shutil.rmtree(case_dir, ignore_errors=True)
        case_dir.mkdir(parents=True)
        np.savez(case_dir / "inputs.npz", coords=coords, edges=edges,
                 lengths=lengths, weights=net[3], vals=vals, go=go_a)
        t0 = time.time()
        mp.spawn(_mesh_rank, args=(world, str(case_dir), device.type, t0),
                 nprocs=world, join=True)
        wall = time.time() - t0
        ranks = [dict(np.load(case_dir / f"rank{r}.npz"))
                 for r in range(world)]
        tags = ("data", "perm", "attr") if world == 2 else ("row_col",)
        for r in ranks:
            for tag in tags:
                check(tag, r, world)
        out["runs"][f"world{world}"] = dict(spawn_s=wall, ranks=ranks)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def mesh_summary(runs, world, tags, key):
    """Per rank, ``key`` of each mesh of a world (seconds rounded to
    0.1 ms, for the printed lines)."""
    rs = runs[f"world{world}"]["ranks"] if world > 1 else [runs["world1"]]
    return {tag: [round(float(r[f"{tag}_{key}"]), 4) for r in rs]
            for tag in tags if f"{tag}_{key}" in rs[0]}


def mesh_launches(ms):
    """Phase 17's facade runs' launches, by path name."""
    out = {"mesh_data_world1": json.loads(ms["runs"]["world1"][
        "data_launches"])}
    for world, tags in ((2, ("data", "perm", "attr")), (4, ("row_col",))):
        for r, rank in enumerate(ms["runs"][f"world{world}"]["ranks"]):
            for tag in tags:
                out[f"mesh_{tag}_world{world}_rank{r}"] = json.loads(
                    str(rank[f"{tag}_launches"]))
    return out


# ------------------------------------------------------------------ phase 18

SEED_EUCLID_MESH = SEED_EUCLID + 3  # phase 18's 49,920 scatter points
# phase 18's capped world-2 band GO run: its hbm_budget_bytes, above the
# per-rank plan at world 2 and below that plan as it stood while every rank
# assembled the bands, outputs and operands on its card (4.555 GB at
# 49,920 x 4,373, PERF.md section 5), which refused such a budget
CAPPED_BUDGET = 3_000_000_000
ASSEMBLED_WORLD2_PLAN = 4_555_000_000


def check_band_row_cuts(device, nb, bt, world=2):
    """``relax_band_rows`` at each window cut the world-``world`` ranks
    launch (phase 6's geometry), bitwise against its plain version, with
    its device time (profiler), per-call time (CUDA events), the plain
    version's time and its bound; and each rank's B3 device time over the
    FW's rounds, summed from them."""
    gen = torch.Generator(device=device).manual_seed(18)
    b, nt = BLOCK, 2 * bt + 1
    w = nt * b
    p_ext = inf_laced(gen, (b, w + 2 * bt * b), device)
    cuts = window_cuts(nb, bt, world)
    rows_out = {}
    for lo, hi in sorted({c for r in cuts for c in r}):
        slab = inf_laced(gen, ((hi - lo + 2) * b, w), device)
        got, want = slab.clone(), slab.clone()
        K.relax_band_rows(got[b:-b], p_ext, lo, hi)
        K.relax_band_rows_plain(want[b:-b], p_ext, lo, hi)
        err = max_abs_err(got, want)
        rows = got[b:-b]
        k = hi - lo
        b_ms, b_by = bound(k * b * w * b, (2 * k * b * w + b * w) * F32)
        rows_out[f"{lo}-{hi}"] = dict(
            rows=k, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            ms=time_ms(lambda: K.relax_band_rows(rows, p_ext, lo, hi),
                       device),
            plain_ms=time_ms(
                lambda: K.relax_band_rows_plain(rows, p_ext, lo, hi), device,
                inner=1, reps=3),
            device_ms=(device_ms_max(
                lambda: K.relax_band_rows(rows, p_ext, lo, hi),
                "relax_band_row_kernel") if device.type == "cuda" else None))
    per_rank = []
    for r in cuts:
        dev = [rows_out[f"{lo}-{hi}"]["device_ms"] for lo, hi in r]
        per_rank.append(None if None in dev else sum(
            rows_out[f"{lo}-{hi}"]["device_ms"] * c
            for (lo, hi), c in r.items()))
    return dict(cuts=rows_out, launches=window_rounds(nb, bt, world),
                rank_device_ms=per_rank)


def _band_go_session(device, ref, mat, mesh=None, **settings):
    """Phase 12's band GO session (``ref``'s settings and network, the GO
    matrix ``mat``), on ``mesh`` when given."""
    sf = SAFE(device=device, verbose=False)
    for k in ("apsp_mode", "keep_node_distances", "neighborhood_radius"):
        setattr(sf, k, ref[k])
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.mesh = mesh
    sf.load_network(network_file=ref["net"])
    sf.load_attributes(attribute_file=mat)
    return sf


def _mesh_band_go(device, sf, engine, steady):
    """One sharded band GO engine: the warm run's launches and allocated
    rise (beside the per-rank plan, which it must not exceed, for the
    planned class table), then ``steady`` more runs. Returns the numbers
    and the digests the checks compare."""
    base = peak_reset(device)
    reset_launches()
    warm = timed_s(device, sf.run_pipeline)
    out = dict(launches=json.dumps(launch_counts()), warm_s=warm,
               engine=f"{sf._hypergeom_engine_used}/{sf._band_relax_used}")
    if sf._hypergeom_engine_used != engine or sf._band_relax_used != "fw":
        raise AssertionError(f"{out['engine']} taken, {engine} expected")
    if base is not None:
        out["rise"] = torch.cuda.max_memory_allocated(device) - base
    if engine == "table-band-sharded":
        plan = sf._hbm_plan_last
        out["plan_peak"] = plan["per_rank_peak"]
        out["plan_shard_peak"] = plan["per_shard_peak"]
        out["plan_host"] = (plan["host_outputs"] + plan["host_bands"]
                            + plan["host_operands"])
        out["plan_transients"] = (plan["stage_buffer"]
                                  + plan["ghost_operands"]
                                  + plan["prep_chunk"])
        results = (sf._logsf_dev, sf._nes_binary_dev,
                   sf._neighborhoods_dev.data)
        if any(t.device.type != "cpu" for t in results):
            raise AssertionError(f"{engine}: the stored results are not in "
                                 "host memory")
        if base is not None and out["rise"] > plan["per_rank_peak"]:
            raise AssertionError(
                f"{engine}: allocated rise {out['rise']} B above the "
                f"per-rank plan's {plan['per_rank_peak']} B")
    out["steady_s"] = [timed_s(device, sf.run_pipeline)
                       for _ in range(steady)]
    out.update(band=band_digest(sf._neighborhoods_dev.data),
               nbin=band_digest(sf._nes_binary_dev),
               logsf=band_digest(sf._logsf_dev),
               enriched=np.asarray(
                   sf.attributes["num_neighborhoods_enriched"]))
    if engine == "loop-band-sharded":
        out["logsf_rows"] = logsf_rows(sf._logsf_dev)
    return out


def _check_band_go(tag, r, go_ref, engine):
    """A mesh band GO run against phase 12: the indicator band,
    nes_binary and the counts equal to its table-band run's, the class
    table's log sf too; the tail loop's log sf within 4 f32 ulps of its
    hostchunks-band run's (the f64 tail) on every ``LOGSF_ROW_STRIDE``-th
    row, the largest gap kept in ``r["logsf_ulps"]``."""
    if str(r["band"]) != go_ref["band"]:
        raise AssertionError(f"{tag}: the indicator band differs from "
                             "phase 12's")
    if not (str(r["nbin"]) == go_ref["nbin"]
            and np.array_equal(r["enriched"], go_ref["enriched"])):
        raise AssertionError(f"{tag}: nes_binary or the counts differ from "
                             "phase 12's table-band run")
    if engine == "table-band-sharded" and str(r["logsf"]) != go_ref["logsf"]:
        raise AssertionError(f"{tag}: the log sf differs from phase 12's")
    if engine == "loop-band-sharded":
        got = r.pop("logsf_rows")
        if got.shape != go_ref["loop_logsf"].shape:
            raise AssertionError(f"{tag}: log sf rows {got.shape}, phase "
                                 f"12's {go_ref['loop_logsf'].shape}")
        r["logsf_ulps"] = f32_ulps_np(got, go_ref["loop_logsf"])
        if not r["logsf_ulps"] <= 4:
            raise AssertionError(f"{tag}: the log sf is {r['logsf_ulps']} "
                                 "f32 ulps from phase 12's hostchunks-band")


def _mesh_quant(device, sf, perms):
    """One run of a quantitative session on the mesh: wall, launches, the
    band's digest, scores and counts."""
    reset_launches()
    wall = timed_s(device, lambda: sf.run_pipeline(num_permutations=perms))
    data = sf._neighborhoods_dev.data
    if sf.apsp_engine_used != "band-storage" or data.dtype != torch.uint8:
        raise AssertionError(f"the packed band was not taken: "
                             f"{sf.apsp_engine_used}, {data.dtype}")
    return dict(wall_s=wall, launches=json.dumps(launch_counts()),
                band=band_digest(data), ns=sf.ns, counts_neg=sf.counts_neg,
                counts_pos=sf.counts_pos)


def _check_quant(tag, r, want, exact):
    """The band bytes equal, the scores within 1e-5, the counts exactly
    (``exact``) or within near-tie flips (phase 8's rule: the rows are
    contracted in other groups); returns the count difference."""
    if str(r["band"]) != want["band"]:
        raise AssertionError(f"{tag}: the band's bytes differ")
    if not np.allclose(r["ns"], want["ns"], rtol=1e-5, atol=1e-5,
                       equal_nan=True):
        raise AssertionError(f"{tag}: the scores differ beyond 1e-5")
    delta = int(np.abs(r["counts_neg"] - want["counts_neg"]).sum()
                + np.abs(r["counts_pos"] - want["counts_pos"]).sum())
    if delta > (0 if exact else 1e-5 * want["ns"].size * N_PERM):
        raise AssertionError(f"{tag}: the counts differ by {delta}")
    return delta


def _band_mesh_work(device, mesh, world, ref, go_mat, euclid, steady):
    """What each rank runs in phase 18 on a ``data`` mesh of ``world``
    ranks: band GO by both engines (at world 2 the class table also under
    ``hbm_budget_bytes=CAPPED_BUDGET``), the packed band of phase 6's
    attribute; at world 1 the packed euclidean band at 1 M points, at
    world 2 at 49,920."""
    out = {}
    runs = [("table-band-sharded", "table-band-sharded", {}, steady),
            ("loop-band-sharded", "loop-band-sharded",
             dict(hypergeom_engine="loop"), 0)]
    if world == 2:  # a budget the per-rank plan must now admit
        runs.append(("capped", "table-band-sharded",
                     dict(hbm_budget_bytes=CAPPED_BUDGET), 0))
    for tag, engine, settings, reps in runs:
        sf = _band_go_session(device, ref, go_mat, mesh, **settings)
        out[tag] = _mesh_band_go(device, sf, engine, reps)
        del sf
        if device.type == "cuda":
            torch.cuda.empty_cache()
    sf = SAFE(device=device, verbose=False)
    for k in ("apsp_mode", "keep_node_distances", "random_seed",
              "neighborhood_radius"):
        setattr(sf, k, ref[k])
    sf.band_indicator_bits = True
    sf.mesh = mesh
    sf.load_network(network_file=ref["net"])
    sf.load_attributes(attribute_file=ref["vals"])
    out["packed"] = _mesh_quant(device, sf, N_PERM)
    del sf
    coords, vals = euclid_points(*euclid["points"])
    sf = euclid_session(device, coords, vals, keep_node_distances=False,
                        **euclid["settings"])
    sf.mesh = mesh
    out["euclid"] = _mesh_quant(device, sf, N_PERM)
    out["euclid"]["steady_s"] = timed_s(
        device, lambda: sf.run_pipeline(num_permutations=N_PERM))
    del sf
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _band_mesh_rank(rank, world, case_dir, device_type, spawned):
    """One gloo rank of phase 18's world 2 on card 0: the band mesh work
    (phase 12's GO matrix rebuilt from its seed); results to
    ``case_dir``."""
    entered = time.time()
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the CPU rehearsal: two ranks' thread pools share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    dist.init_process_group(
        "gloo", init_method=f"file://{case_dir}/rendezvous", rank=rank,
        world_size=world)
    try:
        ready = time.time() - spawned
        with open(os.path.join(case_dir, "inputs.pkl"), "rb") as f:
            ref, euclid = pickle.load(f)
        go_mat = phase12_matrix(ref["net"][0], ref["go_attrs"])
        out = _band_mesh_work(device, make_mesh({"data": world},
                                                device_type=device.type),
                              world, ref, go_mat, euclid, steady=2)
        with open(os.path.join(case_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(dict(out, entered=entered - spawned, ready=ready), f)
    finally:
        dist.destroy_process_group()


def run_band_mesh(device, ref, go_mat, go_ref, euclid_ref, steady=3,
                  euclid_nodes=EUCLID_NODES, euclid_settings=None):
    """Phase 18: the rest of the row-sharded band engine at full width, on
    a one-rank 'data' mesh over NCCL in this process and on two gloo
    processes on the card, then ``dryrun(2, device='cuda')``; the checks
    and numbers of the module doc. ``ref``: phase 6's network, attribute,
    settings and digests (its int8 and packed bands, scores and counts);
    ``go_mat``, ``go_ref``: phase 12's GO matrix and its table-band run's
    digests; ``euclid_ref``: phase 13 (a)'s packed 1 M-point run
    (``euclid_nodes`` points, its ``euclid_settings``: the CPU rehearsal
    forces the band and the packing at small n)."""
    from safepy_tpu_torch.dryrun import dryrun

    t_phase = time.perf_counter()
    n = len(ref["net"][0])
    nb = -(-n // BLOCK)
    bt = ref["bt"]
    out = dict(band_rows=check_band_row_cuts(device, nb, bt))
    fw = dict(close_diag=nb, relax_panel=nb)
    euclid_1m = dict(points=(euclid_nodes,), settings=euclid_settings or {})

    # world 1 over NCCL in this process
    rdv = native.BUILD_DIR / "chip_smoke_bandmesh1_rendezvous"
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.time()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        ready = time.time() - t0
        w1 = _band_mesh_work(device, make_mesh({"data": 1},
                                               device_type=device.type),
                             1, ref, go_mat, euclid_1m, steady)
    finally:
        dist.destroy_process_group()
    for engine in ("table-band-sharded", "loop-band-sharded"):
        _check_band_go(f"world 1 {engine}", w1[engine], go_ref, engine)
        check_launches(device, json.loads(w1[engine]["launches"]), engine,
                       relax_band_row=nb, **fw)
    check_launches(device, json.loads(w1["packed"]["launches"]),
                   relax_band_row=nb, **fw)
    _check_quant("world 1 packed", w1["packed"], ref["packed"], exact=True)
    check_launches(device, json.loads(w1["euclid"]["launches"]))
    _check_quant("world 1 euclid 1M", w1["euclid"], euclid_ref, exact=True)
    out["world1"] = dict(w1, ready=ready)

    # the single-device packed euclidean band at 49,920 points
    euclid_2 = dict(points=(n, SEED_EUCLID_MESH),
                    settings=dict(apsp_mode="band", band_indicator_bits=True))
    coords, vals = euclid_points(*euclid_2["points"])
    sf = euclid_session(device, coords, vals, keep_node_distances=False,
                        **euclid_2["settings"])
    single = _mesh_quant(device, sf, N_PERM)
    del sf

    # world 2 over gloo, both ranks on this card
    case_dir = native.BUILD_DIR / "chip_smoke_bandmesh"
    shutil.rmtree(case_dir, ignore_errors=True)
    case_dir.mkdir(parents=True)
    with open(case_dir / "inputs.pkl", "wb") as f:
        pickle.dump((ref, euclid_2), f)
    t0 = time.time()
    mp.spawn(_band_mesh_rank, args=(2, str(case_dir), device.type, t0),
             nprocs=2, join=True)
    spawn_s = time.time() - t0
    ranks = []
    for r in range(2):
        with open(case_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    cuts = out["band_rows"]["launches"]
    deltas = []
    if not out["world1"]["table-band-sharded"]["plan_peak"] > (
            ranks[0]["table-band-sharded"]["plan_peak"]):
        raise AssertionError("the per-rank plan does not fall from world 1 "
                             "to world 2")
    for r, got in enumerate(ranks):
        for tag, engine in (("table-band-sharded", "table-band-sharded"),
                            ("loop-band-sharded", "loop-band-sharded"),
                            ("capped", "table-band-sharded")):
            _check_band_go(f"world 2 rank {r} {tag}", got[tag], go_ref,
                           engine)
            check_launches(device, json.loads(got[tag]["launches"]), engine,
                           relax_band_row=cuts[r], **fw)
        cap = got["capped"]
        if not cap["plan_peak"] <= CAPPED_BUDGET < ASSEMBLED_WORLD2_PLAN:
            raise AssertionError(
                f"world 2 rank {r}: the capped run's budget {CAPPED_BUDGET} "
                f"B is not between its plan {cap['plan_peak']} B and "
                f"{ASSEMBLED_WORLD2_PLAN} B")
        rise1 = out["world1"]["table-band-sharded"].get("rise")
        for tag in ("table-band-sharded", "capped"):
            rise2 = got[tag].get("rise")
            if rise1 is not None and not rise2 < rise1:
                raise AssertionError(
                    f"world 2 rank {r} {tag}: allocated rise {rise2} B not "
                    f"below world 1's {rise1} B")
        check_launches(device, json.loads(got["packed"]["launches"]),
                       relax_band_row=cuts[r], **fw)
        deltas.append(_check_quant(f"world 2 rank {r} packed", got["packed"],
                                   ref["packed"], exact=False))
        deltas.append(_check_quant(f"world 2 rank {r} euclid", got["euclid"],
                                   single, exact=False))
    out["world2"] = dict(spawn_s=spawn_s, ranks=ranks, count_deltas=deltas,
                         euclid_single_s=single["wall_s"])

    # the six legs of the dry run, two gloo ranks on the card
    t0 = time.perf_counter()
    legs = dryrun(2, device=device.type)
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_engines"] = [str(x) for x in legs[0]["engines"]]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def band_mesh_launches(bm):
    """Phase 18's runs' launches, by path name."""
    out = {}
    runs = [("world1", bm["world1"])] + [
        (f"world2_rank{r}", x) for r, x in enumerate(bm["world2"]["ranks"])]
    for tag, x in runs:
        for key, path in (("table-band-sharded", "band_go_table_sharded"),
                          ("loop-band-sharded", "band_go_loop_sharded"),
                          ("capped", "band_go_table_sharded_capped"),
                          ("packed", "band_packed_sharded"),
                          ("euclid", "euclid_band_packed_sharded")):
            if key in x:
                out[f"{path}_{tag}"] = json.loads(x[key]["launches"])
    return out


def print_band_mesh(bm, card):
    gb = 1e9
    cuts = bm["band_rows"]
    rows = ", ".join(
        f"rows {k} ({c['rows']}): device "
        f"{(c['device_ms'] or 0) * 1e3:.2f} us, per call "
        f"{c['ms'] * 1e3:.2f} us, plain {c['plain_ms']:.3f} ms (bound "
        f"{c['bound_ms'] * 1e3:.2f} us by {c['bound_by']})"
        for k, c in cuts["cuts"].items())
    print(f"band mesh relax_band_rows ({card}): bitwise equal to plain at "
          f"each window cut of the world-2 ranks: {rows}; launches a rank "
          f"{cuts['launches']}, B3 device time a rank over the FW "
          f"{[None if x is None else round(x, 3) for x in cuts['rank_device_ms']]}"
          f" ms", flush=True)
    w1 = bm["world1"]
    for tag, x, extra in [("world 1 (NCCL)", w1, f"process group "
                           f"{w1['ready']:.2f} s")] + [
            (f"world 2 rank {r} (gloo)", x, f"process up {x['entered']:.2f} "
             f"s, process group ready {x['ready']:.2f} s after the spawn")
            for r, x in enumerate(bm["world2"]["ranks"])]:
        t, lp = x["table-band-sharded"], x["loop-band-sharded"]
        print(f"band mesh {tag} ({card}): {extra}; table-band-sharded warm "
              f"{t['warm_s']:.4f} s, steady {[round(s, 4) for s in t['steady_s']]}"
              f" s, allocated rise {(t.get('rise') or 0) / gb:.4f} GB, per-rank "
              f"plan {t['plan_peak'] / gb:.4f} GB (JAX's per-shard terms "
              f"{t['plan_shard_peak'] / gb:.4f} GB + the port's transients "
              f"{t['plan_transients'] / gb:.4f} GB), host memory a rank "
              f"{t['plan_host'] / gb:.4f} GB, launches {t['launches']}; "
              f"loop-band-sharded warm {lp['warm_s']:.4f} s, steady "
              f"{[round(s, 4) for s in lp['steady_s']]} s, allocated rise "
              f"{(lp.get('rise') or 0) / gb:.4f} GB; packed band run "
              f"{x['packed']['wall_s']:.4f} s; packed euclidean band run "
              f"{x['euclid']['wall_s']:.4f} s, again "
              f"{x['euclid']['steady_s']:.4f} s", flush=True)
    w2 = bm["world2"]
    caps = [x["capped"] for x in w2["ranks"]]
    rise1 = bm["world1"]["table-band-sharded"].get("rise") or 0
    print(f"band mesh capped ({card}): table-band-sharded at world 2 under "
          f"hbm_budget_bytes {CAPPED_BUDGET / gb:.3f} GB (a plan that counts "
          f"the results on every rank's card: "
          f"{ASSEMBLED_WORLD2_PLAN / gb:.3f} GB): per-rank plan "
          f"{[round(c['plan_peak'] / gb, 4) for c in caps]} GB, allocated "
          f"rise {[round((c.get('rise') or 0) / gb, 4) for c in caps]} GB "
          f"(world 1's {rise1 / gb:.4f} GB), warm "
          f"{[round(c['warm_s'], 4) for c in caps]} s; phase 12's results",
          flush=True)
    print(f"band mesh checks ({card}): both band GO engines' indicator band, "
          f"nes_binary and counts equal phase 12's table-band run at world 1 "
          f"and on both world-2 ranks, the class table's log sf bitwise, the "
          f"tail loop's within 4 f32 ulps of phase 12's hostchunks-band on "
          f"every {LOGSF_ROW_STRIDE}th row (largest gap world 1 "
          f"{bm['world1']['loop-band-sharded']['logsf_ulps']}, world 2 "
          f"{[x['loop-band-sharded']['logsf_ulps'] for x in w2['ranks']]} "
          f"ulps); "
          f"every allocated rise within its per-rank plan and each world-2 "
          f"rank's below world 1's; the stored results in host memory; the "
          f"capped world-2 run took the class table with phase 12's "
          f"results; the packed band "
          f"of phase 6's attribute phase 13's bytes, scores and counts "
          f"(world 1 exactly; world 2 count deltas {w2['count_deltas'][0::2]});"
          f" the packed euclidean band at 1 M points phase 13's bytes, "
          f"scores and counts; at 49,920 points on the world-2 ranks the "
          f"single-device run's bytes (its run {w2['euclid_single_s']:.4f} "
          f"s; count deltas {w2['count_deltas'][1::2]}); launches 390 "
          f"close_diag and relax_panel a rank and relax_band_row "
          f"{cuts['launches']}; spawn wall {w2['spawn_s']:.2f} s; "
          f"dryrun(2, device='cuda') six legs passed in "
          f"{bm['dryrun_s']:.1f} s (engines {bm['dryrun_engines']}); phase "
          f"18 took {bm['phase_s']:.1f} s", flush=True)


def print_planner(pl, card):
    gb = 1e9

    def ratio(model, got):
        return f"{model / got:.3f}" if got and got > 0 else "n/a"

    print(f"planner ({card}): device_hbm_budget() {pl['budget']} B "
          f"({pl['budget'] / gb:.3f} GB); phase 12's band GO session, cold "
          f"runs with the allocator sampled at each phase end", flush=True)
    for store, r in pl["runs"].items():
        parts = "; ".join(
            f"{ph} modeled {m / gb:.4f} GB, measured rise allocated "
            f"{(a or 0) / gb:.4f} GB (modeled/measured {ratio(m, a)}), "
            f"reserved {(rr or 0) / gb:.4f} GB ({ratio(m, rr)})"
            for ph, (m, a, rr) in r["peaks"].items())
        print(f"planner {store} ({card}): run {r['wall_s']:.4f} s, launches "
              f"{r['launches']}; {parts}; no phase above its model",
              flush=True)
    def top(peaks, i):
        return max(p[i] or 0 for p in peaks.values()) / gb

    caps = "; ".join(
        f"{store} capped at {c['cap'] / gb:.4f} GB above its start: "
        f"{c['wall_s']:.4f} s, largest rise allocated "
        f"{top(c['peaks'], 1):.4f} GB, reserved {top(c['peaks'], 2):.4f} GB"
        for store, c in pl["capped"].items())
    print(f"planner capped ({card}): each residency again under "
          f"set_per_process_memory_fraction at the plan's largest phase "
          f"peak, no OutOfMemoryError, results equal to the uncapped run's: "
          f"{caps}", flush=True)
    a = pl["auto"]
    print(f"planner auto ({card}): budget {a['f16']['budget']} B -> f16 "
          f"({a['f16']['wall_s']:.4f} s), {a['host']['budget']} B -> host "
          f"({a['host']['wall_s']:.4f} s), each equal to the forced run; "
          f"'host' bitwise 'device', 'f16' the device values rounded, "
          f"indicator and counts equal; a budget of 1e8 B raised before any "
          f"allocation or launch: {pl['refusal'][:160]}...", flush=True)
    p = pl["prep"]
    print(f"planner prep ({card}): device prep {p['device_s']:.4f} s, peak "
          f"modeled {p['device_peak'][0] / gb:.4f} GB, measured "
          f"{(p['device_peak'][1] or 0) / gb:.4f} GB; chunked prep "
          f"{p['chunked_s']:.4f} s, peak modeled "
          f"{p['chunked_peak'][0] / gb:.4f} GB, measured "
          f"{(p['chunked_peak'][1] or 0) / gb:.4f} GB; operands bitwise "
          f"equal; phase 16 took {pl['phase_s']:.1f} s", flush=True)


def print_dense_mesh(ms, card):
    runs = ms["runs"]
    for name, kernel_rows in ms["kernels"].items():
        rows = ", ".join(
            f"{r['form']} {' x '.join(map(str, r['shape']))}: "
            f"{r['ms'] * 1e3:.2f} us a call, device "
            f"{(r.get('device_ms') or 0) * 1e3:.2f} us (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms'] * 1e3:.2f} us by "
            f"{r['bound_by']})"
            for r in kernel_rows)
        print(f"mesh {name} ({card}): bitwise equal to plain at the sharded "
              f"FW's shapes: {rows}", flush=True)
    w1 = runs["world1"]
    print(f"mesh world 1 ({card}; NCCL, 'data'): process group "
          f"{w1['ready']:.2f} s; sharded FW alone (min of 3) "
          f"{w1['data_fw_s']:.4f} s, launches {w1['data_fw_launches']}; "
          f"run_pipeline ({w1['data_engine']}) warm {w1['data_warm_s']:.4f} "
          f"s, steady min {w1['data_steady_s']:.4f} s, launches "
          f"{w1['data_launches']}", flush=True)
    for world, tags in ((2, ("data", "perm", "attr")), (4, ("row_col",))):
        w = runs[f"world{world}"]
        ready = [round(float(r["ready"]), 2) for r in w["ranks"]]
        entered = [round(float(r["entered"]), 2) for r in w["ranks"]]
        engines = {t: str(w["ranks"][0][f"{t}_engine"]) for t in tags}
        print(f"mesh world {world} ({card}; gloo, {world} processes on the "
              f"card): spawn wall {w['spawn_s']:.2f} s; gloo start-up per "
              f"rank: process up {entered} s, process group ready {ready} s "
              f"after the spawn; engines {engines}; per rank (min of 3): "
              f"FW alone {mesh_summary(runs, world, tags, 'fw_s')} s, "
              f"warm {mesh_summary(runs, world, tags, 'warm_s')} s, steady "
              f"{mesh_summary(runs, world, tags, 'steady_s')} s; rank 0 "
              f"launches {[str(w['ranks'][0][f'{t}_launches']) for t in tags]}",
              flush=True)
    print(f"mesh checks ({card}): every sharded FW bitwise ops.apsp(d0) "
          f"(classic, relax_full); every rank's neighborhoods identical to "
          f"phase 4's; every null the ranks' streams replayed on one device "
          f"and summed; 999 permutations on the 'perm' mesh rounded to "
          f"{int(runs['world2']['ranks'][0]['perm_num_permutations'])}; the "
          f"'attr' census, log sf, indicator and counts bitwise phase 10's "
          f"run of matrix A; launches 32 close_diag, 64 relax_panel, 32 "
          f"relax_full a rank on the FW meshes; phase 17 took "
          f"{ms['phase_s']:.1f} s", flush=True)


def main():
    started = time.perf_counter()
    # phase 1: the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    card = card_line()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    so = native.build()
    native.lib()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)

    # phase 3: kernels against their plain versions
    kernels = check_kernels(device)
    kernels.update(check_skew_kernels(device))
    kernels.update(check_full_kernels(device))
    kernels.update(check_band_row_kernel(device))
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(*k["work"])
        print(f"kernel {name}: bitwise equal to plain; per call {k['ms']:.4f} "
              f"ms, device {k.get('device_ms')} ms (plain {k['plain_ms']:.4f} "
              f"ms; bound {k['bound_ms']:.4f} ms by {k['bound_by']}: "
              f"{k['work'][0]} candidates, {k['work'][1]} bytes) "
              f"{k['shapes']}", flush=True)
    tables = check_table_kernel(device)
    for tag, t in tables.items():
        print(f"kernel logsf_table {tag}: bitwise equal to plain, one launch;"
              f" per call {t['ms']:.4f} ms, device {t['device_ms']} ms "
              f"(plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"by bytes: {t['bytes']} bytes, M {t['M']}, (S_max, C, R) "
              f"{t['shape']})", flush=True)
    forms = window_sym_forms(device)
    print(f"window relax forms (block 128): list length -> (whole-tile "
          f"device ms, sub-tile device ms, form taken), each bitwise equal to "
          f"plain: {forms}", flush=True)
    full_forms = full_relax_forms(device)
    print(f"full relax forms (block 128, banded relax_full's list): list "
          f"length -> (64x64 sub-tile, whole-tile, window 32x32 sub-tile "
          f"device ms, form taken), each bitwise equal to plain: "
          f"{full_forms}", flush=True)
    # the bounds' candidate rate against the card's measured one;
    # close_diag runs on one SM, so no share of the card's rate fits it
    rate, probe = addmin_rate(device)
    shares = {}
    for name, k in kernels.items():
        if name != "close_diag" and k.get("device_ms"):
            r = k["work"][0] / (k["device_ms"] * 1e-3)
            shares[name] = dict(rate_t_per_s=r / 1e12,
                                of_nominal=r / CANDIDATES_PER_S,
                                of_measured=r / rate)
    print(f"add+min probe: {rate / 1e12:.4f} T candidates/s measured "
          f"({rate / CANDIDATES_PER_S:.4f} of the nominal "
          f"{CANDIDATES_PER_S / 1e12:.1f} T/s; {probe}); each min-plus "
          f"kernel's candidates over its device time, and that rate's share "
          f"of the nominal and of the measured rate: {shares}", flush=True)

    # phases 4 and 5: the Example_1 path, banded, then dense and band storage
    net = build_network()
    vals = build_attribute()
    s = run_slice(device, net, vals)
    print(f"slice: banded window {s['window']}, launches {s['launches']}; "
          f"warm {s['warm_s']:.4f} s, steady {s['steady_s']} "
          f"(min {s['steady_min_s']:.4f} s); APSP phase {s['apsp_s']:.4f} s, "
          f"null phase {s['null_s']:.4f} s ({s['valid_rows']} valid rows x "
          f"{N_PERM} permutations); mean neighborhood "
          f"{s['mean_neighborhood']:.2f}, enriched {s['enriched']}", flush=True)
    print(f"dense: apsp_mode='full' run {s['dense_run_s']:.4f} s, launches "
          f"{s['dense_launches']}, neighborhoods equal to banded", flush=True)
    print(f"band cross-check: apsp_mode='band' first run {s['band_run_s']:.4f}"
          f" s, steady min {s['band_steady_s']:.4f} s, launches "
          f"{s['band_launches']}, neighborhoods equal to banded, "
          f"scores within 1e-5, sum |delta counts| {s['band_count_delta']}",
          flush=True)
    prof = profile_steady(s["session"])
    print(f"profile: one steady run, wall {prof['wall_ms']:.3f} ms with the "
          f"profiler on, device busy {prof['busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}; largest (name, launches, device ms): "
          f"{prof['top']}", flush=True)

    # phase 6: the band-storage path at 49,920 nodes
    t0 = time.perf_counter()
    bs = run_band_slice(device)
    print(f"band slice: {bs['nodes']} nodes, {bs['edges']} edges, band "
          f"{bs['band']}, bt {bs['bt']}, W {bs['width']}, w_c {bs['w_c']}; "
          f"launches {bs['launches']}; warm {bs['warm_s']:.4f} s, steady "
          f"{bs['steady_s']} (min {bs['steady_min_s']:.4f} s); FW front "
          f"{bs['front_s']:.4f} s, null tail {bs['tail_s']:.4f} s "
          f"({bs['valid_rows']} valid rows x {N_PERM} permutations); mean "
          f"neighborhood {bs['mean_neighborhood']:.2f}, enriched "
          f"{bs['enriched']}; peak device memory {bs['peak_gb']:.3f} GB; "
          f"{N_SOURCES} indicator rows equal to scipy Dijkstra", flush=True)
    print(f"band classic FW: relax_skew path {bs['classic_fw_s']:.4f} s, "
          f"launches {bs['classic_launches']}, indicator equal to the "
          f"symmetric run's", flush=True)
    bprof = profile_steady(bs["session"])
    print(f"band profile: one steady run, wall {bprof['wall_ms']:.3f} ms with "
          f"the profiler on, device busy {bprof['busy_ms']:.3f} ms, idle share "
          f"{bprof['idle_share']:.3f}; largest (name, launches, device ms): "
          f"{bprof['top']}; phase 6 took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 7: the op-level path at the Example_1 width
    t0 = time.perf_counter()
    o = run_ops_path(device, net, vals)
    print(f"ops classic FW: apsp(d0) with the JAX defaults, launches "
          f"{o['fw_launches']}; bitwise equal to apsp(d0, symmetric=True); "
          f"indicator equal to scipy Dijkstra's; min of 3 {o['fw_s']:.4f} s "
          f"(symmetric {o['sym_s']:.4f} s)", flush=True)
    print(f"ops classic banded FW: window {o['window']}, "
          f"launches {o['banded_launches']}; bitwise equal to the symmetric "
          f"banded FW; min of 3 {o['banded_s']:.4f} s (symmetric "
          f"{o['banded_sym_s']:.4f} s)", flush=True)
    print(f"ops squaring: apsp(d0, method='pallas_squaring'), launches "
          f"{o['sq_launches']}; indicator equal to scipy Dijkstra's; max "
          f"relative difference to the FW {o['sq_rel']:.3e}; min of 3 "
          f"{o['sq_s']:.4f} s", flush=True)
    print(f"ops directed 16-NN: classic FW launches {o['dir_launches']}, "
          f"classic banded launches {o['dir_banded_launches']}; both "
          f"indicators equal to scipy's directed Dijkstra; "
          f"{o['dir_asymmetric']} asymmetric entries; "
          f"apsp(d0, symmetric=True) would get "
          f"{o['sym_wrong']} of {N_NODES ** 2} distances wrong "
          f"({o['sym_shorter']} shorter than the shortest path, "
          f"{o['sym_wrong_within_r']} indicator entries)", flush=True)
    print(f"ops flagship step: apsp + threshold + scores + {N_PERM}-"
          f"permutation null over {o['step_rows']} valid rows, launches "
          f"{o['step_launches']}; neighborhoods equal to scipy Dijkstra's; "
          f"min of 3 {o['step_s']:.4f} s; phase 7 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 8: the row-sharded band engine on the phase-6 slice, world 1
    # over NCCL in this process, then world 2 over gloo on the same card
    t0 = time.perf_counter()
    w1 = run_sharded_world1(device, bs["session"])
    p1 = w1["profile"]
    print(f"sharded band world 1 (NCCL): launches {w1['launches']}; warm "
          f"{w1['warm_s']:.4f} s, steady {w1['steady_s']} (min "
          f"{w1['steady_min_s']:.4f} s); sharded FW alone {w1['fw_s']:.4f} s "
          f"(phase 6's FW front {bs['front_s']:.4f} s); peak device memory "
          f"{w1['peak_gb']:.3f} GB; indicator band bitwise and counts exactly "
          f"equal to phase 6's, scores within 1e-5", flush=True)
    print(f"sharded band profile: one steady run, wall {p1['wall_ms']:.3f} "
          f"ms with the profiler on, device busy {p1['busy_ms']:.3f} ms, idle "
          f"share {p1['idle_share']:.3f}; largest (name, launches, device "
          f"ms): {p1['top']}", flush=True)
    w2 = run_sharded_world2(device, bs["session"], w1)
    print(f"sharded band world 2 (gloo, two processes on one card): spawn "
          f"wall {w2['wall_s']:.2f} s; per rank sharded FW {w2['fw_s']} s, "
          f"facade run {w2['run_s']} s; FW launches {w2['fw_launches']}; run "
          f"launches {w2['run_launches']}; FW band and indicator bitwise "
          f"equal to world 1's, scores within 1e-5, sum |delta counts| "
          f"{w2['count_delta']}; phase 8 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 10: the binary GO path on the Example_1 network, two matrices
    # of 4,373 terms (run before phase 9's report, which lists its launches)
    go = run_go_path(device, net)
    for name in ("A", "B"):
        m, prof = go[name], go[f"{name}_profile"]
        print(f"GO binary matrix {name} ({N_NODES} x {GO_ATTRS}): engine "
              f"{m['engine']}, launches {m['launches']}; warm "
              f"{m['warm_s']:.4f} s, steady {m['steady_s']} (min "
              f"{m['steady_min_s']:.4f} s); peak device memory "
              f"{m['peak_gb']:.3f} GB; {GO_SAMPLES} sampled p within "
              f"{m['scipy_err']:.3e} of scipy; {m['enriched']} enriched "
              f"cells, {m['attributes_enriched']} terms enriched somewhere; "
              f"profile: one steady run, wall {prof['wall_ms']:.3f} ms with "
              f"the profiler on, device busy {prof['busy_ms']:.3f} ms, idle "
              f"share {prof['idle_share']:.3f}; largest (name, launches, "
              f"device ms): {prof['top']}", flush=True)
    print(f"GO binary checks: matrix B on the loop engine: indicator and "
          f"counts equal to the table's, p within "
          f"{go['B_loop_vs_table_p']:.3e}; stages on A (define_neighborhoods "
          f"+ compute_pvalues) {go['staged_s']:.4f} s: neighborhoods and "
          f"indicator equal to the fused run's, p within "
          f"{go['staged_vs_fused_p']:.3e}; FDR run on A {go['fdr_run_s']:.4f}"
          f" s, within {go['fdr_ulps']:.0f} f32 ulp of fdr_bh_logsf_np on "
          f"sampled rows, indicator equal, {go['fdr_enriched']} enriched "
          f"cells", flush=True)
    print(f"GO binary parts (min of 3): the facade's host passes over the "
          f"attribute matrix {go['host_prep_s']:.4f} s; census GEMMs "
          f"{go['census_s']:.4f} s; "
          f"tail loop + finalization on A {go['tail_s']:.4f} s "
          f"({go['tail_iterations']} iterations at most); class table on B "
          f"{go['table_spec']} build {go['table_build_s']:.4f} s, lookup "
          f"{go['table_lookup_s']:.4f} s; log-space FDR on A "
          f"{go['fdr_s']:.4f} s; phase 10 took {go['phase_s']:.1f} s",
          flush=True)

    # phase 17 holds its attr-sharded run against phase 10's run of A
    go_ref = dict(logsf=band_digest(go["A_session"]._logsf_dev),
                  nbin=band_digest(go["A_session"]._nes_binary_dev),
                  enriched=np.asarray(go["A_session"].attributes[
                      "num_neighborhoods_enriched"]))

    # phase 11: the domain stage on phase 10's matrix A session
    d = run_domain_stage(device, go.pop("A_session"), net)
    dp = d["profile"]
    print(f"domains: matrix A ({N_NODES} x {GO_ATTRS}), {d['top']} top terms "
          f"(the GEMM engine); {d['domains_075']} domains at threshold 0.75 "
          f"({d['domains_060']} at 0.6, no second GEMM), "
          f"{d['domains_trimmed']} after trimming, {d['attrs_per_domain']} "
          f"terms and {d['nodes_per_domain']} primary nodes per domain "
          f"(smallest, largest); largest domain's label "
          f"{d['largest_label']!r}; intersections equal the host f64 "
          f"product ({d['host_product_s']:.4f} s on the host), "
          f"{DOMAIN_SAMPLES} sampled terms' condensed jaccard bitwise "
          f"pdist's, aggregates equal the host loop, CSC view equal, the CPU "
          f"session's stage equal", flush=True)
    print(f"domains: times (min of 3) stage {d['stage_s']:.4f} s, "
          f"define_top_attributes {d['top_s']:.4f} s, intersection GEMM + "
          f"(A, A) download {d['gemm_s']:.4f} s, condensed distances "
          f"{d['condensed_s']:.4f} s, linkage + fcluster "
          f"{d['linkage_s']:.4f} s, aggregates {d['aggregates_s']:.4f} s, "
          f"trim_domains {d['trim_s']:.4f} s; device memory before "
          f"{d['base_gb']:.3f} GB, peak {d['peak_gb']:.3f} GB; profile: one "
          f"stage, wall {dp['wall_ms']:.3f} ms with the profiler on, device "
          f"busy {dp['busy_ms']:.3f} ms, idle share {dp['idle_share']:.3f}; "
          f"largest (name, launches, device ms): {dp['top']}; phase 11 took "
          f"{d['phase_s']:.1f} s", flush=True)

    # phase 12: the band GO path on phase 6's network, 4,373 terms
    bg = run_band_go(device, bs["session"])
    for name in ("table", "hostchunks"):
        m = bg[name]
        prof = m.get("profile", {})
        print(f"band GO {name} ({bg['nodes']} x {bg['attrs']}; {card}): "
              f"engine {m['engine']}, launches {m['launches']}; warm "
              f"{m['warm_s']:.4f} s, steady {m['steady_s']} (min "
              f"{m['steady_min_s']:.4f} s); peak device memory "
              f"{m['peak_gb']:.3f} GB; {GO_SAMPLES} sampled p within "
              f"{m['scipy_err']:.3e} of scipy; profile: one steady run, "
              f"wall {prof.get('wall_ms', 0):.3f} ms with the profiler on, "
              f"device busy {prof.get('busy_ms', 0):.3f} ms, idle share "
              f"{prof.get('idle_share', 0):.3f}; largest (name, launches, "
              f"device ms): {prof.get('top')}", flush=True)
    t = bg["table"]
    print(f"band GO checks ({card}): indicator band bitwise phase 6's; "
          f"census equal to the host scipy.sparse product "
          f"({bg['host_census_s']:.2f} s on the host); mean neighborhood "
          f"{t['mean_neighborhood']:.2f}; {t['enriched']} enriched cells, "
          f"{t['attributes_enriched']} terms enriched somewhere; "
          f"hostchunks-band: indicator and counts equal to table-band's, p "
          f"within {bg['loop_vs_table_p']:.3e}, log sf within "
          f"{bg['loop_vs_table_ulps']:.0f} f32 ulps; stages "
          f"{bg['staged_s']:.4f} s, equal to the fused run; FDR run "
          f"{bg['fdr_run_s']:.4f} s, within {bg['fdr_ulps']:.0f} f32 ulp of "
          f"fdr_bh_logsf_np on sampled rows, {bg['fdr_enriched']} enriched "
          f"cells; CSC view ({bg['csc_s']:.4f} s) equal to np.nonzero of "
          f"the int8 download", flush=True)
    print(f"band GO parts (min of 3; {card}): host operands of the loop "
          f"engines {bg['host_operands_s']:.4f} s; device operand prep "
          f"{bg['prep_s']:.4f} s; class table plan {bg['table_plan']}: "
          f"census + table + lookup of the first and last chunk "
          f"{bg['table_chunk_s']} s, all chunks {bg['table_all_s']:.4f} s; "
          f"tail loop of the first and last host chunk of {bg['attr_chunk']}"
          f" columns {bg['tail_chunk_s']} s (iteration buckets "
          f"{bg['chunk_iters']}); log-space FDR {bg['fdr_s']:.4f} s; "
          f"domain stage: define_top_attributes {bg['top_s']:.4f} s, "
          f"define_domains {bg['domains_s']:.4f} s, trim_domains "
          f"{bg['trim_s']:.4f} s ({bg['top']} top terms, {bg['domains']} "
          f"domains); matrix built in {bg['matrix_s']:.1f} s; phase 12 took "
          f"{bg['phase_s']:.1f} s", flush=True)

    # phase 13: the sparse BF relax and the packed graph band on phase 6's
    # network, then the euclidean band at 49,920 and at 1,000,000 points
    bf = run_band_bf(device, bs["session"])
    bp = bf.get("profile", {})
    print(f"band BF ({card}): band_relax='bf' records 'bf', {bf['slots']} "
          f"slots, {bf['iters']} rounds of a budget of {bf['budget']}; "
          f"launches {bf['launches']}; warm {bf['warm_s']:.4f} s, steady "
          f"min {bf['steady_s']:.4f} s, peak {bf['peak_gb']:.3f} GB; relax "
          f"alone (min of 3) BF {bf['bf_alone_s']:.4f} s, FW "
          f"{bf['fw_alone_s']:.4f} s (phase 6's FW front "
          f"{bs['front_s']:.4f} s); {bf['cells_differing']} indicator cells "
          f"differ from phase 6's FW band, counts equal; BF relax profile: "
          f"wall {bp.get('wall_ms', 0):.3f} ms, device busy "
          f"{bp.get('busy_ms', 0):.3f} ms, largest (name, launches, device "
          f"ms): {bp.get('top')}", flush=True)
    print(f"band BF fall-back ({card}): a budget of one round records "
          f"'bf->fw', run {bf['fallback_s']:.4f} s, launches "
          f"{bf['fallback_launches']}, band and counts equal to phase 6's; "
          f"phase 13 (c) took {bf['phase_s']:.1f} s", flush=True)
    band_go = bg.pop("session")  # phase 15 saves it, phase 16 plans it
    band_go_matrix = bg.pop("matrix")
    # what phase 18 holds its mesh runs to: phase 12's table-band run, and
    # phase 6's session (its packed band is phase 13 (d)'s)
    go_mesh_ref = dict(band=band_digest(band_go._neighborhoods_dev.data),
                       nbin=band_digest(band_go._nes_binary_dev),
                       logsf=band_digest(band_go._logsf_dev),
                       enriched=np.asarray(band_go.attributes[
                           "num_neighborhoods_enriched"]),
                       loop_logsf=bg.pop("loop_logsf"))
    ref6 = bs["session"]
    band_mesh_ref = dict(
        net=ref6._graph_arrays, vals=ref6.node2attribute,
        bt=ref6._neighborhoods_dev.bt, go_attrs=band_go_matrix.shape[1],
        packed=dict(band=band_digest(bst.pack_band_bits(
            ref6._neighborhoods_dev.data)), ns=ref6.ns,
            counts_neg=ref6.counts_neg, counts_pos=ref6.counts_pos),
        **{k: getattr(ref6, k) for k in ("apsp_mode", "keep_node_distances",
                                         "random_seed",
                                         "neighborhood_radius")})
    del ref6
    pk = run_band_packed(device, bs["session"], band_go, band_go_matrix)
    print(f"band packed ({card}): band_indicator_bits=True, quantitative run "
          f"{pk['quant_s']:.4f} s (steady {pk['quant_steady_s']:.4f} s), "
          f"launches {pk['quant_launches']}, peak {pk['quant_peak_gb']:.3f} "
          f"GB (phase 6's {bs['peak_gb']:.3f} GB; {pk['base_gb']:.3f} GB "
          f"resident before), band the packed phase-6 band, scores and counts "
          f"equal; table-band run {pk['table_s']:.4f} s, launches "
          f"{pk['table_launches']}, peak {pk['table_peak_gb']:.3f} GB "
          f"({pk['table_base_gb']:.3f} GB resident before; phase 12's warm "
          f"{bg['table']['warm_s']:.4f} s, peak {bg['table']['peak_gb']:.3f} "
          f"GB), indicator, counts and log sf bitwise phase 12's; phase 13 "
          f"(d) took {pk['phase_s']:.1f} s",
          flush=True)
    band_edges = bs["session"]._graph_arrays[1]
    del bs["session"]
    torch.cuda.empty_cache()
    ek = run_euclid_keep(device)
    print(f"euclid band keep ({card}): {ek['nodes']} points, kept "
          f"distances; fused run {ek['fused_s']:.4f} s, launches "
          f"{ek['launches']}, peak {ek['peak_gb']:.3f} GB; {EUCLID_ROWS} "
          f"distance and indicator rows equal to the host's "
          f"({ek['near_radius_cells']} cells within one f32 ulp of the "
          f"radius); stages {ek['staged_s']:.4f} s, equal to the fused run; "
          f"{ek['terms']} binary terms through the staged band GO engine "
          f"{ek['go_s']:.4f} s, {GO_SAMPLES} sampled p within "
          f"{ek['go_scipy_err']:.3e} of scipy, {ek['go_enriched']} enriched "
          f"cells; mean neighborhood {ek['mean_neighborhood']:.2f}; phase 13 "
          f"(b) took {ek['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    e1 = run_euclid_1m(device)
    ep = e1.get("profile", {})
    print(f"euclid band ({e1['nodes']} points; {card}): band {e1['band']}, "
          f"bt {e1['bt']}, W {e1['width']}, w_c {e1['w_c']}, packed "
          f"indicator {e1['packed_gb']:.3f} GB (int8 {e1['int8_gb']:.3f} "
          f"GB); launches {e1['launches']}; warm {e1['warm_s']:.4f} s, "
          f"steady {e1['steady_s']} (min {e1['steady_min_s']:.4f} s); peak "
          f"{e1['peak_packed_gb']:.3f} GB packed, {e1['peak_int8_gb']:.3f} "
          f"GB int8 ({e1['base_gb']:.3f} GB resident before); "
          f"{EUCLID_ROWS} indicator rows equal to the host's "
          f"({e1['host_rows_s']:.1f} s on the host; "
          f"{e1['near_radius_cells']} cells within one f32 ulp of the "
          f"radius); mean neighborhood {e1['mean_neighborhood']:.2f}; "
          f"profile ({e1.get('profile_s', 0):.1f} s with its processing): "
          f"one steady run, wall {ep.get('wall_ms', 0):.3f} ms, "
          f"device busy {ep.get('busy_ms', 0):.3f} ms, idle share "
          f"{ep.get('idle_share', 0):.3f}; largest (name, launches, device "
          f"ms): {ep.get('top')}", flush=True)
    print(f"euclid band parts (min of 3; {card}): indicator build packed "
          f"{e1['build_packed_s']:.4f} s, int8 {e1['build_int8_s']:.4f} s; "
          f"null tail ({e1['valid_rows']} valid rows x {N_PERM} "
          f"permutations, batch {e1['batch']}) packed "
          f"{e1['null_packed_s']:.4f} s, int8 {e1['null_int8_s']:.4f} s; "
          f"scores packed {e1['score_packed_s']:.4f} s, int8 "
          f"{e1['score_int8_s']:.4f} s; compaction packed "
          f"{e1['compact_packed_s']:.4f} s, int8 {e1['compact_int8_s']:.4f} "
          f"s; int8 run {e1['int8_run_s']:.4f} s (steady "
          f"{e1['int8_steady_s']:.4f} s): bytes, scores and counts equal to "
          f"the packed run's; phase 13 (a) took {e1['phase_s']:.1f} s",
          flush=True)

    # phase 14: the file-driven workflow, then the sampled layout at
    # phase 6's size
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fw = run_file_workflow(device, net, vals, s["session"], band_edges,
                               tmp)
    # phase 15: the host extras on the sessions of phases 4, 11 and 12
    torch.cuda.empty_cache()
    hx = run_host_extras(device, s["session"], d.pop("session"), band_go)
    # phase 16: the memory planner on phase 12's band GO session
    torch.cuda.empty_cache()
    planned = run_planner(device, band_go, band_go_matrix)
    del band_go
    torch.cuda.empty_cache()
    # phase 17: the dense engines on a mesh at the Example_1 width
    meshed = run_dense_mesh(device, s["session"], net, vals,
                            go_matrices(net[0])[0], go_ref)
    # phase 18: the rest of the row-sharded band engine at full width
    torch.cuda.empty_cache()
    band_meshed = run_band_mesh(device, band_mesh_ref, band_go_matrix,
                                go_mesh_ref, e1.pop("mesh_ref"))
    del band_go_matrix
    torch.cuda.empty_cache()
    fw.update(fw.pop("finish")())  # phase 14's CPU layout ran meanwhile
    print(f"file workflow ({card}): SAFE(path_to_ini_file) + load_network "
          f"(native parse + exact energy layout on the card) "
          f"{fw['load_network_s']:.4f} s; parse alone {fw['parse_s']:.4f} s, "
          f"layout alone {fw['layout_s']:.4f} s, edge lengths "
          f"{fw['lengths_s']:.6f} s (min of 3); engine {fw['engine']}, "
          f"window {fw['window']}, launches "
          f"{fw['launches']['file_example1']}; run_pipeline warm "
          f"{fw['warm_s']:.4f} s, steady min {fw['steady_s']:.4f} s; "
          f"indicator equal to scipy Dijkstra's on the layout; mean "
          f"neighborhood {fw['mean_neighborhood']:.2f}; preservation "
          f"{fw['preservation']:.4f} (the CPU layout's "
          f"{fw['preservation_cpu']:.4f}, {fw['cpu_layout_s']:.1f} s on a host "
          f"thread during phases 14 and 15, {fw['join_wait_s']:.1f} s of it "
          f"waited for after them); "
          f"inputs written in "
          f"{fw['write_s']:.1f} s", flush=True)
    print(f"file workflow checks ({card}): the .mat twin's arrays, "
          f"neighborhoods, scores and counts equal phase 4's (run "
          f"{fw['mat_s']:.4f} s, launches {fw['launches']['file_mat_twin']}); "
          f"GO matrix A file ({N_NODES} x {GO_ATTRS}) parse min of 2 "
          f"{fw['go_parse_s']:.4f} s, values equal phase 10's; "
          f"compute_pvalues {fw['go_pvalues_s']:.4f} s (engine "
          f"{fw['go_engine']}, {fw['go_enriched']} enriched cells), domain "
          f"stage {fw['go_domains_s']:.4f} s ({fw['go_top']} top terms, "
          f"{fw['domains']} domains), reports {fw['reports_s']:.4f} s "
          f"({fw['rows']} rows), read back equal to the session; CLI "
          f"{fw['cli_s']:.4f} s, launches {fw['launches']['file_cli']}, its "
          f"pickle equal to the facade's NES", flush=True)
    print(f"band layout ({fw['band_nodes']} nodes, {fw['band_edges']} edges; "
          f"{card}): sampled energy layout (2,048 repulsors, 1,000 steps) "
          f"warm {fw['band_layout_warm_s']:.4f} s, again "
          f"{fw['band_layout_s']:.4f} s; preservation "
          f"{fw['band_preservation']:.4f}; phase 14 took "
          f"{fw['phase_s']:.1f} s", flush=True)

    for name, r in hx["saves"].items():
        print(f"save {name} ({card}): SAFE.save pickle {r['bytes']} bytes"
              + (f" (budget {r['budget_bytes']}: band + f32 log sf + int8 "
                 f"indicator + attributes, + 10%)" if "budget_bytes" in r
                 else "")
              + f", save {r['save_s']:.3f} s, load {r['load_s']:.3f} s; no "
              f"tensor in it, public arrays bitwise after loading on the card "
              f"(compared in {r['compare_s']:.2f} s)"
              + (f"; a process without the card read nes, nes_binary, a "
                 f"column and node2domain bitwise in {r['workstation_s']:.2f}"
                 f" s; re-clustered at 0.5 equal to the original "
                 f"({r['domains_050']} domains)" if "workstation_s" in r
                 else ""), flush=True)
    for name, r in hx["checkpoints"].items():
        print(f"checkpoint {name} ({card}): save_session {r['bytes']} bytes "
              f"(.npz + .meta.json) in {r['save_s']:.3f} s, "
              f"load_session(device='cuda') {r['load_s']:.3f} s, arrays "
              f"bitwise and tables equal, define_top_attributes resumed in "
              f"{r['resume_s']:.3f} s", flush=True)
    pl, pr, mg = hx["plot"], hx["profile"], hx["make_go"]
    print(f"plot data ({card}): domain mixture colors within "
          f"{pl['mixture_err']:.3e} of the host formula; {pl['columns']} "
          f"band NES and indicator columns equal to the full device "
          f"matrices ({pl['columns_s']:.3f} s), out-of-range columns refused",
          flush=True)
    print(f"profiled Example_1 stages ({card}): StageTimer "
          f"{ {k: round(v, 4) for k, v in pr['stages'].items()} } s; launch "
          f"counter {pr['launches']}; the Chrome trace "
          f"({pr['trace_mb']:.1f} MB) holds kernel events "
          f"{pr['trace_events']}", flush=True)
    print(f"make_go ({card}): {mg['terms']} terms, {mg['rows']} annotation "
          f"rows -> {mg['shape']} matrix equal to the depth-first closure; "
          f"parse {mg['parse_s']:.3f} s, make_go_matrix wall "
          f"{mg['wall_s']:.3f} s, TSV write {mg['write_s']:.3f} s "
          f"({mg['tsv_mb']:.1f} MB), load_attributes {mg['load_s']:.3f} s, "
          f"compute_pvalues {mg['pvalues_s']:.3f} s ({mg['engine']}, "
          f"{mg['enriched']} enriched cells, launches {mg['launches']}); "
          f"tools/cuda_validate.py VERIFY OK in {hx['validate_s']:.1f} s; "
          f"phase 15 took {hx['phase_s']:.1f} s (saves {hx['saves_s']:.1f} "
          f"s, checkpoints {hx['checkpoints_s']:.1f} s, make_go "
          f"{hx['make_go_s']:.1f} s)", flush=True)
    print_planner(planned, card)
    print_dense_mesh(meshed, card)
    print_band_mesh(band_meshed, card)

    # phase 9: the report; launches from the run of each kernel's path
    replaces = {"relax_panel": "safepy_tpu/ops/apsp_pallas.py:95",
                "relax_window_sym": "safepy_tpu/ops/apsp_pallas.py:193",
                "close_diag": "safepy_tpu/ops/apsp_pallas.py:258",
                "relax_skew_sym": "safepy_tpu/ops/apsp_bandstore.py:324",
                "relax_skew": "safepy_tpu/ops/apsp_bandstore.py:281",
                "relax_full": "safepy_tpu/ops/apsp_pallas.py:144",
                "relax_full_banded": "safepy_tpu/ops/apsp_pallas.py:161",
                "minplus_product": "safepy_tpu/ops/apsp_pallas.py:62",
                "relax_band_row": "safepy_tpu/ops/apsp_pallas.py:111"}
    launches = dict(s["launches"], relax_skew_sym=bs["launches"][
        "relax_skew_sym"], relax_skew=bs["classic_launches"]["relax_skew"],
        relax_full=o["fw_launches"]["relax_full"],
        relax_full_banded=o["banded_launches"]["relax_full_banded"],
        minplus_product=o["sq_launches"]["minplus_product"],
        relax_band_row=w1["launches"]["relax_band_row"])
    paths = {"example1_banded": s["launches"], "band_49920": bs["launches"],
             "band_49920_classic": bs["classic_launches"],
             "ops_fw": o["fw_launches"], "ops_banded": o["banded_launches"],
             "ops_squaring": o["sq_launches"],
             "ops_directed_fw": o["dir_launches"],
             "ops_directed_banded": o["dir_banded_launches"],
             "ops_flagship_step": o["step_launches"],
             "sharded_band_world1": w1["launches"],
             **{f"sharded_band_world2_rank{r}": x
                for r, x in enumerate(w2["run_launches"])},
             "go_binary_loop": go["A"]["launches"],
             "go_binary_table": go["B"]["launches"],
             "band_go_table": bg["table"]["launches"],
             "band_go_hostchunks": bg["hostchunks"]["launches"],
             "band_bf": bf["launches"],
             "band_bf_fallback": bf["fallback_launches"],
             "band_packed": pk["quant_launches"],
             "band_packed_table": pk["table_launches"],
             "euclid_band_49920_keep": ek["launches"],
             "euclid_band_49920_go": ek["go_launches"],
             "euclid_band_1m_packed": e1["launches"],
             "euclid_band_1m_int8": e1["int8_launches"],
             **fw["launches"],
             "profiled_example1": pr["launches"],
             "checkpoint_resume": hx["resume_launches"],
             "make_go_binary": mg["launches"],
             **{f"planner_{store}": r["launches"]
                for store, r in planned["runs"].items()},
             **mesh_launches(meshed),
             **band_mesh_launches(band_meshed)}
    report = [{"name": name, "route": "cuda", "source": SRC,
               "replaces": replaces[name], "launches": launches[name],
               "launches_by_path": {path: counts[name]
                                    for path, counts in paths.items()},
               "max_abs_err": k["err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"],
               # no PyTorch call computes a min-plus product
               "library_ms": None, "device_ms": k.get("device_ms"),
               **({"bound_one_sm_ms": k["bound_one_sm_ms"]}
                  if "bound_one_sm_ms" in k else {})}
              for name, k in kernels.items()]
    report[[r["name"] for r in report].index("relax_panel")][
        "also_replaces"] = "safepy_tpu/ops/apsp_pallas.py:128"
    # the class table: JAX builds it with a jit'd lax.scan, not a Pallas
    # kernel; its numbers are the band GO chunk's, each case's in shapes
    cell = tables["gobp_chunk"]
    report.append({
        "name": "logsf_table", "route": "cuda", "source": TABLE_SRC,
        "replaces": "safepy_tpu/ops/hypergeom_table.py:108",
        "launches": bg["table"]["launches"]["logsf_table"],
        "launches_by_path": {path: counts.get("logsf_table")
                             for path, counts in paths.items()},
        "max_abs_err": 0.0, "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": cell["device_ms"],
        "shapes": tables})
    # the sharded FW's shapes (phase 17)
    for name, rows in meshed["kernels"].items():
        report[[r["name"] for r in report].index(name)][
            "mesh_shapes"] = rows
    report[[r["name"] for r in report].index("relax_band_row")][
        "window_cuts_world2"] = band_meshed["band_rows"]["cuts"]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
