"""The rest of the row-sharded band engine (safepy_tpu_torch/parallel/
band_sharded.py) through the facade on a 'data' mesh of two gloo ranks on
the CPU: band GO (the class table ``table-band-sharded`` and the f64 tail
loop ``loop-band-sharded``), the bit-packed band and the euclidean band
pipeline, against the port's single-device runs and the JAX package's
shard_map engines on a virtual 2-device CPU mesh.

One ``torch.multiprocessing.spawn`` of 2 gloo ranks (a ``file://``
rendezvous in a temporary directory) does all the ranks' work and saves
each rank's results; the comparisons run here. The spawned ranks import
this module, so it imports no JAX at module level.

Tolerances:

  * band GO: ``nes_binary``, the enriched counts and the indicator band
    exactly equal to the single-device ``table-band`` / ``loop-band`` and
    to JAX's sharded engines; the log-survival bitwise the single-device
    engine's (the census counts are exact integers, the rest is the same
    elementwise arithmetic), and against JAX within 1 f32 ulp + 1e-11 on
    the class table and 4 f32 ulps on the tail loop
    (tests/test_torch_band_go.py); the per-rank plan's JAX terms equal
    ``safepy_tpu.hbm.band_go_shard_hbm_plan``'s;
  * the C10 pin: a run under a budget that only the per-rank plan without
    the assembled outputs fits gives the same results as above, and its
    stored bands and (n, A) outputs are the host buffers the engine
    assembled, its device operands only the rank's window;
  * the packed band: its bytes equal ``pack_band_bits`` of the int8
    sharded band and JAX's bytes; scores within 1e-5 of JAX's; counts
    exactly the single-device packed run's with the same permutations;
  * the euclidean band, kept and packed: the indicator bitwise the
    single-device euclidean band, distances bitwise; the same score and
    count rules.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.parallel import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, TERMS, PERMS, WORLD = 600, 8, 40, 2
F32_ULP = 2.0 ** -23


def _arrays(n=N, k=6, seed=71):
    """(coords, edges, lengths, weights) of a kNN geometric graph."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


NET = _arrays()


def _go(seed=72):
    """Binary terms of members near random centres, 10% rows NaN."""
    rng = np.random.default_rng(seed)
    coords = NET[0]
    out = np.zeros((N, TERMS))
    for j in range(TERMS):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.2, 0.6))
        out[:, j] = (near & (rng.random(N) < 0.5)) | (rng.random(N) < 0.03)
    out[rng.random(N) < 0.1] = np.nan
    return out


GO = _go()
# dyadic values, 30% of the rows unannotated: every f32 sum is exact
QUANT = np.random.default_rng(73).integers(-12, 13, (N, 1)) / 4
QUANT[np.random.default_rng(74).random(N) < 0.3] = np.nan
V = int(np.isfinite(QUANT).any(axis=1).sum())
PERM_IDX = np.stack([np.random.default_rng(80 + i).permutation(V)
                     for i in range(PERMS)])

# the runs on the mesh, each with its settings
GO_RUNS = {"table": {}, "loop": dict(hypergeom_engine="loop"),
           "table-packed": dict(band_indicator_bits=True),
           "loop-nokeep": dict(hypergeom_engine="loop",
                               keep_node_distances=False)}
QUANT_RUNS = {"packed": dict(band_indicator_bits=True,
                             keep_node_distances=False),
              "int8": dict(band_indicator_bits=False,
                           keep_node_distances=False),
              "euclid-keep": dict(node_distance_metric="euclidean"),
              "euclid-packed": dict(node_distance_metric="euclidean",
                                    keep_node_distances=False,
                                    band_indicator_bits=True)}


def _session(vals, mesh=None, **settings):
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode, sf.random_seed = "band", 7
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.mesh = mesh
    sf.load_network(network_file=NET)
    sf.load_attributes(attribute_file=vals)
    return sf


def _keep_band_go(out, tag, sf):
    out[f"{tag}-engine"] = np.array([sf.apsp_engine_used,
                                     sf._hypergeom_engine_used,
                                     sf._band_relax_used])
    out[f"{tag}-nes_binary"] = sf.nes_binary
    out[f"{tag}-logsf"] = sf._logsf_dev.numpy()
    out[f"{tag}-enriched"] = np.asarray(
        sf.attributes["num_neighborhoods_enriched"])
    out[f"{tag}-band"] = sf._neighborhoods_dev.data.numpy()
    dist_band = sf._node_distances_dev
    out[f"{tag}-dist"] = (np.zeros(0) if dist_band is None
                          else dist_band.data.numpy())


def _keep_quant(out, tag, sf):
    out[f"{tag}-engine"] = np.array(sf.apsp_engine_used)
    for name in ("ns", "counts_neg", "counts_pos"):
        out[f"{tag}-{name}"] = np.asarray(getattr(sf, name))
    out[f"{tag}-band"] = sf._neighborhoods_dev.data.numpy()
    dist_band = sf._node_distances_dev
    out[f"{tag}-dist"] = (np.zeros(0) if dist_band is None
                          else dist_band.data.numpy())


# ------------------------------------------------------------ the ranks' side

SMALL_CHUNK = 3  # class-table chunks of 3, 3 and 2 of the TERMS columns


def _whole_operands(rank_np):
    """The (n, A) int8 operands and row validity in the permuted frame of
    ``rank_np``, as the single-device prep builds them from GO."""
    order = np.argsort(rank_np)
    finite = np.isfinite(GO)
    return (np.where(finite, GO, 0).astype(np.int8)[order],
            finite.any(axis=1).astype(np.float32)[order])


def _small_chunk_table(out):
    """Wraps the sharded class table: the facade's call (the rank's window
    of the operands, built by the facade) runs as it is, and the global
    band goes through the engine again with the rank's window of the whole
    operands, in chunks of ``SMALL_CHUNK`` columns, the inputs and outputs
    kept in ``out`` under ``chunked-``."""
    from safepy_tpu_torch.ops import hypergeom_table as htab
    from safepy_tpu_torch.parallel import band_sharded as bsh

    engine = bsh.hypergeom_band_table_sharded

    def wrapped(ind_g, nan0, nnn, M, thr, **kw):
        plans = []
        plan = htab.plan

        def kept_plan(*a, **k):
            plans.append(plan(*a, **k))
            return plans[-1]

        whole = _whole_operands(kw["rank_np"])
        window = bsh.operand_window(dist.get_rank(), bsh.sharded_band_geometry(
            kw["n"], kw["band"], WORLD))
        htab.plan = kept_plan
        try:
            logsf, nbin, counts = engine(
                ind_g, *(bsh._take_window(x, *window, "cpu") for x in whole),
                M, thr, **dict(kw, chunk_cols=SMALL_CHUNK))
        finally:
            htab.plan = plan
        out.update({
            "chunked-ind": ind_g.numpy(),
            "chunked-nan0": whole[0], "chunked-nnn": whole[1],
            "chunked-args": np.array([M, thr, kw["n"], kw["band"]],
                                     np.float64),
            "chunked-rank": np.asarray(kw["rank_np"]),
            "chunked-K": np.asarray(kw["K_np"]),
            "chunked-widths": np.array([c["width"]
                                        for c in plans[0]["chunks"]]),
            "chunked-logsf": logsf.numpy(), "chunked-nbin": nbin.numpy(),
            "chunked-counts": np.asarray(counts)})
        return engine(ind_g, nan0, nnn, M, thr, **kw)

    return wrapped


def _world_job(world):
    """Everything the ranks compute, on one rank."""
    from safepy_tpu_torch.parallel import band_sharded as bsh

    out = {}
    mesh = make_mesh({"data": world}, device_type="cpu")
    for tag, settings in GO_RUNS.items():
        sf = _session(GO, mesh=mesh, **settings)
        if tag == "table":
            engine = bsh.hypergeom_band_table_sharded
            bsh.hypergeom_band_table_sharded = _small_chunk_table(out)
        try:
            sf.run_pipeline()
        finally:
            if tag == "table":
                bsh.hypergeom_band_table_sharded = engine
        _keep_band_go(out, tag, sf)
        if tag == "table":
            plan = sf._hbm_plan_last
            out["plan"] = np.array([plan[k] for k in PLAN_KEYS])
            out["plan-fields"] = np.array([plan[k] for k in PORT_FIELDS])
            out["plan-band"] = np.array(plan["band"])
    _c10_pin(out, mesh, world)
    # a budget below the per-rank plan: refused before the operand prep
    sf = _session(GO, mesh=mesh, hbm_budget_bytes=10 ** 6)
    try:
        sf.run_pipeline()
        out["guard"] = np.array("not refused")
    except ValueError as e:
        out["guard"] = np.array(str(e))
    out["guard-untouched"] = np.array(
        sf._band_operands_cache is None and sf._n2a_dev is None
        and sf._neighborhoods_dev is None)
    for tag, settings in QUANT_RUNS.items():
        sf = _session(QUANT, mesh=mesh, **settings)
        sf.run_pipeline(perm_idx=PERM_IDX)
        _keep_quant(out, tag, sf)
    return out


PLAN_KEYS = ("bt", "rows", "window", "fw_slab", "indicator_bytes",
             "annotations_int8", "out_bytes")
PORT_FIELDS = ("stage_buffer", "ghost_operands", "prep_chunk",
               "host_outputs", "host_bands", "host_operands",
               "per_shard_peak", "per_rank_peak")


def _parent_per_rank_peak(p, n, a, ndev):
    """The per-rank peak the port planned while every rank assembled the
    results on its device (``replicated_floor``): JAX's terms plus the
    global int8 band and f32 distance band, the rest of the (n, A) outputs
    and int8 operands, a census chunk's assembly and the f32 upload of the
    full-device prep, or that prep's peak if larger."""
    g_rows = -(-p["rows"] // (128 * ndev)) * ndev * 128
    npad = -(-n // 128) * 128
    floor = (5 * g_rows * p["window"] + 5 * n * a - p["out_bytes"]
             + n * a - p["annotations_int8"] + 10 * npad * min(1024, a)
             + 4 * n * a)
    from safepy_tpu_torch import hbm
    return max(hbm.prep_peak(n, a, chunked=False),
               p["per_shard_peak"] + floor)


def _c10_pin(out, mesh, world):
    """The table run under a budget between the per-rank plan and the
    parent's (refused there): its results under ``c10-``; then the same
    run with every host buffer the engine assembles tagged, and where its
    results live under ``c10-host``."""
    from safepy_tpu_torch import hbm
    from safepy_tpu_torch.parallel import band_sharded as bsh

    band = int(out["plan-band"])
    plan = hbm.band_go_shard_hbm_plan(N, band, TERMS, world, packed=False,
                                      budget=10 ** 12)
    parent = _parent_per_rank_peak(plan, N, TERMS, world)
    budget = (plan["per_rank_peak"] + parent) // 2
    out["c10-budgets"] = np.array([plan["per_rank_peak"], budget, parent])
    sf = _session(GO, mesh=mesh, hbm_budget_bytes=int(budget))
    sf.run_pipeline()
    _keep_band_go(out, "c10", sf)
    # the same run again, every host buffer the engine makes tagged
    made = set()
    host_empty = bsh._host_empty

    def tagged(*a, **k):
        t = host_empty(*a, **k)
        made.add(t.untyped_storage().data_ptr())
        return t

    bsh._host_empty = tagged
    try:
        sf.run_pipeline()
    finally:
        bsh._host_empty = host_empty

    def host(t):
        return (t.device.type == "cpu"
                and t.untyped_storage().data_ptr() in made)

    ops = sf._band_operands_cache[1][0]
    geom = bsh.sharded_band_geometry(N, band, world)
    p0, p1 = bsh.operand_window(dist.get_rank(), geom)
    # every other tensor the session holds is smaller than one (n, A)
    # result: the FW slab, the chunks and the staging are gone
    big = [t for t in _session_tensors(sf) if t.numel() >= N * TERMS]
    out["c10-host"] = np.array([
        host(sf._logsf_dev), host(sf._nes_binary_dev),
        host(sf._neighborhoods_dev.data), host(sf._node_distances_dev.data),
        tuple(ops.shape) == (p1 - p0, TERMS),
        p1 - p0 <= (geom[4] + 2 * geom[0]) * 128,
        all(host(t) or t is ops for t in big), len(big) >= 5])


def _session_tensors(sf):
    """The tensors a session holds, one level into its tuples, lists,
    dicts and band wrappers."""
    seen = []

    def walk(x, depth):
        if isinstance(x, torch.Tensor):
            seen.append(x)
        elif depth and isinstance(x, (tuple, list)):
            for y in x:
                walk(y, depth - 1)
        elif depth and isinstance(x, dict):
            for y in x.values():
                walk(y, depth - 1)
        elif depth and isinstance(x, bs.BandedMatrix):
            walk(x.data, depth - 1)

    for v in vars(sf).values():
        walk(v, 3)
    return seen


def _rank_main(rank, world, case_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(case_dir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        np.savez(os.path.join(case_dir, f"rank{rank}.npz"),
                 **_world_job(world))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved results, from one spawn of 2 gloo ranks."""
    case_dir = str(tmp_path_factory.mktemp("rest"))
    mp.spawn(_rank_main, args=(WORLD, case_dir), nprocs=WORLD, join=True)
    return [dict(np.load(os.path.join(case_dir, f"rank{r}.npz")))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The port's single-device runs of the same settings."""
    out = {}
    for tag, settings in GO_RUNS.items():
        sf = _session(GO, **settings)
        sf.run_pipeline()
        out[tag] = {}
        _keep_band_go(out[tag], "s", sf)
    for tag, settings in QUANT_RUNS.items():
        sf = _session(QUANT, **settings)
        sf.run_pipeline(perm_idx=PERM_IDX)
        out[tag] = {}
        _keep_quant(out[tag], "s", sf)
    return out


def _jax_session(vals, **settings):
    """The JAX facade on a 2-device 'data' mesh, on NET as a networkx
    graph (its arrays are NET's)."""
    import jax
    import networkx as nx
    import pandas as pd
    from jax.sharding import Mesh
    from safepy_tpu import SAFE as JaxSAFE

    coords, edges, lengths, _ = NET
    g = nx.Graph()
    g.add_nodes_from(range(N))
    for (i, j), ln in zip(edges, lengths):
        g.add_edge(int(i), int(j), length=float(ln))
    for i in range(N):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode, jsf.random_seed = "band", 7
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jsf.load_network(network_file=g, node_key_attribute="key")
    np.testing.assert_array_equal(jsf._graph_to_arrays_cached()[1], edges)
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(N)],
        columns=[f"t{j}" for j in range(vals.shape[1])]))
    return jsf


def _assert_fw_distances(got, want):
    """The sharded FW relaxes every in-band tile as the classic band FW
    does; the single-device symmetric FW mirrors its lower tiles, which
    associate (q + d) + p as q + (d + p): the same reach, the distances
    within 1e-6 (tests/test_torch_band_sharded.py)."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    same = got == want
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return np.where(same, 0.0, diff / np.spacing(np.abs(want)))


# ------------------------------------------------------------------ band GO

@pytest.mark.parametrize("tag,engine", [
    ("table", "table-band-sharded"), ("loop", "loop-band-sharded"),
    ("table-packed", "table-band-sharded"),
    ("loop-nokeep", "loop-band-sharded")])
def test_band_go_matches_single_device(ranks, single, tag, engine):
    """Every rank's indicator band, distances, nes_binary, counts and log
    sf equal the single-device engine's (``table-band`` / ``loop-band``)
    bit for bit; the FW relaxes the band."""
    want = single[tag]
    assert str(want["s-engine"][1]) == engine.replace("-sharded", "")
    for got in ranks:
        assert list(got[f"{tag}-engine"]) == ["band-storage", engine, "fw"]
        for name in ("nes_binary", "logsf", "enriched", "band"):
            np.testing.assert_array_equal(got[f"{tag}-{name}"],
                                          want[f"s-{name}"], err_msg=name)
        _assert_fw_distances(got[f"{tag}-dist"], want["s-dist"])
    assert ranks[0][f"{tag}-enriched"].sum() > 0


@pytest.mark.parametrize("tag", ["table", "loop"])
def test_band_go_matches_jax_sharded(ranks, tag):
    """Against JAX's table-band-sharded / loop-band-sharded on 2 virtual
    devices: nes_binary, counts and the indicator band exactly; the log
    sf within 1 ulp + 1e-11 (table) or 4 f32 ulps (loop)."""
    jsf = _jax_session(GO, **GO_RUNS[tag])
    jsf.run_pipeline()
    assert jsf._hypergeom_engine_used == f"{tag}-band-sharded"
    want_logsf = np.asarray(jsf._logsf_dev)
    for got in ranks:
        np.testing.assert_array_equal(got[f"{tag}-nes_binary"],
                                      jsf.nes_binary)
        np.testing.assert_array_equal(
            got[f"{tag}-enriched"],
            jsf.attributes["num_neighborhoods_enriched"])
        np.testing.assert_array_equal(got[f"{tag}-band"],
                                      np.asarray(jsf._neighborhoods_dev.data))
        logsf = got[f"{tag}-logsf"]
        if tag == "table":
            w = want_logsf.astype(np.float32)
            assert np.all(np.abs(logsf.astype(np.float64) - w)
                          <= np.spacing(np.abs(w)) + 1e-11)
        else:
            assert _ulps(logsf, want_logsf).max() <= 4
    if tag == "table":
        j = jsf._hbm_plan_last
        for got in ranks:
            np.testing.assert_array_equal(got["plan"],
                                          [j[k] for k in PLAN_KEYS])


def test_band_table_small_chunks_match_jax_sharded(ranks):
    """The sharded class table in chunks of SMALL_CHUNK columns (several
    chunks, the last one narrower) on the facade's own inputs: the log sf,
    indicator and counts equal the one-chunk run's (a cell's value does
    not depend on its chunk); against JAX's hypergeom_band_table_sharded
    at the same chunk_cols on 2 virtual devices, the indicator and counts
    exactly and the log sf within 1 ulp + 1e-11."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from safepy_tpu.parallel import band_sharded as jbsh

    got = ranks[0]
    widths = got["chunked-widths"]
    assert len(widths) == -(-TERMS // SMALL_CHUNK) >= 3
    assert widths.sum() == TERMS and widths[-1] < SMALL_CHUNK
    M, thr, n, band = got["chunked-args"]
    j = jbsh.hypergeom_band_table_sharded(
        jnp.asarray(got["chunked-ind"]), got["chunked-nan0"],
        got["chunked-nnn"], int(M), thr,
        mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)), n=int(n),
        band=int(band), rank_np=got["chunked-rank"],
        chunk_cols=SMALL_CHUNK, K_np=got["chunked-K"])
    j_logsf, j_nbin, j_counts = (np.asarray(x) for x in j)
    w = j_logsf.astype(np.float32)
    for r in ranks:
        np.testing.assert_array_equal(r["chunked-ind"], got["chunked-ind"])
        np.testing.assert_array_equal(r["chunked-nbin"], r["table-nes_binary"])
        np.testing.assert_array_equal(r["chunked-counts"],
                                      r["table-enriched"])
        np.testing.assert_array_equal(r["chunked-logsf"], r["table-logsf"])
        np.testing.assert_array_equal(r["chunked-nbin"], j_nbin)
        np.testing.assert_array_equal(r["chunked-counts"], j_counts)
        assert np.all(np.abs(r["chunked-logsf"].astype(np.float64) - w)
                      <= np.spacing(np.abs(w)) + 1e-11)
    assert got["chunked-counts"].sum() > 0


def test_shard_guard_fields_and_refusal(ranks):
    """The per-rank plan: JAX's terms plus the port's transients (the
    staging piece, the ghost operand rows, the prep chunk) and the host
    fields, each by its formula at the run's band; a budget below it
    raises the plan's ValueError before the operand prep or the front, and
    the message no longer says that more ranks do not help."""
    from safepy_tpu_torch import hbm

    for got in ranks:
        fields = dict(zip(PORT_FIELDS, got["plan-fields"]))
        want = hbm.band_go_shard_hbm_plan(N, int(got["plan-band"]), TERMS,
                                          WORLD, packed=False)
        for k in PORT_FIELDS:
            assert fields[k] == want[k], k
        assert fields["stage_buffer"] > 0 and fields["prep_chunk"] > 0
        assert fields["per_rank_peak"] == (
            fields["per_shard_peak"] + fields["stage_buffer"]
            + fields["ghost_operands"] + fields["prep_chunk"])
        assert fields["host_outputs"] == 5 * N * TERMS
        assert "does not fit per rank" in str(got["guard"])
        assert "more 'data' ranks lower the peak" in str(got["guard"])
        assert "do not make it fit" not in str(got["guard"])
        assert bool(got["guard-untouched"])


def test_c10_per_rank_budget_runs_and_results_live_on_the_host(ranks,
                                                               single):
    """C10: a budget above the per-rank plan and below the parent's, whose
    guard counted the bands, (n, A) outputs and operands every rank held:
    the run is taken, its indicator band, nes_binary, counts and log sf
    are the single-device table-band run's bit for bit, and what the
    session keeps is the engine's host buffers, with only the rank's
    window of the operands on its device."""
    want = single["table"]
    for got in ranks:
        new, budget, parent = got["c10-budgets"]
        assert new < budget < parent
        assert list(got["c10-engine"]) == ["band-storage",
                                           "table-band-sharded", "fw"]
        for name in ("nes_binary", "logsf", "enriched", "band"):
            np.testing.assert_array_equal(got[f"c10-{name}"],
                                          want[f"s-{name}"], err_msg=name)
        _assert_fw_distances(got["c10-dist"], want["s-dist"])
        assert got["c10-host"].all(), got["c10-host"]


# --------------------------------------------------------- packed and euclid

@pytest.mark.parametrize("tag", sorted(QUANT_RUNS))
def test_quantitative_runs_match_single_device(ranks, single, tag):
    """The packed band, its int8 twin and the euclidean band (kept and
    packed) on the mesh: bands (and kept distances) bitwise, scores and
    counts exactly the single-device runs' with the same permutations."""
    want = single[tag]
    for got in ranks:
        assert str(got[f"{tag}-engine"]) == "band-storage"
        for name in ("band", "dist", "ns", "counts_neg", "counts_pos"):
            np.testing.assert_array_equal(got[f"{tag}-{name}"],
                                          want[f"s-{name}"], err_msg=name)
    packed = tag.endswith("packed")
    assert (ranks[0][f"{tag}-band"].dtype == np.uint8) == packed


def test_packed_band_is_the_int8_band_packed(ranks):
    """The sharded packed band equals pack_band_bits of the sharded int8
    band (LSB-first), rank by rank."""
    for got in ranks:
        np.testing.assert_array_equal(
            got["packed-band"],
            bs.pack_band_bits(torch.as_tensor(got["int8-band"])).numpy())
        np.testing.assert_array_equal(got["packed-ns"], got["int8-ns"])
        np.testing.assert_array_equal(got["packed-counts_pos"],
                                      got["int8-counts_pos"])


@pytest.mark.parametrize("tag", ["packed", "euclid-keep", "euclid-packed"])
def test_quantitative_runs_match_jax_sharded(ranks, tag):
    """Against JAX's sharded band engines on 2 virtual devices: the band's
    bytes (and kept distances) exactly, scores within 1e-5."""
    settings = dict(QUANT_RUNS[tag])
    metric = settings.pop("node_distance_metric", None)
    jsf = _jax_session(QUANT, **settings)
    jsf.run_pipeline(num_permutations=16,
                     **({"node_distance_metric": metric} if metric else {}))
    for got in ranks:
        np.testing.assert_array_equal(got[f"{tag}-band"],
                                      np.asarray(jsf._neighborhoods_dev.data))
        if got[f"{tag}-dist"].size:
            np.testing.assert_array_equal(
                got[f"{tag}-dist"], np.asarray(jsf._node_distances_dev.data))
        np.testing.assert_array_equal(np.isnan(got[f"{tag}-ns"]),
                                      np.isnan(jsf.ns))
        np.testing.assert_allclose(got[f"{tag}-ns"], jsf.ns, rtol=1e-5,
                                   atol=1e-5)
