"""The dense engines on a mesh: the port's row-sharded and 2-D FW
(parallel/apsp_sharded.py, apsp_sharded_2d.py), its sharded null
(parallel/permutation_sharded.py) and attribute-sharded census
(parallel/hypergeom_sharded.py), alone and through the facade, over gloo
ranks on the CPU, against the JAX package's shard_map engines on a virtual
CPU mesh of as many devices and against the port's single-device runs.

Each world size runs in one ``torch.multiprocessing.spawn`` of gloo ranks
(a ``file://`` rendezvous in a temporary directory), which does all of
that world's work and saves each rank's results; the comparisons run here.
The spawned ranks import this module, so it imports no JAX at module
level.

Tolerances: the FW distances bitwise (JAX's sharded FW, the port's classic
``ops.apsp``: each candidate one f32 add, ``min`` exact); neighborhoods,
scores and null counts exactly equal (dyadic attribute values: every f32
sum exact in any order), the counts against the single-device port, JAX's
permutation pieces fed the same indices, and each rank's stream replayed
on one device; the census exactly; the attribute-sharded log-survival
within 4 f32 ulps of JAX's (XLA's and torch's f32 ``exp``/``log1p``
round differently, tests/test_torch_hypergeom.py) and bitwise equal to
the port's unsharded run, its indicator and counts exactly; the sharded
staged p-values within 1e-6 of the single-device stages (finalized on the
device in f32 against the host in f64), as JAX's
tests/test_facade_mesh.py holds them.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import apsp as classic_fw
from safepy_tpu_torch.ops import permutation as pperm
from safepy_tpu_torch.ops.neighborhoods import initial_distances_device
from safepy_tpu_torch.parallel import (apsp_sharded, apsp_sharded_2d,
                                       hypergeom_counts_sharded,
                                       hypergeom_enrichment_sharded,
                                       make_mesh, run_permutations_sharded)
from safepy_tpu_torch.parallel import permutation_sharded as ps
from safepy_tpu_torch.parallel.mesh import fw_sharding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, BLOCK, PERMS, SEED, ATTRS = 260, 64, 20, 7, 11
F32_ULP = 2.0 ** -23


def _arrays(n=N, k=6, seed=31):
    """(coords, edges, lengths, weights) of a kNN geometric graph."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


NET = _arrays()
# dyadic values, 30% of the rows unannotated
VALS = np.random.default_rng(32).integers(-12, 13, (N, 2)) / 4
VALS[np.random.default_rng(33).random(N) < 0.3] = np.nan
V = int(np.isfinite(VALS).any(axis=1).sum())
PERM_IDX = np.stack([np.random.default_rng(40 + i).permutation(V)
                     for i in range(PERMS)])


def _go(n=N, a=ATTRS, seed=34):
    """Binary terms of members near random centres, 10% rows NaN."""
    rng = np.random.default_rng(seed)
    coords = NET[0]
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.2, 0.6))
        out[:, j] = (near & (rng.random(n) < 0.5)) | (rng.random(n) < 0.03)
    out[rng.random(n) < 0.1] = np.nan
    return out


GO = _go()


def _d0():
    return initial_distances_device(N, NET[1], NET[2], device="cpu")


def _session(vals=VALS, mesh=None, **settings):
    sf = SAFE(device="cpu", verbose=False)
    sf.random_seed = SEED
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.mesh = mesh
    sf.load_network(network_file=NET)
    sf.load_attributes(attribute_file=vals)
    return sf


def _keep(out, tag, sf, names=("neighborhoods", "ns", "counts_neg",
                               "counts_pos")):
    out[f"{tag}-engine"] = np.array(sf.apsp_engine_used)
    out[f"{tag}-num_permutations"] = np.array(sf.num_permutations)
    for name in names:
        out[f"{tag}-{name}"] = np.asarray(getattr(sf, name))


# ------------------------------------------------------------ the ranks' side

def _world_job(world):
    """Everything one world size computes, on one rank."""
    out = {}
    data = make_mesh({"data": world}, device_type="cpu")
    out["fw_rows"] = apsp_sharded(_d0(), data, block=BLOCK).numpy()
    # the fused quantitative run: the FW row-sharded, the null split
    sf = _session(mesh=data)
    sf.run_pipeline(perm_idx=PERM_IDX)
    _keep(out, "data", sf)
    perm = make_mesh({"perm": world}, device_type="cpu")
    # a seeded run on a 'perm' mesh, 31 permutations asked for: each rank
    # its own stream, the total rounded up
    sf = _session(mesh=perm)
    sf.run_pipeline(num_permutations=31)
    _keep(out, "perm", sf)
    if world == 2:
        # the stages on a 'perm' mesh (the null sharded), on a 'data' mesh
        # (the FW sharded) and a pickle of a mesh session
        sf = _session(mesh=perm)
        sf.define_neighborhoods()
        sf.compute_pvalues(num_permutations=31)
        _keep(out, "perm-staged", sf)
        sf = _session(mesh=data)
        sf.define_neighborhoods()
        sf.compute_pvalues(perm_idx=PERM_IDX)
        _keep(out, "data-staged", sf)
        back = pickle.loads(pickle.dumps(sf))
        out["pickled-mesh"] = np.array(back.mesh is None)
        out["pickled-neighborhoods"] = back.neighborhoods
        # the attribute-sharded census and enrichment, alone and through
        # the facade (fused over the banded window; the stages)
        attr = make_mesh({"attr": world}, device_type="cpu")
        nbr = torch.as_tensor(out["data-neighborhoods"], dtype=torch.float32)
        counts, nsize = hypergeom_counts_sharded(nbr, GO, mesh=attr)
        out["census-counts"], out["census-nsize"] = counts.numpy(), \
            nsize.numpy()
        for i, x in enumerate(hypergeom_enrichment_sharded(nbr, GO,
                                                           mesh=attr)):
            out[f"enrich-{i}"] = x.numpy()
        for tag, mesh, staged in (("attr", attr, False),
                                  ("attr-staged", attr, True),
                                  ("data-binary", data, False)):
            sf = _session(GO, mesh=mesh)
            if staged:
                sf.define_neighborhoods()
                sf.compute_pvalues()
            else:
                sf.run_pipeline()
            out[f"{tag}-hengine"] = np.array(sf._hypergeom_engine_used)
            _keep(out, tag, sf, ("neighborhoods", "nes_binary",
                                 "pvalues_pos"))
            out[f"{tag}-logsf"] = sf._logsf_dev.numpy()
            out[f"{tag}-enriched"] = np.asarray(
                sf.attributes["num_neighborhoods_enriched"])
        # the band runs on a 'data' mesh: the row-sharded band engine
        for case in BAND_CASES:
            out.update(_band_case(case, data))
    else:
        grid = make_mesh({"row": 2, "col": world // 2}, device_type="cpu")
        out["fw_2d"] = apsp_sharded_2d(_d0(), grid, block=BLOCK).numpy()
        sf = _session(mesh=grid)
        sf.run_pipeline(perm_idx=PERM_IDX)
        _keep(out, "2d", sf)
        sf = _session(mesh=grid)
        sf.define_neighborhoods()
        out["2d-staged-neighborhoods"] = sf.neighborhoods
        # the op: 30 permutations over 4 ranks round up to 32
        nbr = torch.as_tensor(out["2d-neighborhoods"], dtype=torch.float32)
        n2a = torch.as_tensor(VALS, dtype=torch.float32)
        valid = torch.as_tensor(np.flatnonzero(np.isfinite(VALS).any(1)))
        obs = nbr @ torch.where(torch.isfinite(n2a), n2a, 0.0)
        cn, cp, total = run_permutations_sharded(nbr, n2a, valid, obs, SEED,
                                                 mesh=perm,
                                                 num_permutations=30)
        out["op-cn"], out["op-cp"] = cn.numpy(), cp.numpy()
        out["op-total"] = np.array(total)
    return out


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
def world_runs(tmp_path_factory):
    """world -> each rank's saved results, from one spawn of ``world`` gloo
    ranks at the first request."""
    done = {}

    def run(world):
        if world not in done:
            case_dir = str(tmp_path_factory.mktemp(f"world{world}"))
            mp.spawn(_rank_main, args=(world, case_dir), nprocs=world,
                     join=True)
            done[world] = [dict(np.load(os.path.join(case_dir,
                                                     f"rank{r}.npz")))
                           for r in range(world)]
        return done[world]

    return run


# ---------------------------------------------------------- single device

@pytest.fixture(scope="module")
def single():
    """The port's single-device runs on the same inputs: the fused
    quantitative run with the same permutations, and the binary runs."""
    sf = _session()
    sf.run_pipeline(perm_idx=PERM_IDX)
    go = _session(GO)
    go.run_pipeline()
    staged = _session(GO)
    staged.define_neighborhoods()
    staged.compute_pvalues()
    return dict(quant=sf, go=go, go_staged=staged)


def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    sizes = tuple(axes.values())
    devices = np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return Mesh(devices, tuple(axes))


# ------------------------------------------------------------------ the FW

@pytest.mark.parametrize("world,key", [(2, "fw_rows"), (4, "fw_rows"),
                                       (4, "fw_2d")])
def test_sharded_fw_matches_jax_and_classic(world_runs, world, key):
    """Every rank's whole matrix bitwise JAX's sharded FW on as many
    devices (``use_pallas=False``) and the port's classic FW."""
    import jax.numpy as jnp
    from safepy_tpu.parallel import apsp_sharded as japsp
    from safepy_tpu.parallel import apsp_sharded_2d as japsp2

    d0 = _d0()
    if key == "fw_rows":
        want = np.asarray(japsp(
            jnp.asarray(d0.numpy()), _jax_mesh({"data": world}),
            block=BLOCK, use_pallas=False))
    else:
        want = np.asarray(japsp2(
            jnp.asarray(d0.numpy()), _jax_mesh({"row": 2, "col": 2}),
            block=BLOCK, use_pallas=False))
    classic = classic_fw(d0, block=BLOCK).numpy()
    np.testing.assert_array_equal(want, classic)
    assert np.isfinite(classic).mean() > 0.9
    for got in world_runs(world):
        np.testing.assert_array_equal(got[key], classic)


def test_sharded_fw_pads_to_whole_blocks_a_rank():
    """One rank: the row slab is the whole padded matrix; a size that no
    block divides comes back cut to N."""
    import tempfile

    d0 = _d0()[:197, :197].contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            got = apsp_sharded(d0, make_mesh({"data": 1}, device_type="cpu"),
                               block=BLOCK)
            got2 = apsp_sharded_2d(d0, make_mesh({"row": 1, "col": 1},
                                                 device_type="cpu"),
                                   block=BLOCK)
        finally:
            dist.destroy_process_group()
    want = classic_fw(d0, block=BLOCK)
    assert tuple(got.shape) == (197, 197)
    assert torch.equal(got, want) and torch.equal(got2, want)


# ------------------------------------------------------------- the facade

@pytest.mark.parametrize("world,tag,engine", [
    (2, "data", "dense-sharded"), (4, "data", "dense-sharded"),
    (4, "2d", "dense-sharded-2d")])
def test_mesh_run_matches_single_device(world_runs, single, world, tag,
                                        engine):
    """The fused quantitative run on a 'data' or (row, col) mesh (no banded
    window: the FW is sharded) and the same permutations: every rank gets
    the single-device run's neighborhoods, scores and counts."""
    sf = single["quant"]
    assert sf.apsp_engine_used == "banded-window"
    for got in world_runs(world):
        assert str(got[f"{tag}-engine"]) == engine
        assert int(got[f"{tag}-num_permutations"]) == PERMS
        for name in ("neighborhoods", "ns", "counts_neg", "counts_pos"):
            np.testing.assert_array_equal(got[f"{tag}-{name}"],
                                          getattr(sf, name), err_msg=name)


def test_mesh_counts_match_jax_pieces(world_runs, single):
    """JAX's permutation pieces fed the same indices on its own
    neighborhoods and scores give the sharded run's counts."""
    import jax.numpy as jnp
    from safepy_tpu.ops import permutation as jperm
    from safepy_tpu.ops import score as jscore

    got = world_runs(2)[0]
    nbr = jnp.asarray(got["data-neighborhoods"], jnp.float32)
    obs = np.asarray(jscore.compute_neighborhood_score(nbr, VALS, "sum"))
    valid = np.flatnonzero(np.isfinite(VALS).any(axis=1))
    nv, v, m = jperm.prepare_valid(nbr, jnp.asarray(VALS, jnp.float32), valid)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(PERM_IDX), "sum"))
    np.testing.assert_array_equal(got["data-ns"], obs)
    np.testing.assert_array_equal(got["data-counts_neg"],
                                  (scores <= obs[None]).sum(0))
    np.testing.assert_array_equal(got["data-counts_pos"],
                                  (scores >= obs[None]).sum(0))


@pytest.mark.parametrize("world,tag", [(2, "perm"), (4, "perm"),
                                       (2, "perm-staged")])
def test_sharded_null_is_the_ranks_streams_replayed(world_runs, world, tag):
    """A seeded run on a 'perm' mesh: 31 permutations round up to a
    multiple of the rank count, and the counts are each rank's stream
    (``rank_seed(seed, rank)``) replayed on one device and summed (JAX's
    test_run_pipeline_mesh_fused_permutation_exact_replay)."""
    ranks = world_runs(world)
    per_dev = -(-31 // world)
    got = ranks[0]
    assert int(got[f"{tag}-num_permutations"]) == per_dev * world
    nbr = torch.as_tensor(got[f"{tag}-neighborhoods"], dtype=torch.float32)
    n2a = torch.as_tensor(VALS, dtype=torch.float32)
    valid = torch.as_tensor(np.flatnonzero(np.isfinite(VALS).any(axis=1)))
    nv, v, m = pperm.prepare_valid(nbr, n2a, valid)
    obs = torch.as_tensor(got[f"{tag}-ns"], dtype=torch.float32)
    batch = pperm.default_batch_size(V, 2, per_dev)
    want = [np.zeros(obs.shape, np.int64), np.zeros(obs.shape, np.int64)]
    for r in range(world):
        g = torch.Generator().manual_seed(ps.rank_seed(SEED, r))
        for i, c in enumerate(pperm.scan_counts(
                nv, v, m, obs, score_type="sum", num_permutations=per_dev,
                batch_size=batch, generator=g)):
            want[i] += c.numpy()
    for r in ranks:
        np.testing.assert_array_equal(r[f"{tag}-counts_neg"], want[0])
        np.testing.assert_array_equal(r[f"{tag}-counts_pos"], want[1])
    assert world == 2 or not np.array_equal(want[0], world_runs(2)[0][
        "perm-counts_neg"])


def test_round_up_of_the_op(world_runs):
    """``run_permutations_sharded``: 30 permutations on 4 ranks are 32, the
    counts each rank's stream."""
    for got in world_runs(4):
        assert int(got["op-total"]) == 32
        assert (got["op-cn"] + got["op-cp"] >= 32).all()
        np.testing.assert_array_equal(got["op-cn"], world_runs(4)[0]["op-cn"])


def test_stages_on_a_mesh(world_runs, single):
    """define_neighborhoods on a 'data' mesh (no band storage, no banded
    window: the sharded FW) and on a (row, col) mesh give the
    single-device neighborhoods; compute_pvalues with the same
    permutations its counts; a mesh session pickles without its mesh."""
    sf = single["quant"]
    got = world_runs(2)[1]
    assert str(got["data-staged-engine"]) == "dense-sharded"
    for name in ("neighborhoods", "ns", "counts_neg", "counts_pos"):
        np.testing.assert_array_equal(got[f"data-staged-{name}"],
                                      getattr(sf, name))
    assert bool(got["pickled-mesh"])
    np.testing.assert_array_equal(got["pickled-neighborhoods"],
                                  sf.neighborhoods)
    for r in world_runs(4):
        np.testing.assert_array_equal(r["2d-staged-neighborhoods"],
                                      sf.neighborhoods)


# -------------------------------------------------------- the attr axis

def test_attr_census_matches_jax(world_runs):
    """hypergeom_counts_sharded / hypergeom_enrichment_sharded on 2 ranks
    (11 columns padded to 12) against JAX's on a 2-device 'attr' mesh."""
    import jax.numpy as jnp
    from safepy_tpu.parallel import (hypergeom_counts_sharded as jcounts,
                                     hypergeom_enrichment_sharded as jenrich)

    mesh = _jax_mesh({"attr": 2})
    for got in world_runs(2):
        nbr = got["data-neighborhoods"].astype(np.float32)
        counts, nsize = jcounts(nbr, GO, mesh=mesh)
        np.testing.assert_array_equal(got["census-counts"],
                                      np.asarray(counts))
        np.testing.assert_array_equal(got["census-nsize"], np.asarray(nsize))
        want = jenrich(jnp.asarray(nbr), GO, mesh=mesh)
        for i in (0, 1):
            w = np.asarray(want[i], np.float32)
            g = got[f"enrich-{i}"]
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            assert np.all(np.abs(g[fin] - w[fin])
                          <= 4 * F32_ULP * np.abs(w[fin]) + 1e-30)
        np.testing.assert_array_equal(got["enrich-2"], np.asarray(want[2]))
        np.testing.assert_array_equal(got["enrich-3"], np.asarray(want[3]))


def test_attr_mesh_binary_runs(world_runs, single):
    """The fused binary run on an 'attr' mesh (the banded window, the
    census and survival split over the columns) is bitwise the unsharded
    run; the stages take the attribute-sharded engine
    (``loop-dense-attr-sharded``); the fused run on a 'data' mesh (the FW
    sharded, the tail whole) equals the single-device one."""
    go, staged = single["go"], single["go_staged"]
    for got in world_runs(2):
        assert str(got["attr-engine"]) == "banded-window"
        assert str(got["attr-hengine"]) == go._hypergeom_engine_used
        assert str(got["data-binary-engine"]) == "dense-sharded"
        for tag in ("attr", "data-binary"):
            np.testing.assert_array_equal(got[f"{tag}-logsf"],
                                          go._logsf_dev.numpy())
            np.testing.assert_array_equal(got[f"{tag}-nes_binary"],
                                          go.nes_binary)
            np.testing.assert_array_equal(
                got[f"{tag}-enriched"],
                go.attributes["num_neighborhoods_enriched"])
        assert str(got["attr-staged-hengine"]) == "loop-dense-attr-sharded"
        np.testing.assert_array_equal(got["attr-staged-nes_binary"],
                                      staged.nes_binary)
        assert np.nanmax(np.abs(got["attr-staged-pvalues_pos"]
                                - staged.pvalues_pos)) <= 1e-6


# ------------------------------------------- the FW rule and the band runs

@pytest.mark.parametrize("names,want", [
    ((), None), (("perm",), None), (("attr",), None), (("data",), "data"),
    (("data", "perm"), "data"), (("row", "col"), "2d"),
    (("data", "row", "col"), "2d"), (("row",), None)])
def test_fw_sharding_rule(names, want):
    """One rule names the FW a mesh takes, for the pipeline's dispatch and
    the facade's engine (JAX ``pipeline.py:43-84``): ``row`` and ``col``
    before ``data``."""
    mesh = SimpleNamespace(mesh_dim_names=names) if names else None
    assert fw_sharding(mesh) == want
    sf = SAFE(device="cpu", verbose=False)
    sf.mesh = mesh
    assert sf._sharded_fw() == (want is not None)


BAND_CASES = {"band GO": (GO, {}),
              "euclidean band": (VALS, dict(node_distance_metric="euclidean")),
              "bit-packed band": (VALS, dict(band_indicator_bits=True))}


def _band_case(case, mesh=None):
    """One BAND_CASES run over band storage (on ``mesh``, or one device):
    its engines, indicator band and results, keyed by the case."""
    vals, settings = BAND_CASES[case]
    sf = _session(vals, mesh=mesh, apsp_mode="band", **settings)
    if case == "band GO":
        sf.run_pipeline()
        names = ("nes_binary", "pvalues_pos")
    else:
        sf.run_pipeline(perm_idx=PERM_IDX)
        names = ("ns", "counts_neg", "counts_pos")
    out = {f"{case}-engine": np.array([sf.apsp_engine_used,
                                       str(sf._hypergeom_engine_used)]),
           f"{case}-band": sf._neighborhoods_dev.data.numpy()}
    for name in names:
        out[f"{case}-{name}"] = np.asarray(getattr(sf, name))
    return out


@pytest.mark.parametrize("case", ["band GO", "euclidean band",
                                  "bit-packed band"])
def test_band_branches_on_a_data_mesh_still_refused(world_runs, case):
    """What JAX sends to the row-sharded band engine beyond its
    quantitative run (band GO, the euclidean band pipeline, a packed band)
    was refused, naming ROADMAP A10 remainder, until the rest of the band
    engine was ported. On a 2-rank 'data' mesh each now runs over band
    storage and gives every rank the single-device run's indicator band
    and results: band GO by the sharded class table, the others with the
    same permutations (dyadic values: exact counts)."""
    want = _band_case(case)
    engine = "table-band-sharded" if case == "band GO" else "None"
    for got in world_runs(2):
        assert list(got[f"{case}-engine"]) == ["band-storage", engine]
        for key, value in want.items():
            if not key.endswith("-engine"):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert (want[f"{case}-band"].dtype == np.uint8) == (
        case == "bit-packed band")
