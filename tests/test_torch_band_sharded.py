"""The port's row-sharded band engine (safepy_tpu_torch/parallel/band_sharded.py)
over gloo ranks on the CPU, against the JAX package's shard_map engine
(safepy_tpu/parallel/band_sharded.py) on a virtual CPU mesh of as many
devices, and against the port's own single-device band engine.

Each world size runs in one ``torch.multiprocessing.spawn`` of gloo ranks
(a ``file://`` rendezvous in a temporary directory), which does all of that
world's work and saves each rank's results; the comparisons run here. The
spawned ranks import this module, so it imports no JAX at module level.

Tolerances: the FW bands bitwise against JAX's sharded engine and the
port's classic (``symmetric=False``) band FW, which relax every in-band tile
as the sharded rows do (each min-plus candidate is one f32 rounding and min
is exact); against the symmetric band FW, whose mirrored lower tiles
associate (q + d) + p as q + (d + p), identical indicators and distances
within 1e-6; observed scores within 1e-5 of JAX's (the matmul sums
associate differently); null counts exactly equal to the single-device port
engine's and to the JAX band pieces' given the same permutations (dyadic
attribute values, exact f32 sums in any order); with each package's own
RNG, p-values within the binomial tolerance of
tests/test_reference_parity.py:193.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE
from safepy_tpu_torch import pipeline as pipe
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.ops import apsp_cuda as K
from safepy_tpu_torch.ops.apsp_banded import banded_order
from safepy_tpu_torch.ops.neighborhoods import inclusive_radius
from safepy_tpu_torch.parallel import band_sharded as bsh
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


FW_NODES, PIPE_NODES, FACADE_NODES, BLOCK = 900, 700, 600, 64
PIPE_PERMS, FACADE_PERMS = 40, 80


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _arrays(n, k, seed):
    """(coords, edges, lengths, weights) of a kNN geometric graph."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def _plan(n, k, seed):
    """(permuted edges, lengths, rank, band, radius) in banded order."""
    coords, edges, lengths, _ = _arrays(n, k, seed)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return rank[edges], lengths.astype(np.float32), rank, band, nr


def _init(pe, lengths, n, band):
    return bs.band_init_from_edges(_t(pe[:, 0]), _t(pe[:, 1]), _t(lengths),
                                   n=n, band=band, block=BLOCK)


def _pipe_case():
    """The pipeline's inputs, replicated on every rank: dyadic attribute
    values, so every f32 sum is exact in any order."""
    n = PIPE_NODES
    pe, lengths, rank, band, nr = _plan(n, 6, 1)
    rng = np.random.default_rng(0)
    vals = rng.integers(-12, 13, (n, 2)) / 4
    vals[rng.random(n) < 0.3] = np.nan
    vals_perm = vals[np.argsort(rank)].astype(np.float32)
    valid = np.isfinite(vals_perm).any(axis=1)
    starts, w_c = bs.compaction_plan(valid, n=n, bt=band // BLOCK + 1,
                                     block=BLOCK)
    v = int(valid.sum())
    perm_idx = np.stack([rng.permutation(v) for _ in range(PIPE_PERMS)])
    return dict(pe=pe, lengths=lengths, rank=rank, band=band,
                radius=float(inclusive_radius(nr)), vals_perm=vals_perm,
                valid=valid, starts=starts, w_c=w_c, perm_idx=perm_idx)


def _pipe_args(c):
    return (_t(c["pe"][:, 0]), _t(c["pe"][:, 1]), _t(c["lengths"]),
            _t(c["vals_perm"]), _t(c["vals_perm"][c["valid"]]),
            _t(c["valid"]), _t(c["starts"]), _t(c["rank"]), None,
            c["radius"])


def _pipe_kw(c, score_type):
    return dict(n=PIPE_NODES, band=int(c["band"]), block=BLOCK,
                score_type=score_type, num_permutations=PIPE_PERMS,
                batch_size=16, w_c=int(c["w_c"]), perm_idx=c["perm_idx"])


def _unsharded_pipeline(c, score_type, keep_distances):
    """The single-device band run on the sharded engine's inputs: the front
    (``band_neighborhoods``), then the null tail (``_band_perm_tail``).
    (dist_band or None, ind, obs, counts_neg, counts_pos, mean, std)."""
    args, kw = _pipe_args(c), _pipe_kw(c, score_type)
    n, band = kw.pop("n"), kw.pop("band")
    dist_band, ind, mean, std, converged = pipe.band_neighborhoods(
        *args[:3], args[-1], n=n, band=band, block=BLOCK,
        keep_distances=keep_distances)
    assert converged
    obs, cn, cp = pipe._band_perm_tail(
        ind, *args[3:-1], bt=bs.band_params(n, band, BLOCK)[0],
        precision="highest", **kw)
    return dist_band, ind, obs, cn, cp, mean, std


# ------------------------------------------------------------ the ranks' side

PIPE_RUNS = {2: [("sum", True), ("z-score", False)],
             4: [("sum", False), ("z-score", True)]}


def _world_job(mesh, world, case_dir):
    """Everything one world size computes, on one rank."""
    out = {}
    fw = np.load(os.path.join(case_dir, "fw.npz"))
    n, band = FW_NODES, int(fw["band"])
    bt, nb, width, g_pad, _ = bsh.sharded_band_geometry(n, band, world,
                                                        BLOCK)
    s = torch.full((g_pad * BLOCK, width), float("inf"))
    s[:fw["s0"].shape[0]] = _t(fw["s0"])
    out["fw"] = bsh.apsp_band_fw_sharded(s, mesh=mesh, n=n, band=band,
                                         block=BLOCK).numpy()
    try:
        make_mesh({"data": world + 1}, device_type="cpu")
    except ValueError as e:
        out["bad_axes"] = np.array(str(e))

    c = dict(np.load(os.path.join(case_dir, "pipe.npz")))
    for score_type, keep in PIPE_RUNS.get(world, []):
        res = bsh.fused_permutation_pipeline_band_sharded(
            *_pipe_args(c), mesh=mesh, keep_distances=keep,
            **_pipe_kw(c, score_type))
        tag = f"{score_type}-{keep}"
        out[f"{tag}-dist"] = (np.zeros(0) if res[0] is None
                              else res[0].numpy())
        for i, name in enumerate(("ind", "obs", "cn", "cp"), start=1):
            out[f"{tag}-{name}"] = res[i].numpy()
        out[f"{tag}-stats"] = np.array([float(res[5]), float(res[6])])

    if world == 2:
        nbr = bsh.band_neighborhoods_sharded(
            *_pipe_args(c)[:3], c["radius"], mesh=mesh, n=PIPE_NODES,
            band=int(c["band"]), block=BLOCK)
        out["front-dist"], out["front-ind"] = nbr[0].numpy(), nbr[1].numpy()
        out["front-sizes"] = nbr[2].numpy()
        x = c["vals_perm"][:, :1].copy()
        x[~np.isfinite(x)] = 0
        out["matmul"] = bsh.band_matmul_sharded(
            nbr[1], _t(x), mesh=mesh, n=PIPE_NODES, band=int(c["band"]),
            block=BLOCK).numpy()

        f = np.load(os.path.join(case_dir, "facade.npz"))
        for seed in (9, None):
            sf = SAFE(device="cpu", verbose=False)
            sf.apsp_mode, sf.random_seed, sf.mesh = "band", seed, mesh
            sf.load_network(network_file=(f["coords"], f["edges"],
                                          f["lengths"], f["weights"]))
            sf.load_attributes(attribute_file=f["vals"])
            sf.run_pipeline(num_permutations=FACADE_PERMS)
            tag = f"facade-{seed}"
            out[f"{tag}-engine"] = np.array(
                [sf.apsp_engine_used, sf._band_relax_used])
            for name in ("ns", "counts_neg", "counts_pos", "pvalues_pos",
                         "pvalues_neg", "neighborhoods", "node_distances"):
                out[f"{tag}-{name}"] = np.asarray(getattr(sf, name))
            out[f"{tag}-nnz"] = np.array([sf.neighborhoods_sparse().nnz,
                                          sf.node_distances_sparse().nnz])
        for case, (axes, mode) in MESH_CASES.items():
            sf = _session(vals=MESH_VALS, mode=mode,
                          mesh=make_mesh(axes, device_type="cpu"))
            sf.run_pipeline(perm_idx=MESH_PERM_IDX)
            out[f"{case}-engine"] = np.array(sf.apsp_engine_used)
            out[f"{case}-num_permutations"] = np.array(sf.num_permutations)
            for name in ("neighborhoods", "ns", "counts_neg", "counts_pos"):
                out[f"{case}-{name}"] = np.asarray(getattr(sf, name))
        for case, settings in BAND_CASES.items():
            sf = _session(mesh=mesh, **settings)
            sf.run_pipeline(perm_idx=MESH_PERM_IDX_V)
            out.update(_band_case_results(case, sf))
    return out


def _rank_main(rank, world, case_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(case_dir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        mesh = make_mesh({"data": world}, device_type="cpu")
        np.savez(os.path.join(case_dir, f"rank{rank}.npz"),
                 **_world_job(mesh, world, case_dir))
    finally:
        dist.destroy_process_group()


def _facade_inputs():
    """The JAX facade on an 8-device 'data' mesh (tests/test_band_sharded.py
    :165-211) and the arrays it ran on, for the port's ranks."""
    import networkx as nx
    import pandas as pd
    from jax.sharding import Mesh
    import jax
    from safepy_tpu import SAFE as JaxSAFE
    from safepy_tpu.io.layout import calculate_edge_lengths

    n = FACADE_NODES
    coords, edges, _, _ = _arrays(n, 6, 4)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(map(tuple, edges))
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan

    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode, jsf.random_seed = "band", 9
    jsf.mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(n)], columns=["q"]))
    jsf.run_pipeline(num_permutations=FACADE_PERMS)
    arrays = dict(zip(("coords", "edges", "lengths", "weights"),
                      jsf._graph_to_arrays_cached()))
    return jsf, dict(arrays, vals=np.asarray(jsf.node2attribute))


@pytest.fixture(scope="module")
def fw_case():
    pe, lengths, _, band, _ = _plan(FW_NODES, 7, 0)
    return dict(s0=_init(pe, lengths, FW_NODES, band).numpy(), band=band)


@pytest.fixture(scope="module")
def pipe_case():
    return _pipe_case()


@pytest.fixture(scope="module")
def facade_case():
    return _facade_inputs()


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory, fw_case, pipe_case, facade_case):
    """world -> each rank's saved results, from one spawn of ``world`` gloo
    ranks at the first request."""
    done = {}

    def run(world):
        if world not in done:
            case_dir = str(tmp_path_factory.mktemp(f"world{world}"))
            np.savez(os.path.join(case_dir, "fw.npz"), **fw_case)
            np.savez(os.path.join(case_dir, "pipe.npz"), **pipe_case)
            np.savez(os.path.join(case_dir, "facade.npz"), **facade_case[1])
            mp.spawn(_rank_main, args=(world, case_dir), nprocs=world,
                     join=True)
            done[world] = [dict(np.load(os.path.join(case_dir,
                                                     f"rank{r}.npz")))
                           for r in range(world)]
        return done[world]

    return run


# ---------------------------------------------------------------- the kernel

@pytest.mark.parametrize("width_tiles", [5, 10])
def test_relax_band_row_plain_matches_pallas(width_tiles):
    """B3: the port's wrapper (its plain version on the CPU) against
    ``apsp_pallas._relax_panel`` in interpret mode, q a tile of c."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from safepy_tpu.ops import apsp_pallas as jp

    rng = np.random.default_rng(width_tiles)
    c = rng.uniform(0, 1, (BLOCK, width_tiles * BLOCK)).astype(np.float32)
    c[rng.random(c.shape) < 0.3] = np.inf
    p = rng.uniform(0, 1, c.shape).astype(np.float32)
    p[rng.random(c.shape) < 0.3] = np.inf
    q = c[:, 2 * BLOCK:3 * BLOCK]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp._relax_panel(jnp.asarray(q), jnp.asarray(p),
                                          jnp.asarray(c), block=BLOCK))
    ct = _t(c)
    K.reset_launches()
    got = K.relax_band_row(ct[:, 2 * BLOCK:3 * BLOCK], _t(p), ct)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ct.numpy(), c)  # c is not modified
    np.testing.assert_array_equal(
        K.relax_band_row_plain(ct, ct[:, 2 * BLOCK:3 * BLOCK], _t(p)).numpy(),
        want)
    assert not np.array_equal(want, c) and K.LAUNCHES["relax_band_row"] == 0


@pytest.mark.parametrize("o_lo,o_hi", [(0, 5), (2, 5), (0, 3), (1, 4)])
def test_relax_band_rows_plain_matches_rows_and_pallas(o_lo, o_hi):
    """B3 batched: a round's window rows o_lo .. o_hi - 1 at bt 2 (the whole
    window, and a shard's window cut at its first or last rows, or both), in
    place, against relax_band_row_plain and ``apsp_pallas._relax_panel`` in
    interpret mode on each row, Q tile (o, 2 bt - o) as it stood before."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from safepy_tpu.ops import apsp_pallas as jp

    bt, b = 2, BLOCK
    nt = 2 * bt + 1
    w = nt * b
    rng = np.random.default_rng(o_lo * 10 + o_hi)
    slab = rng.uniform(0, 1, ((o_hi - o_lo + 2) * b, w)).astype(np.float32)
    slab[rng.random(slab.shape) < 0.3] = np.inf
    p_ext = rng.uniform(0, 1, (b, w + 2 * bt * b)).astype(np.float32)
    p_ext[rng.random(p_ext.shape) < 0.3] = np.inf
    want = slab.copy()
    for z, o in enumerate(range(o_lo, o_hi), start=1):
        c = slab[z * b:(z + 1) * b]
        q = c[:, (2 * bt - o) * b:(2 * bt - o + 1) * b]
        p = p_ext[:, o * b:o * b + w]
        with pltpu.force_tpu_interpret_mode():
            want[z * b:(z + 1) * b] = np.asarray(jp._relax_panel(
                jnp.asarray(q), jnp.asarray(p), jnp.asarray(c), block=b))
        np.testing.assert_array_equal(
            K.relax_band_row_plain(_t(c), _t(q), _t(p)).numpy(),
            want[z * b:(z + 1) * b])
    got = _t(slab.copy())
    K.reset_launches()
    K.relax_band_rows(got[b:-b], _t(p_ext), o_lo, o_hi)
    np.testing.assert_array_equal(got.numpy(), want)  # the rows around kept
    assert not np.array_equal(want, slab) and K.LAUNCHES["relax_band_row"] == 0


# ------------------------------------------------------------ the sharded FW

@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_fw_matches_jax_and_unsharded(world_runs, fw_case, world):
    """The whole global ghosted frame, on every rank, bitwise against JAX's
    apsp_band_fw_sharded(use_pallas=False) on as many devices and against
    the port's unsharded classic apsp_band_fw; the +inf pad rows stay
    +inf. The symmetric FW gives the same reach within 1e-6."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from safepy_tpu.parallel import band_sharded as jbsh

    ranks = world_runs(world)
    band = fw_case["band"]
    bt, nb, width, g_pad, _ = bsh.sharded_band_geometry(FW_NODES, band, world,
                                                        BLOCK)
    s0 = fw_case["s0"]
    s_pad = np.full((g_pad * BLOCK, width), np.inf, np.float32)
    s_pad[:s0.shape[0]] = s0
    want = np.asarray(jbsh.apsp_band_fw_sharded(
        jnp.asarray(s_pad), mesh=Mesh(np.array(jax.devices()[:world]),
                                      ("data",)),
        n=FW_NODES, band=band, block=BLOCK, use_pallas=False))
    # apsp_band_fw works in place: give it copies
    single = bs.apsp_band_fw(_t(s0.copy()), bt=bt, block=BLOCK,
                             symmetric=False).numpy()
    sym = bs.apsp_band_fw(_t(s0.copy()), bt=bt, block=BLOCK).numpy()
    for got in ranks:
        np.testing.assert_array_equal(got["fw"], want)
        np.testing.assert_array_equal(got["fw"][:s0.shape[0]], single)
        assert np.isinf(got["fw"][s0.shape[0]:]).all()
    assert not np.array_equal(single, s0)
    np.testing.assert_array_equal(np.isinf(sym), np.isinf(single))
    np.testing.assert_allclose(sym, single, rtol=1e-6)
    assert all("do not cover" in str(r["bad_axes"]) for r in ranks)


# ------------------------------------------------------- the sharded pipeline

@pytest.mark.parametrize("world", sorted(PIPE_RUNS))
def test_sharded_pipeline_matches_unsharded(world_runs, pipe_case, world):
    """Same perm_idx: the port's single-device band pipeline's indicator,
    scores, counts and size stats exactly, and its distances within 1e-6
    (its symmetric FW), on every rank."""
    ranks = world_runs(world)
    c = pipe_case
    for score_type, keep in PIPE_RUNS[world]:
        want = _unsharded_pipeline(c, score_type, keep_distances=True)
        g_rows = want[1].shape[0]
        tag = f"{score_type}-{keep}"
        for got in ranks:
            ind = got[f"{tag}-ind"]
            np.testing.assert_array_equal(ind[:g_rows], want[1].numpy())
            assert not ind[g_rows:].any()  # the device-padding rows
            if keep:
                np.testing.assert_array_equal(
                    np.isinf(got[f"{tag}-dist"][:g_rows]),
                    np.isinf(want[0].numpy()))
                np.testing.assert_allclose(got[f"{tag}-dist"][:g_rows],
                                           want[0].numpy(), rtol=1e-6)
            else:
                assert got[f"{tag}-dist"].size == 0
            for i, name in ((2, "obs"), (3, "cn"), (4, "cp")):
                np.testing.assert_array_equal(got[f"{tag}-{name}"],
                                              want[i].numpy(), err_msg=name)
            np.testing.assert_array_equal(
                got[f"{tag}-stats"], [float(want[5]), float(want[6])])


@pytest.mark.parametrize("world", sorted(PIPE_RUNS))
def test_sharded_pipeline_matches_jax(world_runs, pipe_case, world):
    """Against JAX's fused_permutation_pipeline_band_sharded on as many
    devices: indicator bitwise, obs within 1e-5; the sum counts exactly
    equal to the JAX band pieces fed the same permutations
    (tests/test_torch_band_pipeline.py:85-144)."""
    import jax
    import jax.numpy as jnp
    import jax.random as jrandom
    from jax.sharding import Mesh
    from safepy_tpu.ops import apsp_bandstore as jbs
    from safepy_tpu.parallel import band_sharded as jbsh

    ranks = world_runs(world)
    c = pipe_case
    n, band, rank = PIPE_NODES, int(c["band"]), c["rank"]
    bt = band // BLOCK + 1
    for score_type, keep in PIPE_RUNS[world]:
        want = jbsh.fused_permutation_pipeline_band_sharded(
            jnp.asarray(c["pe"][:, 0], jnp.int32),
            jnp.asarray(c["pe"][:, 1], jnp.int32), jnp.asarray(c["lengths"]),
            jnp.asarray(c["vals_perm"]),
            jnp.asarray(c["vals_perm"][c["valid"]]), jnp.asarray(c["valid"]),
            jnp.asarray(c["starts"], jnp.int32), jnp.asarray(rank, jnp.int32),
            jrandom.PRNGKey(5), c["radius"],
            mesh=Mesh(np.array(jax.devices()[:world]), ("data",)), n=n,
            band=band, block=BLOCK, score_type=score_type,
            num_permutations=8, batch_size=8, w_c=int(c["w_c"]),
            keep_distances=keep, use_pallas=False)
        tag = f"{score_type}-{keep}"
        for got in ranks:
            np.testing.assert_array_equal(got[f"{tag}-ind"],
                                          np.asarray(want[1]))
            if keep:
                np.testing.assert_array_equal(got[f"{tag}-dist"],
                                              np.asarray(want[0]))
            np.testing.assert_allclose(got[f"{tag}-obs"], np.asarray(want[2]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got[f"{tag}-stats"],
                                       [float(want[5]), float(want[6])],
                                       rtol=1e-6)
        if score_type != "sum":
            continue
        # the JAX band pieces fed perm_idx, mapped into the banded frame
        nb = -(-n // BLOCK)
        j_ind = jnp.asarray(want[1][:(nb + 2 * bt) * BLOCK])
        compact, j_starts, _ = jbs.compact_band_columns(j_ind, c["valid"],
                                                        bt=bt, block=BLOCK)
        order = np.argsort(rank)
        sigma = (np.cumsum(c["valid"][rank]) - 1)[order[c["valid"]]]
        q = np.argsort(sigma)[c["perm_idx"][:, sigma]]
        vv = np.nan_to_num(c["vals_perm"][c["valid"]])
        xb = np.zeros((PIPE_PERMS, len(vv) + int(c["w_c"]), 2), np.float32)
        xb[:, :len(vv)] = vv[q]
        j_obs = np.zeros((nb * BLOCK, 2), np.float32)
        j_obs[rank] = np.asarray(want[2])
        cn, cp = jbs.band_count_batch(compact, jnp.asarray(xb), j_starts,
                                      jnp.asarray(j_obs),
                                      jnp.ones(PIPE_PERMS, bool), bt=bt,
                                      block=BLOCK)
        for got in ranks:
            np.testing.assert_array_equal(got[f"{tag}-cn"],
                                          np.asarray(cn)[rank])
            np.testing.assert_array_equal(got[f"{tag}-cp"],
                                          np.asarray(cp)[rank])


def test_sharded_front_and_matmul(world_runs, pipe_case):
    """band_neighborhoods_sharded and band_matmul_sharded (world 2) against
    the unsharded front and band_matmul, on every rank."""
    ranks = world_runs(2)
    c = pipe_case
    dist_band, ind, mean, std, _ = pipe.band_neighborhoods(
        *_pipe_args(c)[:3], c["radius"], n=PIPE_NODES, band=int(c["band"]),
        block=BLOCK)
    g_rows = ind.shape[0]
    x = np.nan_to_num(c["vals_perm"][:, :1])
    bt = int(c["band"]) // BLOCK + 1
    want = bs.band_matmul(ind, _t(np.pad(x, ((0, -(-PIPE_NODES // BLOCK)
                                              * BLOCK - PIPE_NODES),
                                             (0, 0)))),
                          bt=bt, block=BLOCK).numpy()
    for got in ranks:
        np.testing.assert_allclose(got["front-dist"][:g_rows],
                                   dist_band.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(got["front-ind"][:g_rows], ind.numpy())
        np.testing.assert_array_equal(
            got["front-sizes"][:g_rows], bs.band_row_sizes(ind).numpy())
        mm = got["matmul"]
        np.testing.assert_array_equal(mm[bt * BLOCK:bt * BLOCK + len(want)],
                                      want)
        assert not mm[:bt * BLOCK].any() and not mm[bt * BLOCK
                                                    + len(want):].any()


# ------------------------------------------------------------------ facade

def test_facade_mesh_matches_jax(world_runs, facade_case):
    """SAFE(mesh=<2-rank 'data' mesh>) takes the sharded band engine and
    matches the JAX facade on an 8-device mesh."""
    ranks = world_runs(2)
    jsf, _ = facade_case
    for got in ranks:
        assert list(got["facade-9-engine"]) == ["band-storage", "fw"]
        np.testing.assert_array_equal(got["facade-9-neighborhoods"],
                                      jsf.neighborhoods)
        inside = jsf.neighborhoods.astype(bool)
        np.testing.assert_allclose(got["facade-9-node_distances"][inside],
                                   jsf.node_distances[inside], rtol=1e-6)
        assert not np.isfinite(got["facade-9-node_distances"][~inside]).any()
        assert (got["facade-9-nnz"] == inside.sum()).all()
        np.testing.assert_array_equal(np.isnan(got["facade-9-ns"]),
                                      np.isnan(jsf.ns))
        np.testing.assert_allclose(got["facade-9-ns"], jsf.ns, rtol=1e-5,
                                   atol=1e-5)
        for side in ("pos", "neg"):
            ours = np.nan_to_num(got[f"facade-9-pvalues_{side}"])
            theirs = np.nan_to_num(getattr(jsf, f"pvalues_{side}"))
            pooled = (ours + theirs) / 2
            tol = (6 * np.sqrt(pooled * (1 - pooled) * 2 / FACADE_PERMS)
                   + 3 / FACADE_PERMS)
            assert np.all(np.abs(ours - theirs) <= tol)


def test_facade_mesh_matches_single_device(world_runs, facade_case):
    """The same seed on one device: every rank's counts bitwise equal."""
    ranks = world_runs(2)
    f = facade_case[1]
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode, sf.random_seed = "band", 9
    sf.load_network(network_file=(f["coords"], f["edges"], f["lengths"],
                                  f["weights"]))
    sf.load_attributes(attribute_file=f["vals"])
    sf.run_pipeline(num_permutations=FACADE_PERMS)
    for got in ranks:
        np.testing.assert_array_equal(got["facade-9-neighborhoods"],
                                      sf.neighborhoods)
        np.testing.assert_array_equal(got["facade-9-ns"], sf.ns)
        np.testing.assert_array_equal(got["facade-9-counts_neg"],
                                      sf.counts_neg)
        np.testing.assert_array_equal(got["facade-9-counts_pos"],
                                      sf.counts_pos)


def test_facade_fresh_seed_is_shared(world_runs):
    """random_seed=None on a mesh: the first rank's fresh seed is shared,
    so every rank counts the same permutations."""
    ranks = world_runs(2)
    for name in ("counts_neg", "counts_pos"):
        np.testing.assert_array_equal(ranks[0][f"facade-None-{name}"],
                                      ranks[1][f"facade-None-{name}"])
    assert not np.array_equal(ranks[0]["facade-None-counts_neg"],
                              ranks[0]["facade-9-counts_neg"])


# ------------------------------------------------- the cases once refused

def _session(vals=None, mode="band", **settings):
    coords, edges, lengths, weights = _arrays(200, 6, 51)
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = mode
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.load_network(network_file=(coords, edges, lengths, weights))
    sf.load_attributes(attribute_file=(
        np.random.default_rng(52).normal(size=(200, 1)) if vals is None
        else vals))
    return sf


# the meshes a band session took once the dense engines on a mesh were
# ported (world 2), with the engine each takes; dyadic values and explicit
# permutations, so that every count is exact
MESH_CASES = {"perm axis": ({"perm": 2}, "band"),
              "data and perm axes": ({"data": 2, "perm": 1}, "band"),
              "no band plan": ({"data": 2}, "full"),
              "auto, no band plan": ({"data": 2}, "auto")}
MESH_ENGINES = {"perm axis": "dense", "data and perm axes": "dense-sharded",
                "no band plan": "dense-sharded",
                "auto, no band plan": "dense-sharded"}
MESH_VALS = np.random.default_rng(53).integers(-12, 13, (200, 1)) / 4
MESH_PERM_IDX = np.stack([np.random.default_rng(60 + i).permutation(200)
                          for i in range(20)])


# the band runs on a 'data' mesh that were refused until the rest of the
# band engine was ported (world 2): band GO on binary attributes, and a
# bit-packed band under the same permutations as one device
BAND_CASES = {"binary attributes": dict(vals=(np.arange(200) % 2)
                                        .astype(float)),
              "bit-packed band": dict(vals=MESH_VALS,
                                      band_indicator_bits=True)}
MESH_PERM_IDX_V = np.stack([np.random.default_rng(70 + i).permutation(
    int(np.isfinite(MESH_VALS).any(axis=1).sum())) for i in range(20)])


def _band_case_results(case, sf):
    """The results of a BAND_CASES run that the test compares."""
    out = {f"{case}-engine": np.array([sf.apsp_engine_used,
                                       str(sf._hypergeom_engine_used)]),
           f"{case}-band": sf._neighborhoods_dev.data.numpy()}
    names = (("nes_binary", "pvalues_pos") if case == "binary attributes"
             else ("ns", "counts_neg", "counts_pos"))
    for name in names:
        out[f"{case}-{name}"] = np.asarray(getattr(sf, name))
    return out


@pytest.mark.parametrize("case,item", [
    ("perm axis", "A10 remainder"),
    ("data and perm axes", "A10 remainder"),
    ("no band plan", "A10 remainder"),
    ("auto, no band plan", "A10 remainder"),
    ("binary attributes", "A10 remainder"),
    ("bit-packed band", "A10 remainder")])
def test_unported_mesh_cases_raise(world_runs, case, item):
    """Each case was refused, naming ROADMAP ``item``, until the part of
    A10 that runs it was ported; each now runs on two gloo ranks. A band
    session on a 'perm' mesh, on 'data' and 'perm' axes, or on a 'data'
    mesh where no band plan is taken (the dense engines on a mesh: no band
    storage on such meshes, and no banded window where the FW is sharded)
    gives every rank the single-device dense run's neighborhoods, scores
    and counts with the same permutations. Binary attributes over band
    storage on a 'data' mesh take the sharded class table and give the
    single-device band GO run's band, indicator and p-values; a bit-packed
    band gives the single-device packed run's bytes, scores and counts."""
    if case in MESH_CASES:
        single = _session(vals=MESH_VALS, mode="full")
        single.run_pipeline(perm_idx=MESH_PERM_IDX)
        for got in world_runs(2):
            assert str(got[f"{case}-engine"]) == MESH_ENGINES[case]
            assert int(got[f"{case}-num_permutations"]) == 20
            for name in ("neighborhoods", "ns", "counts_neg", "counts_pos"):
                np.testing.assert_array_equal(got[f"{case}-{name}"],
                                              getattr(single, name))
        return
    assert item == "A10 remainder"
    single = _session(**BAND_CASES[case])
    single.run_pipeline(perm_idx=MESH_PERM_IDX_V)
    want = _band_case_results(case, single)
    engine = ("table-band-sharded" if case == "binary attributes"
              else "None")
    for got in world_runs(2):
        assert list(got[f"{case}-engine"]) == ["band-storage", engine]
        for key, value in want.items():
            if not key.endswith("-engine"):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert (want[f"{case}-band"].dtype == np.uint8) == (
        case == "bit-packed band")
