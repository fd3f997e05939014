"""The band GO path: hypergeometric enrichment of binary annotations over
band-storage neighborhoods, the port against the JAX package.

The same seeded inputs go through both packages on the CPU, with band
storage forced (``apsp_mode='band'``) on a 300-node kNN network
(tests/test_bandstore_facade.py:16-27); the banded order is not the
identity, so every row result passes through the ``rank`` un-permute.
Tolerances:

  * the indicator, the neighborhoods, the census counts and
    ``num_neighborhoods_enriched``: exactly equal;
  * the f32 log-survival: within 4 f32 ulps on the tail-loop engines (the
    complement branch's f32 ``exp``/``log1p`` round differently in XLA and
    torch, tests/test_torch_hypergeom.py) and 1 f32 ulp plus 1e-11 on the
    class table (its f64 ``log``); bitwise equal in every case measured
    here;
  * the host-chunk driver against the unchunked loop: NES within 1e-9, as
    JAX's test_band_hypergeom_hostchunks_matches_unchunked holds it;
  * band storage against the dense engine: p-values within 1e-6.
"""

import re

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp
from scipy.spatial import cKDTree

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu.ops import enrich_band as jeb
from safepy_tpu.ops import hypergeom as jhyper
from safepy_tpu.ops import hypergeom_table as jtab
from safepy_tpu_torch import SAFE
from safepy_tpu_torch.ops import enrich_band as peb
from safepy_tpu_torch.ops import hypergeom_table as ptab
from safepy_tpu_torch.state import ENRICHMENT_SETTINGS, from_numpy_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_NODES, N_ATTRS, CHUNK, THR = 300, 7, 3, np.float64(0.05)


def _ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    same = got == want
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return np.where(same, 0.0, diff / np.spacing(np.abs(want)))


def _assert_loop_close(got, want):
    assert _ulps(got, want).max() <= 4


def _assert_table_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)) + 1e-11)


def _graph(n=N_NODES, k=6, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from({(min(i, int(j)), max(i, int(j)))
                      for i in range(n) for j in nn[i, 1:]})
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    return g, coords


def _go_matrix(coords, a=N_ATTRS, seed=5, nan_share=0.1):
    """Binary terms of members near random centres, unannotated rows NaN."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.2, 0.6))
        out[:, j] = (near & (rng.random(n) < 0.5)) | (rng.random(n) < 0.03)
    out[rng.random(n) < nan_share] = np.nan
    return out


def _frame(vals):
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(len(vals))],
                        columns=[f"go{j}" for j in range(vals.shape[1])])


@pytest.fixture(scope="module")
def net():
    g, coords = _graph()
    return g, _go_matrix(coords)


def _jax_session(net, vals=None, **settings):
    g, go = net
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode = "band"
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=_frame(go if vals is None else vals))
    return jsf


def _port_session(jsf, **settings):
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=jsf.neighborhood_radius,
                           random_seed=None, device="cpu",
                           **{k: getattr(jsf, k) for k in ENRICHMENT_SETTINGS})
    psf.apsp_mode = jsf.apsp_mode
    for k, v in settings.items():
        setattr(psf, k, v)
    return psf


@pytest.fixture(scope="module")
def band(net):
    """The JAX package's band indicator and the band engines' operands."""
    jsf = _jax_session(net)
    jsf.define_neighborhoods()
    bm = jsf._neighborhoods_dev
    assert not np.array_equal(bm.rank, np.arange(N_NODES))
    order = np.argsort(bm.rank)
    nan0, nnn, K = JaxSAFE._hypergeom_host_operands(jsf.node2attribute, order)
    M = int(nnn.sum())
    k_max = int(max(1, K.max()))
    return dict(s=np.array(bm.data), rank=bm.rank, bt=bm.bt, order=order,
                nan0=nan0, nnn=nnn, K=K, M=M, n2a=jsf.node2attribute,
                iters=jhyper.tail_iterations(M, min(k_max, M)),
                lgt=jhyper.lgamma_table(M))


# ------------------------------------------------------------ the ops

@pytest.mark.parametrize("case", ["ragged", "single", "even", "fractional",
                                  "n_max", "over_budget"])
def test_plan_matches_jax(case):
    """Eligibility, and each chunk's start, width and classes. JAX
    re-windows a ragged last chunk (``_unify_chunk_signatures``); there the
    port's chunk is JAX's without its ``overlap`` columns."""
    rng = np.random.default_rng(1)
    n_max, M, cols = 200.0, 1000, 512
    K = rng.integers(0, 300, {"single": 100, "even": 1024}.get(case, 1100))
    K = K.astype(np.float64)
    if case == "fractional":
        K[5] = 2.5
    elif case == "n_max":
        n_max = 10.5
    elif case == "over_budget":
        K, n_max, M = np.arange(4000.0), 5000.0, 9000
        cols = 4096
    ours = ptab.plan(K, n_max, M, chunk_cols=cols)
    theirs = jtab.plan(K, n_max, M, chunk_cols=cols)
    assert (ours is None) == (theirs is None)
    assert (ours is None) == (case in ("fractional", "n_max", "over_budget"))
    if ours is None:
        return
    assert len(ours["chunks"]) == len(theirs["chunks"])
    assert ours["total_cells"] <= theirs["total_cells"]
    for o, t in zip(ours["chunks"], theirs["chunks"]):
        lap = t["overlap"]
        assert o["overlap"] == 0
        assert (o["start"], o["width"]) == (t["start"] + lap,
                                            t["width"] - lap)
        np.testing.assert_array_equal(o["K_dist"][o["colc"]],
                                      t["K_dist"][t["colc"]][lap:])
        np.testing.assert_array_equal(o["K_dist"][o["colc"]],
                                      K[o["start"]:o["start"] + o["width"]])
        if not lap:
            np.testing.assert_array_equal(o["colc"], t["colc"])
    assert (theirs["chunks"][-1]["overlap"] > 0) == (case == "ragged")


def test_band_hyper_operands_and_host_helpers_match_jax(band):
    n2a, order = band["n2a"], band["order"]
    up = np.asarray(n2a, np.float32)
    ours = peb.band_hyper_operands_device(torch.as_tensor(up), order)
    theirs = jeb.band_hyper_operands_device(jnp.asarray(up),
                                            jnp.asarray(order, jnp.int32))
    for o, t in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    assert ours[3] is True and bool(theirs[3])
    up[0, 0] = 0.5
    assert not peb.band_hyper_operands_device(torch.as_tensor(up), order)[3]
    for o, t in zip(SAFE._hypergeom_host_operands(n2a, order),
                    (band["nan0"], band["nnn"], band["K"])):
        np.testing.assert_array_equal(o, t)
    for n, a in ((300, 7), (49920, 4373), (5000, 4000), (10 ** 6, 100)):
        assert (SAFE._hypergeom_attr_chunk(n, a)
                == JaxSAFE._hypergeom_attr_chunk(n, a))
    for iters in (1, 64, 65, 152, 600):
        assert peb._iteration_bucket(iters) == jeb._iteration_bucket(iters)
    sums = peb._column_sums_chunked(torch.as_tensor(
        band["nan0"].astype(np.int8)), chunk_cols=3)
    np.testing.assert_array_equal(sums, band["K"])


@pytest.mark.parametrize("attr_chunk", [None, CHUNK])
@pytest.mark.parametrize("frame", ["original", "permuted"])
def test_core_band_matches_jax(band, attr_chunk, frame):
    """Unchunked and in attribute chunks (the last clamped), the rows
    un-permuted by a non-identity rank or left in the permuted frame; and
    from the raw NaN-carrying values (``hypergeom_tail_band``)."""
    rank = band["rank"] if frame == "original" else None
    kw = dict(iterations=band["iters"], bt=band["bt"], attr_chunk=attr_chunk)
    want = jeb.hypergeom_core_band_jit(
        jnp.asarray(band["s"]), jnp.asarray(band["nan0"]),
        jnp.asarray(band["nnn"]), jnp.asarray(band["K"]),
        jnp.asarray(band["lgt"]), band["M"], THR,
        rank=None if rank is None else jnp.asarray(rank, jnp.int32), **kw)
    s, lgt = torch.as_tensor(band["s"]), torch.as_tensor(band["lgt"])
    trank = None if rank is None else torch.as_tensor(rank)
    got = peb.hypergeom_core_band(
        s, torch.as_tensor(band["nan0"]), torch.as_tensor(band["nnn"]),
        torch.as_tensor(band["K"]), lgt, band["M"], THR, rank=trank, **kw)
    raw = peb.hypergeom_tail_band(
        s, torch.as_tensor(band["n2a"][band["order"]]), lgt, band["M"], THR,
        rank=trank, **kw)
    rows = (N_NODES if rank is not None
            else band["s"].shape[0] - 2 * 128 * band["bt"])
    for logsf, nbin in (got, raw):
        assert logsf.shape == (rows, N_ATTRS) and logsf.dtype == torch.float32
        np.testing.assert_array_equal(nbin.numpy(), np.asarray(want[1]))
        _assert_loop_close(logsf.numpy(), np.asarray(want[0]))
    assert int(got[1].sum()) > 0


def test_hostchunks_match_jax_and_the_unchunked_loop(band):
    kw = dict(bt=band["bt"], rank_np=band["rank"], attr_chunk=CHUNK)
    want = jeb.hypergeom_band_hostchunks(
        jnp.asarray(band["s"]), band["nan0"], band["nnn"],
        jnp.asarray(band["lgt"]), band["M"], THR, **kw)
    s = torch.as_tensor(band["s"])
    lgt = torch.as_tensor(band["lgt"])
    logsf, nbin, counts = peb.hypergeom_band_hostchunks(
        s, band["nan0"], band["nnn"], lgt, band["M"], THR, **kw)
    np.testing.assert_array_equal(nbin.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(counts.numpy(), want[2])
    _assert_loop_close(logsf.numpy(), np.asarray(want[0]))
    plain, plain_bin = peb.hypergeom_core_band(
        s, torch.as_tensor(band["nan0"]), torch.as_tensor(band["nnn"]),
        torch.as_tensor(band["K"]), lgt, band["M"], THR,
        iterations=band["iters"], bt=band["bt"],
        rank=torch.as_tensor(band["rank"]))
    np.testing.assert_array_equal(nbin.numpy(), plain_bin.numpy())
    ln10 = np.log(10.0)
    np.testing.assert_allclose(-logsf.numpy().astype(np.float64) / ln10,
                               -plain.numpy().astype(np.float64) / ln10,
                               rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def table_operands(band):
    up = torch.as_tensor(np.asarray(band["n2a"], np.float32))
    nan0, nnn, K, ok = peb.band_hyper_operands_device(up, band["order"])
    assert ok
    return nan0, nnn, K


@pytest.mark.parametrize("logsf_out", ["device", "f16", "host"])
def test_band_table_matches_jax(band, table_operands, logsf_out):
    """Each residency against JAX's; 'host' bit-equal to 'device'; 'f16'
    with the exact counts and indicator, its log sf within one f16 ulp."""
    nan0, nnn, K = table_operands
    kw = dict(bt=band["bt"], rank_np=band["rank"], chunk_cols=CHUNK)
    want = jeb.hypergeom_band_table(
        jnp.asarray(band["s"]), jnp.asarray(nan0.numpy()),
        jnp.asarray(nnn.numpy()), band["M"], THR, logsf_out=logsf_out, **kw)
    s = torch.as_tensor(band["s"])
    got = peb.hypergeom_band_table(s, nan0, nnn, band["M"], THR,
                                   logsf_out=logsf_out, **kw)
    logsf, nbin, counts = got
    np.testing.assert_array_equal(np.asarray(nbin), np.asarray(want[1]))
    np.testing.assert_array_equal(counts.numpy(), want[2])
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(nbin).astype(np.int64).sum(axis=0))
    device = peb.hypergeom_band_table(s, nan0, nnn, band["M"], THR,
                                      K_np=K.numpy(), **kw)
    if logsf_out == "f16":
        assert logsf.dtype == torch.float16
        w16 = np.asarray(want[0], np.float16)
        diff = np.abs(logsf.numpy().astype(np.float64) - w16)
        assert np.all(diff <= np.spacing(np.abs(w16)).astype(np.float64))
    else:
        _assert_table_close(np.asarray(logsf), np.asarray(want[0]))
    if logsf_out == "host":
        assert isinstance(logsf, np.ndarray) and isinstance(nbin, np.ndarray)
        np.testing.assert_array_equal(logsf, device[0].numpy())
    np.testing.assert_array_equal(np.asarray(nbin), device[1].numpy())
    np.testing.assert_array_equal(counts.numpy(), device[2].numpy())
    assert int(counts.sum()) > 0


def test_band_table_with_jax_unified_plan_is_bitwise_equal(band,
                                                           table_operands):
    """JAX unifies the chunks' geometry and re-windows the ragged last
    chunk; the port's plan does neither. Handed JAX's plan, the port's
    table engine returns the same bits as with its own."""
    nan0, nnn, K = table_operands
    s = torch.as_tensor(band["s"])
    kw = dict(bt=band["bt"], rank_np=band["rank"], chunk_cols=CHUNK,
              K_np=K.numpy())
    ours = peb.hypergeom_band_table(s, nan0, nnn, band["M"], THR, **kw)
    npad = band["s"].shape[0] - 2 * 128 * band["bt"]
    nsize = peb.band_matmul(s, peb._pad_rows_to(nnn[:, None], npad),
                            bt=band["bt"])[:, 0]
    n_max = float(nsize.max())
    jplan = jtab.plan(K.numpy(), n_max, band["M"], chunk_cols=CHUNK)
    assert jplan["chunks"][-1]["overlap"] > 0
    assert len({(c["R"], c["S_max"], c["C"]) for c in jplan["chunks"]}) == 1
    theirs = peb.hypergeom_band_table(s, nan0, nnn, band["M"], THR,
                                      plan=jplan, **kw)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), t.numpy())


# ------------------------------------------------------------ the facade

ENGINES = {"table-band": ("auto", None), "hostchunks-band": ("loop", CHUNK),
           "loop-band": ("loop", None)}


def _chunk(sf, attr_chunk):
    if attr_chunk is not None:
        sf._hypergeom_attr_chunk = lambda n, a, budget_elems=0: attr_chunk


def _run(sf, staged, attr_chunk):
    _chunk(sf, attr_chunk)
    if staged:
        sf.define_neighborhoods()
        sf.compute_pvalues()
    else:
        sf.run_pipeline()
    return sf


@pytest.mark.parametrize("fdr", [False, True], ids=["raw", "fdr"])
@pytest.mark.parametrize("staged", [False, True], ids=["fused", "staged"])
@pytest.mark.parametrize("label", list(ENGINES))
def test_facade_matches_jax(net, label, staged, fdr):
    engine, attr_chunk = ENGINES[label]
    jsf = _run(_jax_session(net, hypergeom_engine=engine,
                            multiple_testing=fdr), staged, attr_chunk)
    psf = _run(_port_session(jsf), staged, attr_chunk)
    want = label + ("-staged" if staged else "")
    assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used == want
    assert psf.apsp_engine_used == "band-storage"
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(psf.nes_binary, np.asarray(jsf.nes_binary))
    np.testing.assert_array_equal(
        psf.attributes["num_neighborhoods_enriched"],
        jsf.attributes["num_neighborhoods_enriched"].to_numpy())
    assert psf._nes_dev is None and psf._nes_from_logsf  # NES deferred
    close = _assert_table_close if label == "table-band" else \
        _assert_loop_close
    close(psf._logsf_dev.numpy(), np.asarray(jsf._logsf_dev))
    close(psf.nes.astype(np.float32), np.asarray(jsf.nes, np.float32))
    assert psf.nes_binary.sum() > 0


def test_band_matches_the_dense_engine(net):
    """Band storage against the dense FW in the port (JAX's
    test_band_hypergeom_matches_full), with and without FDR."""
    jsf = _jax_session(net)
    for fdr in (False, True):
        runs = [_port_session(jsf, apsp_mode=mode, multiple_testing=fdr)
                for mode in ("band", "full")]
        for sf in runs:
            sf.run_pipeline()
        band_sf, dense = runs
        assert band_sf._hypergeom_engine_used == "table-band"
        assert dense._hypergeom_engine_used == "table-dense-fused"
        np.testing.assert_array_equal(band_sf.neighborhoods,
                                      dense.neighborhoods)
        np.testing.assert_array_equal(band_sf.nes_binary, dense.nes_binary)
        np.testing.assert_array_equal(
            band_sf.attributes["num_neighborhoods_enriched"],
            dense.attributes["num_neighborhoods_enriched"])
        assert np.abs(band_sf.pvalues_pos - dense.pvalues_pos).max() <= 1e-6


def test_non_binary_values_take_the_loop_and_table_raises_as_in_jax(net):
    """Forced hypergeometric on non-0/1 values: the table does not apply,
    so 'auto' takes the tail loop in both packages; staged with
    hypergeom_engine='table', both raise."""
    vals = np.where(np.isnan(net[1]), np.nan, net[1] * 2.0)
    jsf = _jax_session(net, vals, enrichment_type="hypergeometric")
    jsf.run_pipeline()
    psf = _port_session(jsf)
    psf.run_pipeline()
    assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used == \
        "loop-band"
    np.testing.assert_array_equal(psf.nes_binary, np.asarray(jsf.nes_binary))
    _assert_loop_close(psf._logsf_dev.numpy(), np.asarray(jsf._logsf_dev))
    for sf in (jsf, psf):
        sf.hypergeom_engine = "table"
        sf.define_neighborhoods()
        with pytest.raises(ValueError, match="binary 0/1 annotations"):
            sf.compute_pvalues()


def test_logsf_store_and_the_operand_cache(net):
    """'f16' and 'host', refused until the memory planner was ported, run
    where the table is taken: 'host' bitwise 'device', 'f16' its values
    rounded to f16 (tests/test_torch_hbm.py holds them against JAX's); the
    loop engine never reads the setting, as in JAX. The table's operands
    are cached across runs and dropped on a new load."""
    jsf = _jax_session(net)
    psf = _port_session(jsf)
    psf.logsf_store = "device"
    psf.run_pipeline()
    want = psf._logsf_dev.clone()
    for store, dtype in (("f16", torch.float16), ("host", torch.float32)):
        psf.logsf_store = store
        psf.run_pipeline()
        assert psf._hypergeom_engine_used == "table-band"
        assert psf._logsf_dev.dtype == dtype
        assert torch.equal(psf._logsf_dev, want.to(dtype))
    psf.logsf_store = "bogus"
    with pytest.raises(ValueError, match="unknown logsf_out"):
        psf.run_pipeline()
    psf.logsf_store, psf.hypergeom_engine = "f16", "loop"
    psf.run_pipeline()
    assert psf._hypergeom_engine_used == "loop-band"
    psf.logsf_store, psf.hypergeom_engine = "device", "auto"
    psf.run_pipeline()
    cached = psf._band_operands_cache
    assert cached is not None and cached[1][0].dtype == torch.int8
    psf.run_pipeline()
    assert psf._band_operands_cache is cached
    psf.load_attributes(attribute_file=psf.node2attribute)
    assert psf._band_operands_cache is None
    psf.run_pipeline()
    assert psf._band_operands_cache[0][0] == cached[0][0] + 1
