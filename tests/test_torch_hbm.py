"""The port's memory planner (safepy_tpu_torch/hbm.py) and the band GO
residencies it chooses, against the JAX package (safepy_tpu/hbm.py and its
facade).

The planner's byte counts are the port's own, so the two models are held
to the same decisions, not the same bytes: ``fits`` and ``logsf_out`` agree
at every budget at least 1.25x away from each model's edges. The facade
runs go through both packages on the same 300-node band network with the
residency forced alike (``state.from_numpy_state`` carries the settings):

  * the log-survival bitwise JAX's at 'device', 'f16' and 'host' (the class
    table is bitwise JAX's in every case measured here); the indicator and
    the enriched counts exactly equal;
  * within the port, 'host' bitwise 'device' and 'f16' the 'device' values
    rounded to f16, as JAX's residencies are;
  * the chunked operand prep bitwise the full-device prep, and the chunked
    count of non-0/1 values equal to the host count.
"""

import pickle
from pathlib import Path

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu import hbm as jhbm
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu_torch import hbm
from safepy_tpu_torch.ops import apsp_bandstore as bst
from safepy_tpu_torch.ops import apsp_cuda as K
from safepy_tpu_torch.ops import enrich_band as peb
from safepy_tpu_torch.state import (BAND_SETTINGS, ENRICHMENT_SETTINGS,
                                    from_numpy_state)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_NODES, N_ATTRS = 300, 7
DATA = Path(__file__).parent / "data"


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
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.2, 0.6))
        out[:, j] = (near & (rng.random(n) < 0.5)) | (rng.random(n) < 0.03)
    out[rng.random(n) < nan_share] = np.nan
    return out


@pytest.fixture(scope="module")
def net():
    g, coords = _graph()
    return g, _go_matrix(coords)


def _jax_session(net, **settings):
    g, go = net
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode = "band"
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=g, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        go, index=[f"g{i}" for i in range(len(go))],
        columns=[f"go{j}" for j in range(go.shape[1])]))
    return jsf


def _port_session(jsf, **settings):
    psf = from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius, random_seed=None,
        device="cpu",
        **{k: getattr(jsf, k) for k in ENRICHMENT_SETTINGS + BAND_SETTINGS})
    for k, v in settings.items():
        setattr(psf, k, v)
    return psf


def _plan(n, band, a=4373, budget=16 * 10 ** 9, **kw):
    kw.setdefault("packed", True)
    kw.setdefault("keep_distances", False)
    return hbm.band_go_hbm_plan(n, band, a, budget=budget, **kw)


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("n,band", [(500, 37), (300, 511), (49_920, 1535),
                                    (1_000_000, 6655)])
def test_geometry_matches_jax_and_band_store(n, band):
    got = hbm.band_geometry(n, band)
    assert got == jhbm.band_geometry(n, band)
    bt, nb, width = bst.band_params(n, band)
    assert got == (bt, (nb + 2 * bt) * 128, width)
    assert bst.BandedMatrix(np.zeros((1, 1)), np.arange(n), n, band).bt == bt
    assert bst.band_nbytes(n, band) == 4 * got[1] * got[2]


def test_auto_walks_device_f16_host():
    """An annotation-dominated shape: as the budget shrinks 'auto' walks
    device -> f16 -> host -> nothing fits, and the census peaks differ by
    the outputs' bytes (2 and 3 bytes a cell)."""
    seen = []
    for budget in np.linspace(40 * 10 ** 9, 5 * 10 ** 9, 80):
        seen.append(_plan(100_000, 800, a=50_000,
                          budget=int(budget))["logsf_out"])
    order = [m for i, m in enumerate(seen) if m not in seen[:i]]
    assert order == ["device", "f16", "host", None]
    peaks = {m: hbm.census_select(
        n=100_000, n_attrs=50_000, rows=100_352, chunk_w=512,
        ind_bytes=10 ** 8, ann_bytes=5 * 10 ** 9, table_bytes=10 ** 8,
        modes=(m,), budget=10 ** 12)["census_peak"]
        for m in ("device", "f16", "host")}
    cells = 100_000 * 50_000
    assert peaks["device"] - peaks["f16"] == 2 * cells
    assert peaks["f16"] - peaks["host"] == 3 * cells


def test_relax_phase_governs_when_band_dominates():
    p = _plan(200_000, 3000, budget=10 ** 9)
    assert not p["fits"] and p["logsf_out"] is None
    assert p["governing_phase"] == "relax"
    assert "relax peak" in hbm.explain(p)
    # the band relaxes in place: one f32 band, never two (JAX's split_front
    # lever does not exist here)
    bt, rows, window = hbm.band_geometry(200_000, 3000)
    assert p["f32_band"] == 4 * rows * window
    assert p["relax_peak"] < 2 * p["f32_band"] + 4 * 10 ** 9


def test_prep_phase_in_plan():
    """The full-device prep holds 10 bytes a cell at most, the chunked one
    the int8 buffer twice or once plus a chunk; the plan keys the f32
    upload's residency on it."""
    cells = 399_360 * 4373
    full = _plan(399_360, 4300, prep_chunked=False, budget=10 ** 12)
    chunked = _plan(399_360, 4300, prep_chunked=True, budget=10 ** 12)
    assert full["prep_peak"] - hbm._SMALL_BYTES == 10 * cells
    assert chunked["prep_peak"] - hbm._SMALL_BYTES == max(
        cells + 12 * 399_360 * 512, 2 * cells)
    # the full-device prep's f32 upload stays resident through the census
    assert full["census_peak"] - chunked["census_peak"] == 4 * cells
    assert "prep peak" in hbm.explain(full)


@pytest.mark.parametrize("n,band,a", [(100_000, 800, 50_000),
                                      (349_440, 4095, 4373),
                                      (49_920, 1535, 4373),
                                      (1_000_000, 1200, 4373)])
def test_jax_and_port_plans_agree_far_from_edges(n, band, a):
    """The same decision (fits, logsf_out) at every budget of a 1 GB - 1 TB
    grid that lies at least 1.25x from each model's edges."""
    grid = np.geomspace(1e9, 1e12, 300)

    def jax_out(b):
        p = jhbm.band_go_hbm_plan(n, band, a, packed=True, split_front=True,
                                  keep_distances=False, budget=int(b))
        return p["fits"], p["logsf_out"]

    def port_out(b):
        p = _plan(n, band, a=a, budget=int(b))
        return p["fits"], p["logsf_out"]

    outs = [(jax_out(b), port_out(b)) for b in grid]
    edges = [grid[i] for i in range(1, len(grid)) for k in (0, 1)
             if outs[i][k] != outs[i - 1][k]]
    assert edges  # each model changes its decision in the grid
    far = [i for i, b in enumerate(grid)
           if all(max(b / e, e / b) >= 1.25 for e in edges)]
    assert len(far) > 100
    for i in far:
        assert outs[i][0] == outs[i][1], (grid[i], outs[i])


def test_shard_plan_scales_with_devices():
    """The per-rank plan of the row-sharded band GO engine (the facade's
    guard on a 'data' mesh): JAX's per-shard peak falls with the rank
    count and is within the budget where one device's plan is not; its
    terms are JAX's. The port's per-rank peak adds only transients that do
    not grow with the rank count (the assembled bands and outputs are in
    host memory), so it falls with 1, 2, 4 and 8 ranks too and fits 10 GB
    at 8, as JAX's per-shard peak does."""
    one = _plan(399_360, 3583, budget=10 ** 10)
    plans = [hbm.band_go_shard_hbm_plan(399_360, 3583, 4373, d,
                                        budget=10 ** 10)
             for d in (1, 2, 4, 8)]
    peaks = [p["per_shard_peak"] for p in plans]
    assert peaks == sorted(peaks, reverse=True)
    assert not one["fits"] and plans[-1]["per_shard_peak"] <= 10 ** 10
    ranks = [p["per_rank_peak"] for p in plans]
    assert ranks == sorted(ranks, reverse=True) and len(set(ranks)) == 4
    assert all(r > p for r, p in zip(ranks, peaks))
    assert [p["fits"] for p in plans] == [False, False, False, True]
    assert plans[-1]["sharded"] and "replicated_floor" not in plans[-1]
    for key in ("fw_slab", "indicator_bytes", "annotations_int8",
                "out_bytes", "census_transient", "stage_buffer",
                "ghost_operands", "prep_chunk"):
        terms = [p[key] for p in plans]
        assert terms == sorted(terms, reverse=True), key
    # the host holds the whole results on every rank, whatever the count
    assert len({p["host_outputs"] for p in plans}) == 1
    assert "per-shard peak" in hbm.explain(plans[-1])
    assert "host memory a rank" in hbm.explain(plans[-1])
    for d, p in zip((1, 2, 4, 8), plans):
        j = jhbm.band_go_shard_hbm_plan(399_360, 3583, 4373, d)
        for key in ("bt", "rows", "window", "fw_slab", "annotations_int8",
                    "out_bytes", "indicator_bytes"):
            assert p[key] == j[key], (d, key)


@pytest.mark.parametrize("packed,keep,ndev", [
    (True, True, 2), (False, False, 2), (False, True, 1)])
def test_shard_plan_port_terms(packed, keep, ndev):
    """Each transient the port adds to JAX's terms, and each host field, by
    its formula: the staging piece (a rank's band segment, f32 with kept
    distances, or a census chunk's f32 rows, capped at
    SHARD_STAGE_BYTES), the ghost operand rows ((2 bt + 1) b rows of int8
    operands), the per-rank prep's column chunk (12 B a cell of 512
    columns over the slab's rows); the host outputs, bands and operand
    chunk; the per-rank peak is the per-shard peak plus the three, and the
    rank's real operand window stays within JAX's share plus the ghost
    term."""
    from safepy_tpu_torch.parallel import band_sharded as bsh

    n, band, a = 49_920, 1535, 4373
    p = hbm.band_go_shard_hbm_plan(n, band, a, ndev, packed=packed,
                                   keep_distances=keep, budget=10 ** 12)
    bt, rows, window = hbm.band_geometry(n, band)
    local_rows = -(-rows // (128 * ndev)) * 128
    slab_rows = local_rows + 2 * bt * 128
    g_rows = -(-rows // (128 * ndev)) * ndev * 128
    seg = local_rows * (4 * window if keep
                        else window // 8 if packed else window)
    assert p["stage_buffer"] == min(hbm.SHARD_STAGE_BYTES,
                                    max(seg, local_rows * 4 * 1024))
    assert p["ghost_operands"] == (2 * bt + 1) * 128 * a
    assert p["prep_chunk"] == 12 * slab_rows * 512
    assert p["per_rank_peak"] == (p["per_shard_peak"] + p["stage_buffer"]
                                  + p["ghost_operands"] + p["prep_chunk"])
    assert p["host_outputs"] == 5 * n * a
    assert p["host_bands"] == (g_rows * window // (8 if packed else 1)
                               + (4 * g_rows * window if keep else 0))
    assert p["host_operands"] == 4 * slab_rows * 512
    for gone in ("assembled_band", "assembled_distances",
                 "assembled_outputs", "replicated_annotations",
                 "chunk_assembly", "replicated_floor", "upload"):
        assert gone not in p
    geom = bsh.sharded_band_geometry(n, band, ndev)
    for my in range(ndev):
        p0, p1 = bsh.operand_window(my, geom)
        assert (p1 - p0) * a <= p["annotations_int8"] + p["ghost_operands"]
    assert p["fits"]


def test_device_budget_on_the_host():
    assert hbm.device_hbm_budget("cpu") == 16 * 10 ** 9


def test_record_peak_on_the_host(monkeypatch):
    """Off unless SAFEPY_TPU_HBM_TRACE is set; a CPU sample has no
    allocator counters and says so."""
    monkeypatch.setattr(hbm, "HBM_TRACE", [])
    monkeypatch.delenv("SAFEPY_TPU_HBM_TRACE", raising=False)
    assert hbm.record_peak("unit", "cpu") is None and hbm.HBM_TRACE == []
    monkeypatch.setenv("SAFEPY_TPU_HBM_TRACE", "1")
    rec = hbm.record_peak("unit", "cpu")
    assert hbm.HBM_TRACE == [rec] and rec["unavailable"]
    assert rec["allocated"] == rec["peak_allocated"] == -1


# ------------------------------------------------------------- the operands

@pytest.mark.parametrize("binary,a", [(True, 13), (True, 5), (False, 7)])
def test_chunked_prep_matches_device_prep(binary, a):
    """Column chunks of 4 (a remainder chunk too) against the full-device
    build and JAX's: int8 operands, row validity and the flag bitwise; the
    totals bitwise for binary columns (integers), within 1e-6 otherwise."""
    import jax.numpy as jnp
    from safepy_tpu.ops.enrich_band import band_hyper_operands_device as jdev

    rng = np.random.default_rng(11 + a)
    vals = (rng.random((97, a)) < 0.2).astype(np.float64)
    vals[rng.random((97, a)) < 0.3] = np.nan
    if not binary:
        vals[0, 0] = 2.5
    order = rng.permutation(97)
    ref = peb.band_hyper_operands_device(
        torch.as_tensor(vals, dtype=torch.float32), order)
    got = peb.band_hyper_operands_chunked(vals, order, chunk_cols=4,
                                          device="cpu")
    want = jdev(jnp.asarray(vals, jnp.float32), jnp.asarray(order, jnp.int32))
    for i in (0, 1):
        assert torch.equal(got[i], ref[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    if binary:
        assert torch.equal(got[2], ref[2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    assert got[3] == ref[3] == bool(np.asarray(want[3])) == binary


def test_count_other_chunked_matches_full():
    from safepy_tpu.ops.enrich_band import count_other_values_chunked as jc

    rng = np.random.default_rng(3)
    vals = rng.choice([0.0, 1.0, 2.0, np.nan, 1 + 1e-9, 1e39],
                      size=(61, 9), p=[0.4, 0.25, 0.1, 0.15, 0.05, 0.05])
    with np.errstate(over="ignore"):
        v32 = vals.astype(np.float32)
    expect = int(np.sum(np.isfinite(v32) & (v32 != 0) & (v32 != 1)))
    got = peb.count_other_values_chunked(vals, chunk_cols=2, device="cpu")
    assert got == expect == jc(vals, chunk_cols=2)


# ------------------------------------------------------------------ facade

def test_guard_raises_before_the_operand_prep(net):
    """A budget that fits nothing: the fused and the staged band GO runs
    raise a ValueError carrying the plan before the operand prep; no
    operands, no result, no kernel launch."""
    psf = _port_session(_jax_session(net), hbm_budget_bytes=10 ** 6)
    K.reset_launches()
    with pytest.raises(ValueError, match="band GO memory plan"):
        psf.run_pipeline()
    assert psf._band_operands_cache is None and psf._logsf_dev is None
    assert psf._neighborhoods_dev is None and psf._n2a_dev is None
    plan = psf._hbm_plan_last
    assert not plan["fits"] and plan["logsf_out"] is None
    assert plan["budget"] == 10 ** 6
    assert not any(K.LAUNCHES.values())
    psf.hbm_budget_bytes = None
    psf.define_neighborhoods()
    psf.hbm_budget_bytes = 10 ** 6
    with pytest.raises(ValueError, match="band GO memory plan"):
        psf.compute_pvalues()
    assert psf._band_operands_cache is None and psf._logsf_dev is None
    psf.logsf_store = "bogus"
    with pytest.raises(ValueError, match="unknown logsf_out"):
        psf.compute_pvalues()


@pytest.fixture(scope="module")
def stores(net):
    """The fused band GO run at each forced residency, in both packages."""
    out = {}
    for store in ("device", "f16", "host"):
        jsf = _jax_session(net, logsf_store=store)
        jsf.run_pipeline()
        psf = _port_session(jsf)
        psf.run_pipeline()
        out[store] = (jsf, psf)
    return out


def _logsf(sf):
    """The stored log-survival as numpy (JAX's host residency keeps it in
    ``_logsf_np``)."""
    x = sf._logsf_dev if sf._logsf_dev is not None else sf._logsf_np
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("store", ["device", "f16", "host"])
def test_forced_residency_matches_jax(stores, store):
    jsf, psf = stores[store]
    assert psf._hypergeom_engine_used == jsf._hypergeom_engine_used \
        == "table-band"
    assert psf._hbm_plan_last["logsf_out"] == store
    assert psf._hbm_plan_last["census_final"]["fits"]
    got, want = _logsf(psf), _logsf(jsf)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(psf.nes_binary, np.asarray(jsf.nes_binary))
    np.testing.assert_array_equal(
        psf.attributes["num_neighborhoods_enriched"],
        np.asarray(jsf.attributes["num_neighborhoods_enriched"]))
    np.testing.assert_array_equal(psf.pvalues_pos, jsf.pvalues_pos)


def test_residencies_follow_jax_rules(stores):
    """'host' bitwise 'device'; 'f16' the device values rounded to f16;
    the indicator and counts identical in all three."""
    dev, f16, host = (stores[s][1] for s in ("device", "f16", "host"))
    assert _logsf(dev).dtype == np.float32 and _logsf(f16).dtype == np.float16
    assert host._logsf_dev.device.type == "cpu"
    np.testing.assert_array_equal(_logsf(host), _logsf(dev))
    np.testing.assert_array_equal(_logsf(f16),
                                  _logsf(dev).astype(np.float16))
    for sf in (f16, host):
        np.testing.assert_array_equal(sf.nes_binary, dev.nes_binary)
        np.testing.assert_array_equal(
            sf.attributes["num_neighborhoods_enriched"],
            dev.attributes["num_neighborhoods_enriched"])


def test_auto_picks_f16_then_host_as_the_budget_shrinks(stores):
    """A budget between the device and f16 census peaks of the exact
    table: 'auto' takes f16; between f16 and host: host; the results are
    the forced runs'. The staged run takes the same."""
    dev = stores["device"][1]
    sel = dev._hbm_plan_last["census_final"]
    cells = N_NODES * N_ATTRS
    peaks = {"device": sel["census_peak"]}
    peaks["f16"] = peaks["device"] - 2 * cells
    peaks["host"] = peaks["f16"] - 3 * cells
    for want, lo, hi in (("f16", "f16", "device"), ("host", "host", "f16")):
        budget = (peaks[lo] + peaks[hi]) // 2
        for staged in (False, True):
            psf = _port_session(stores[want][0], logsf_store="auto",
                                hbm_budget_bytes=budget)
            if staged:
                psf.define_neighborhoods()
                psf.compute_pvalues()
            else:
                psf.run_pipeline()
            assert psf._hbm_plan_last["logsf_out"] == want
            assert psf._hbm_plan_last["census_final"]["census_peak"] \
                == peaks[want]
            np.testing.assert_array_equal(_logsf(psf),
                                          _logsf(stores[want][1]))
            np.testing.assert_array_equal(psf.nes_binary,
                                          stores[want][1].nes_binary)


def test_chunked_prep_through_the_facade(stores):
    """The facade chunks the operand prep where the full-device prep's
    modeled peak crosses the budget and the f32 upload is not on the device
    yet. Chunked (forced here: at this size every run's census outweighs
    the prep), it never uploads the f32 matrix, counts the non-0/1 values
    on the device from chunks, and gets the device run's operands and
    results."""
    jsf, dev = stores["device"]
    full = hbm.prep_peak(N_NODES, N_ATTRS, chunked=False)
    psf = _port_session(jsf, hbm_budget_bytes=full - 1)
    assert psf._prep_chunked_selected()
    psf.hbm_budget_bytes = full
    assert not psf._prep_chunked_selected()
    psf.hbm_budget_bytes = full - 1
    psf._node2attribute_device()
    assert not psf._prep_chunked_selected()  # the upload is there already

    psf = _port_session(jsf)
    psf._prep_chunked_selected = lambda: True
    assert psf._num_other_values() == 0
    psf.run_pipeline()
    assert psf._n2a_dev is None and psf._hbm_plan_last["prep_chunked"]
    np.testing.assert_array_equal(_logsf(psf), _logsf(dev))
    np.testing.assert_array_equal(psf.nes_binary, dev.nes_binary)
    for got, want in zip(psf._band_operands_cache[1][:3],
                         dev._band_operands_cache[1][:3]):
        assert torch.equal(got, want)


def test_one_budget_a_run_and_the_session_residents(stores):
    """The guard reads the budget once, before the run allocates, and the
    census selects against that same number; ``hbm_budget_bytes`` wins
    over the device's. The planned residents are the session's cached
    upload and operands and its stored bands, each storage once."""
    _, psf = stores["device"]
    plan = psf._hbm_plan_last
    assert plan["census_final"]["budget"] == plan["budget"] == 16 * 10 ** 9
    held = {}
    for t in (psf._n2a_dev, *psf._band_operands_cache[1][:3],
              psf._neighborhoods_dev.data, psf._node_distances_dev.data):
        if isinstance(t, torch.Tensor):
            held[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    assert psf._planned_resident_bytes() == sum(held.values()) > 0
    assert psf._hbm_budget() == 16 * 10 ** 9
    psf.hbm_budget_bytes = 12345
    try:
        assert psf._hbm_budget() == 12345
    finally:
        psf.hbm_budget_bytes = None


@pytest.mark.parametrize("store", ["device", "f16", "host", "auto"])
def test_table_checks_every_residency_against_the_budget(stores, store):
    """``hypergeom_band_table`` holds a forced residency to the budget as
    it holds 'auto': below the census peak it raises before any (n, A)
    output exists, and fills ``select_out`` with the failed selection."""
    _, psf = stores["device"]
    bm = psf._neighborhoods_dev
    nan0, nnn, _, _, m = psf._band_operands_cache[1]
    sel = {}
    with pytest.raises(ValueError, match="census phase does not fit"):
        peb.hypergeom_band_table(bm.data, nan0, nnn, m, np.float64(0.05),
                                 bt=bm.bt, rank_np=bm.rank, logsf_out=store,
                                 budget=10 ** 5, select_out=sel)
    assert not sel["fits"] and sel["budget"] == 10 ** 5
    assert sel["census_peak"] > 10 ** 5


def test_pickle_before_the_planner_loads(net):
    """A session pickled by the package before the planner existed (a band
    GO session of 160 nodes and 4 terms, no ``hbm_budget_bytes`` or
    ``_hbm_plan_last`` in its state) loads with their defaults, serves its
    results, and runs again through the planner to the same log-survival."""
    with open(DATA / "torch_session_before_planner.pkl", "rb") as f:
        sf = pickle.load(f)
    assert sf.hbm_budget_bytes is None and sf._hbm_plan_last is None
    logsf = sf._logsf_np.copy()
    nes_binary = sf.nes_binary.copy()
    assert nes_binary.shape == (160, 4)
    sf.run_pipeline()
    assert sf._hbm_plan_last["fits"] and sf._hypergeom_engine_used \
        == "table-band"
    np.testing.assert_array_equal(sf._logsf_dev.numpy(), logsf)
    np.testing.assert_array_equal(sf.nes_binary, nes_binary)
