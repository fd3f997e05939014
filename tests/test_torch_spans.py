"""The port's spans (``safepy_tpu_torch.profiling.span``) on the CPU: none
without a profiler; under ``profiling.trace`` the tree of an analysis, one
gather and one count span a permutation chunk, one root id an analysis,
the names in the Chrome trace; outputs bitwise equal with spans on and off;
the buffer's bound. Each analysis case runs on the band-storage engine and
on the banded window (the dense quantitative path), whose relax span names
its engine and rounds and whose null chunks their route; ``annotate`` adds
to the innermost open span."""

import collections
import glob
import json
import math

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE, profiling
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import permutation as perm_ops

N_NODES, N_PERM, BATCH = 300, 50, 7
ENGINES = {"band": "band-storage", "auto": "banded-window"}
# each span's parent: None for a root
PARENTS = {"facade.load_attributes": {None},
           "facade.run_pipeline": {None},
           "facade.attr_prep": {"facade.run_pipeline"},
           "neighborhoods.front": {"facade.run_pipeline"},
           "neighborhoods.relax": {"neighborhoods.front"},
           "enrichment.null": {"facade.run_pipeline"},
           "enrichment.permute": {"enrichment.null"},
           "enrichment.count": {"enrichment.null"},
           "facade.wait": {"facade.run_pipeline", "enrichment.null"}}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """One torch thread (the plain FW is a loop of small ops), permutation
    chunks of BATCH, and an empty span buffer before and after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(perm_ops, "default_batch_size",
                        lambda v, a, p, budget_bytes=None: min(p, BATCH))
    profiling.reset_spans()
    yield
    profiling.reset_spans()
    torch.set_num_threads(threads)


def _network(n=N_NODES, k=7, seed=3):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def _inputs(seed=4):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-12, 13, (N_NODES, 1)) / 4
    vals[rng.random(N_NODES) < 0.3] = np.nan
    v = int(np.isfinite(vals).any(axis=1).sum())
    perm_idx = np.stack([rng.permutation(v) for _ in range(N_PERM)])
    return vals, perm_idx


def _session(mode):
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = mode
    sf.load_network(network_file=_network())
    return sf


def _analysis(sf, vals, perm_idx):
    sf.load_attributes(attribute_file=vals)
    sf.run_pipeline(perm_idx=perm_idx)
    return dict(ns=sf.ns.copy(), counts_neg=sf.counts_neg.copy(),
                counts_pos=sf.counts_pos.copy(),
                pvalues_neg=np.array(sf.pvalues_neg),
                pvalues_pos=np.array(sf.pvalues_pos),
                nes=np.array(sf.nes), nes_binary=np.array(sf.nes_binary))


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_no_spans_without_a_profiler(mode):
    sf = _session(mode)
    _analysis(sf, *_inputs())
    assert sf.apsp_engine_used == ENGINES[mode]
    assert len(profiling.SPANS) == 0 and profiling.span_records() == []


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_spans_form_the_analysis_tree(mode, tmp_path):
    sf = _session(mode)
    vals, perm_idx = _inputs()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(2):
            _analysis(sf, vals, perm_idx)
    recs = profiling.span_records()
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id[r["parent"]]["name"] if r["parent"] else None
        assert parent in PARENTS[r["name"]], (r["name"], parent)
        assert r["self_host_ms"] >= 0 and r["host_ms"] >= r["self_host_ms"]
        assert r["stream_ms"] is None  # no CUDA events on the CPU
        top = r
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        assert r["root"] == top["id"]  # one id an analysis: its root's
    runs = [r for r in recs if r["name"] == "facade.run_pipeline"]
    assert len(runs) == 2
    assert all(r["attrs"] == {"engine": ENGINES[mode]} for r in runs)
    chunks = math.ceil(N_PERM / BATCH)
    for run in runs:
        mine = [r for r in recs if r["root"] == run["id"]]
        names = collections.Counter(r["name"] for r in mine)
        assert names["enrichment.permute"] == chunks
        assert names["enrichment.count"] == chunks
        assert names["neighborhoods.front"] == names["neighborhoods.relax"] \
            == names["enrichment.null"] == 1
        # the front runs before the null's tail
        start = {r["name"]: r["start_ns"] for r in mine}
        assert start["neighborhoods.front"] < start["enrichment.null"]
        # the attributes' one transfer, before the front
        assert [r["attrs"] for r in mine if r["name"] == "facade.attr_prep"] \
            == [{"route": "upload"}]
        assert start["facade.attr_prep"] < start["neighborhoods.front"]
        sites = {r["attrs"]["site"] for r in mine
                 if r["name"] == "facade.wait"}
        assert {"store_null.obs", "store_null.counts_neg",
                "store_null.counts_pos"} <= sites
    loads = [r for r in recs if r["name"] == "facade.load_attributes"]
    assert len(loads) == 2 and all(r["root"] == r["id"] for r in loads)
    with open(prof.trace_path) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(PARENTS) <= traced
    assert glob.glob(str(tmp_path / "tr" / "*.json")) == [prof.trace_path]


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_spans_change_no_output(mode, tmp_path):
    sf = _session(mode)
    vals, perm_idx = _inputs(seed=5)
    off = _analysis(sf, vals, perm_idx)
    with profiling.trace(str(tmp_path / "tr")):
        on = _analysis(sf, vals, perm_idx)
    assert len(profiling.span_records()) > 0
    again = _analysis(sf, vals, perm_idx)
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)
        np.testing.assert_array_equal(again[key], off[key], err_msg=key)


def test_span_buffer_stops_at_its_maxlen(monkeypatch):
    from collections import deque

    monkeypatch.setattr(profiling, "SPANS", deque(maxlen=5))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for k in range(12):
                with profiling.span("inner", k=k):
                    pass
    assert len(profiling.SPANS) == 5
    recs = profiling.span_records()
    # the newest five: the outer span (opened first) is gone
    assert [r["attrs"]["k"] for r in recs] == [7, 8, 9, 10, 11]
    profiling.reset_spans()
    assert len(profiling.SPANS) == 0


def test_span_records_ids_and_self_time():
    assert profiling.span("x") is profiling.span("y")  # off: one object
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a", tag=1) as a:
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("b"):
                pass
            a.attrs["late"] = 2
        with profiling.span("d"):
            pass
    recs = profiling.span_records()
    assert [r["name"] for r in recs] == ["a", "b", "c", "b", "d"]
    ra, rb, rc, rb2, rd = recs
    assert ra["attrs"] == {"tag": 1, "late": 2}
    assert ra["parent"] is None and ra["root"] == ra["id"]
    assert rb["parent"] == rb2["parent"] == ra["id"]
    assert rc["parent"] == rb["id"] and rc["root"] == ra["id"]
    assert rd["parent"] is None and rd["root"] == rd["id"]
    assert ra["self_host_ms"] == pytest.approx(
        ra["host_ms"] - rb["host_ms"] - rb2["host_ms"], abs=1e-9)
    assert rb["self_host_ms"] == pytest.approx(
        rb["host_ms"] - rc["host_ms"], abs=1e-9)
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    assert ra["start_ns"] <= rb["start_ns"] and rb2["end_ns"] <= ra["end_ns"]


def test_a_span_closes_on_an_exception():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("x")
        with profiling.span("after"):
            pass
    recs = profiling.span_records()
    assert [r["name"] for r in recs] == ["outer", "inner", "after"]
    assert recs[2]["parent"] is None


# the attrs of each engine's relax and null chunk spans: the window FW's
# name their engine and rounds and the dense null's its route; the band's
# are as before (its FW's graph mode alone)
RELAX_ATTRS = {"auto": {"engine": "window", "rounds": -(-N_NODES // 128)},
               "band": {"graph": "eager"}}
CHUNK_ATTRS = {"auto": {"route": "dense"}, "band": {}}


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_relax_and_chunk_spans_name_their_engine(mode, tmp_path):
    sf = _session(mode)
    with profiling.trace(str(tmp_path / "tr")):
        _analysis(sf, *_inputs())
    assert sf.apsp_engine_used == ENGINES[mode]
    recs = profiling.span_records()
    relax = [r["attrs"] for r in recs if r["name"] == "neighborhoods.relax"]
    assert relax == [RELAX_ATTRS[mode]]
    chunks = [r["attrs"] for r in recs
              if r["name"] in ("enrichment.permute", "enrichment.count")]
    assert len(chunks) == 2 * math.ceil(N_PERM / BATCH)
    assert all(a == CHUNK_ATTRS[mode] for a in chunks)


def test_annotate_adds_to_the_innermost_open_span():
    profiling.annotate(x=1)   # off: nothing, and no error
    assert len(profiling.SPANS) == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.annotate(y=0)   # no open span: nothing
        with profiling.span("outer", a=1):
            with profiling.span("inner"):
                profiling.annotate(n=3)
            profiling.annotate(m=4)
    recs = profiling.span_records()
    assert [(r["name"], r["attrs"]) for r in recs] == [
        ("outer", {"a": 1, "m": 4}), ("inner", {"n": 3})]
