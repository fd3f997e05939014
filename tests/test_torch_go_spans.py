"""The spans of the GO paths (``profiling.span``) on the CPU: under
``profiling.trace`` a band-storage GO analysis by the class table leaves
``facade.go_operands``, ``enrichment.go`` with its ``go_census``,
``go_table`` and ``go_lookup`` children, and two ``facade.wait`` sites,
nested as stated; each table span's ``R``, ``S_max`` and ``C`` are its
chunk's in the plan that ran, and its ``route`` the one that built the
table (the slot loop here, one build a chunk); an analysis whose operands
come from the cache has no operand span; without a profiler nothing is
recorded; and the outputs are bitwise equal with spans on and off. The
dense fused GO path (the certified window) leaves its front,
``enrichment.go``, the census and the f64 tail (``enrichment.go_tail``:
cells, bound, the bodies run) or the class table and lookup; every tail
loop route counts its bodies."""

import collections
import json

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE, profiling
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import hypergeom as hyper
from safepy_tpu_torch.ops import hypergeom_table as htab

N_NODES, TERMS, CHUNK_COLS = 300, 40, 16
# each GO span's parent (the front's and the facade's roots as in
# tests/test_torch_spans.py)
PARENTS = {"facade.load_attributes": {None},
           "facade.run_pipeline": {None},
           "facade.attr_prep": {"facade.run_pipeline"},
           "facade.go_operands": {"facade.run_pipeline"},
           "neighborhoods.front": {"facade.run_pipeline"},
           "neighborhoods.relax": {"neighborhoods.front"},
           "enrichment.go": {"facade.run_pipeline"},
           "enrichment.go_census": {"enrichment.go"},
           "enrichment.go_table": {"enrichment.go"},
           "enrichment.go_lookup": {"enrichment.go"},
           "facade.wait": {"facade.run_pipeline", "enrichment.go"}}
WAIT_PARENT = {"go_K": "facade.run_pipeline", "go_n_max": "enrichment.go"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """One torch thread, chunks of CHUNK_COLS columns (so that an analysis
    has several), the plans that ran recorded, and an empty span buffer
    before and after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    plans = []
    plan = htab.plan

    def recorded(K_np, n_max, M, **kw):
        out = plan(K_np, n_max, M, **dict(kw, chunk_cols=CHUNK_COLS))
        plans.append(out)
        return out
    monkeypatch.setattr(htab, "plan", recorded)
    profiling.reset_spans()
    yield plans
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


def _go(coords, seed=4):
    """Binary terms of members near random centres, 10% NaN rows."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, TERMS))
    for j in range(TERMS):
        near = (np.linalg.norm(coords - rng.uniform(-0.8, 0.8, 2), axis=1)
                < rng.uniform(0.15, 0.5))
        out[:, j] = (near & (rng.random(n) < 0.5)) | (rng.random(n) < 0.02)
    out[rng.random(n) < 0.1] = np.nan
    return out


def _session():
    net = _network()
    sf = SAFE(device="cpu", verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    return sf, _go(net[0])


def _analysis(sf, go, load=True):
    if load:
        sf.load_attributes(attribute_file=go)
    sf.run_pipeline()
    assert sf._hypergeom_engine_used == "table-band"
    return dict(nes=np.array(sf.nes), nes_binary=np.array(sf.nes_binary),
                pvalues=np.array(sf.pvalues_pos),
                enriched=np.array(
                    sf.attributes["num_neighborhoods_enriched"]))


def test_no_go_spans_without_a_profiler():
    sf, go = _session()
    _analysis(sf, go)
    assert len(profiling.SPANS) == 0 and profiling.span_records() == []


def test_go_spans_nest_and_carry_the_plan(_fresh, tmp_path):
    plans = _fresh
    sf, go = _session()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        _analysis(sf, go)
        _analysis(sf, go, load=False)   # operands from the cache
    recs = profiling.span_records()
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id[r["parent"]]["name"] if r["parent"] else None
        assert parent in PARENTS[r["name"]], (r["name"], parent)
        if r["name"] == "facade.wait":
            assert parent == WAIT_PARENT[r["attrs"]["site"]]
    runs = [r for r in recs if r["name"] == "facade.run_pipeline"]
    assert len(runs) == 2 and len(plans) == 2
    for k, (run, plan) in enumerate(zip(runs, plans)):
        mine = [r for r in recs if r["root"] == run["id"]]
        chunks = plan["chunks"]
        assert len(chunks) == -(-TERMS // CHUNK_COLS)
        names = collections.Counter(r["name"] for r in mine)
        assert names["enrichment.go"] == 1
        assert names["enrichment.go_census"] == 1 + len(chunks)
        assert names["enrichment.go_table"] == len(chunks)
        assert names["enrichment.go_lookup"] == len(chunks)
        assert names["facade.go_operands"] == (1 if k == 0 else 0)
        assert [r["attrs"] for r in mine if r["name"] == "facade.attr_prep"] \
            == ([{"route": "upload"}] if k == 0 else [])
        assert sorted(r["attrs"]["site"] for r in mine
                      if r["name"] == "facade.wait") == ["go_K", "go_n_max"]
        tables = [r["attrs"] for r in mine
                  if r["name"] == "enrichment.go_table"]
        assert tables == [dict(R=ch["R"], S_max=ch["S_max"], C=ch["C"],
                               route="torch") for ch in chunks]
        if k == 0:
            # the upload, the operand prep, then the band front, then the
            # engine
            start = {r["name"]: r["start_ns"] for r in mine}
            assert (start["facade.attr_prep"] < start["facade.go_operands"]
                    < start["neighborhoods.front"] < start["enrichment.go"])
        # the chunk's census, table and lookup run in that order
        order = [r["name"] for r in sorted(mine, key=lambda r: r["start_ns"])
                 if r["name"].startswith("enrichment.go_")]
        assert order == (["enrichment.go_census"] + [
            "enrichment.go_census", "enrichment.go_table",
            "enrichment.go_lookup"] * len(chunks))
    with open(prof.trace_path) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(PARENTS) <= traced


def test_go_spans_change_no_output(tmp_path):
    sf, go = _session()
    off = _analysis(sf, go)
    with profiling.trace(str(tmp_path / "tr")):
        on = _analysis(sf, go)
    assert len(profiling.span_records()) > 0
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


def test_go_table_spans_name_the_route_that_built_each_table(_fresh,
                                                             tmp_path):
    """Every ``enrichment.go_table`` span carries ``route``, the value of
    ``htab.route`` for the session's device; on the CPU that is the slot
    loop, and no kernel launches (``htab.LAUNCHES``)."""
    plans = _fresh
    sf, go = _session()
    htab.reset_launches()
    with profiling.trace(str(tmp_path / "tr")):
        _analysis(sf, go)
    routes = [r["attrs"].get("route") for r in profiling.span_records()
              if r["name"] == "enrichment.go_table"]
    chunks = len(plans[0]["chunks"])
    assert routes == [htab.route(sf.device)] * chunks == ["torch"] * chunks
    assert htab.LAUNCHES == {"logsf_table": 0}


# the dense fused GO path's spans and their parents
DENSE_PARENTS = {"facade.load_attributes": {None},
                 "facade.run_pipeline": {None},
                 "facade.attr_prep": {"facade.run_pipeline"},
                 "neighborhoods.front": {"facade.run_pipeline"},
                 "neighborhoods.relax": {"neighborhoods.front"},
                 "enrichment.go": {"facade.run_pipeline"},
                 "enrichment.go_census": {"enrichment.go"},
                 "enrichment.go_tail": {"enrichment.go"},
                 "enrichment.go_table": {"enrichment.go"},
                 "enrichment.go_lookup": {"enrichment.go"}}
DENSE_ENGINES = {"loop": "loop-dense-fused", "table": "table-dense-fused"}


def _bound(go):
    """The tail loop's iteration bound for ``go`` (``SAFE._fused_hypergeom``
    's)."""
    M = int(np.any(~np.isnan(go), axis=1).sum())
    k_max = int(np.nanmax(np.nansum(go, axis=0)))
    return hyper.tail_iterations(M, min(k_max, M))


@pytest.mark.parametrize("engine", sorted(DENSE_ENGINES))
def test_dense_go_spans_nest_and_carry_the_tail(engine, tmp_path):
    """A dense fused GO analysis (the certified window, ``apsp_mode``
    'auto') records its front, ``enrichment.go`` and the census, then the
    f64 tail (cells, bound, the bodies run) or the class table and its
    lookup; the window relax names its engine."""
    net = _network()
    sf = SAFE(device="cpu", verbose=False)
    sf.hypergeom_engine = engine
    sf.load_network(network_file=net)
    go = _go(net[0])
    with profiling.trace(str(tmp_path / "tr")) as prof:
        sf.load_attributes(attribute_file=go)
        sf.run_pipeline()
    assert sf.apsp_engine_used == "banded-window"
    assert sf._hypergeom_engine_used == DENSE_ENGINES[engine]
    recs = profiling.span_records()
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id[r["parent"]]["name"] if r["parent"] else None
        assert parent in DENSE_PARENTS[r["name"]], (r["name"], parent)
    names = collections.Counter(r["name"] for r in recs)
    assert names["neighborhoods.front"] == names["neighborhoods.relax"] \
        == names["enrichment.go"] == names["enrichment.go_census"] == 1
    attrs = {r["name"]: r["attrs"] for r in recs}
    assert attrs["neighborhoods.relax"] == {"engine": "window",
                                            "rounds": -(-N_NODES // 128)}
    if engine == "loop":
        assert "enrichment.go_table" not in names
        tail = attrs["enrichment.go_tail"]
        assert tail["cells"] == N_NODES * TERMS
        assert tail["bound"] == _bound(go)
        assert 1 <= tail["iterations"] <= tail["bound"]
    else:
        assert "enrichment.go_tail" not in names
        assert names["enrichment.go_table"] == names[
            "enrichment.go_lookup"] == 1
        table = attrs["enrichment.go_table"]
        assert sorted(table) == ["C", "R", "S_max", "route"]
        assert table["route"] == "torch"
    order = [r["name"] for r in sorted(recs, key=lambda r: r["start_ns"])
             if r["name"].startswith(("neighborhoods.front",
                                      "enrichment.go"))]
    assert order[:3] == ["neighborhoods.front", "enrichment.go",
                         "enrichment.go_census"]
    with open(prof.trace_path) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(names) <= traced


def test_every_tail_loop_route_counts_its_iterations(tmp_path):
    """The band loop (``loop-band``) and the host route
    (``hypergeom_sf``) record ``enrichment.go_tail`` spans whose
    ``iterations`` lie within their ``bound``; off, none."""
    sf, go = _session()
    sf.hypergeom_engine = "loop"
    k = torch.tensor([[0.0, 2.0, 5.0], [1.0, 3.0, 9.0]])
    with profiling.trace(str(tmp_path / "tr")):
        sf.load_attributes(attribute_file=go)
        sf.run_pipeline()
        hyper.hypergeom_sf(k, 60, torch.tensor([[5.0, 9.0, 20.0]]),
                           torch.tensor([[10.0], [30.0]]))
    assert sf._hypergeom_engine_used == "loop-band"
    tails = [r["attrs"] for r in profiling.span_records()
             if r["name"] == "enrichment.go_tail"]
    assert len(tails) >= 2 and tails[-1]["cells"] == 6
    assert sum(t["cells"] for t in tails[:-1]) >= N_NODES * TERMS
    for t in tails:
        assert 1 <= t["iterations"] <= t["bound"]
    profiling.reset_spans()
    hyper.hypergeom_sf(k, 60, torch.tensor([[5.0, 9.0, 20.0]]),
                       torch.tensor([[10.0], [30.0]]))
    assert len(profiling.SPANS) == 0
