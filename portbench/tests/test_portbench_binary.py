"""The ``binary`` kind and the ``genome20k.gobp`` cell on the CPU at a small
size: a sound run is correct and leaves the GO metrics its spans give on a
CPU; each fault the cell's numbers must catch, planted in the program under
the timed path (a flipped call, one column's class shifted by one, one
chunk's columns left at zero), makes it not correct; the control is
refused. The five GO readers on synthetic span records, and nothing read
from a program without the spans."""

import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import compare, harness, spans, spec

CPU = torch.device("cpu")
WORKLOAD = "genome20k.gobp"
NODES, TERMS, CHUNK_COLS = 400, 48, 16
SEED = 2 ** 37 + 29
GO_METRICS = ("enrichment.go_census_stream_ms", "enrichment.go_table_host_ms",
              "enrichment.go_table_stream_ms",
              "enrichment.go_lookup_stream_ms", "enrichment.go_table_cells")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cell(root):
    cell = spec.load_cell(root, WORKLOAD)
    cell.config["network"]["nodes"] = NODES
    cell.config["settings"]["apsp_mode"] = "band"
    cell.config["settings"]["neighborhood_radius"] = math.sqrt(
        125 / (math.pi * NODES))
    cell.traffic.update(pool=2, terms=TERMS,
                        term_sizes={"low": 3, "high": 30})
    return cell


def run_small(root, traced=False):
    cell = small_cell(root)
    limits = compare.load_limits(root, WORKLOAD, cell.kind.NUMBERS)
    return harness.run(cell, limits, SEED, 0.05, traced, CPU,
                       time.perf_counter(), log=lambda line: None)


@pytest.fixture
def plans(monkeypatch):
    """Chunks of CHUNK_COLS columns (three a matrix); the plans that ran."""
    from safepy_tpu_torch.ops import hypergeom_table as htab

    out, plan = [], htab.plan

    def recorded(K_np, n_max, M, **kw):
        p = plan(K_np, n_max, M, **dict(kw, chunk_cols=CHUNK_COLS))
        out.append(p)
        return p
    monkeypatch.setattr(htab, "plan", recorded)
    return out


def test_sound_run_is_correct(root, plans, monkeypatch):
    from safepy_tpu_torch import profiling

    # one profiled session at the window's start, so that the short window
    # holds it however long an analysis takes here
    monkeypatch.setattr(harness, "SPAN_AT", ((0.0, False),))
    profiling.reset_spans()
    r = run_small(root, traced=True)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"nbhd_ulps", "nes_ulps", "nes_binary_bad"}
    # on the CPU spans have no stream time: the host time and the cells
    m = r["metrics"]
    assert m["enrichment.go_table_host_ms"]["value"] > 0
    recs = spans.records()
    runs = sum(1 for x in recs if x["name"] == spans.RUN
               and x["parent"] is None)
    cells = sum(x["attrs"]["R"] * x["attrs"]["S_max"] * x["attrs"]["C"]
                for x in recs if x["name"] == "enrichment.go_table")
    assert runs and m["enrichment.go_table_cells"]["value"] == \
        pytest.approx(cells / runs)
    # each table span's geometry is a chunk's of a plan that ran
    planned = {(c["R"], c["S_max"], c["C"]) for p in plans
               for c in p["chunks"]}
    assert {(x["attrs"]["R"], x["attrs"]["S_max"], x["attrs"]["C"])
            for x in recs if x["name"] == "enrichment.go_table"} <= planned
    for name in GO_METRICS[:1] + GO_METRICS[2:4]:
        assert name not in m       # no stream time without CUDA
    profiling.reset_spans()


def _call_flipped(monkeypatch):
    from safepy_tpu_torch import safe

    update = safe.SAFE._update_binary_enrichment

    def flipped(self):
        update(self)
        b = self.nes_binary.copy()
        b[5, 0] = 1.0 - b[5, 0]
        self.nes_binary = b
    monkeypatch.setattr(safe.SAFE, "_update_binary_enrichment", flipped)


def _class_shifted(monkeypatch):
    """Column 0 of every plan's first chunk reads the next class's table."""
    from safepy_tpu_torch.ops import hypergeom_table as htab

    plan = htab.plan

    def shifted(*a, **kw):
        p = plan(*a, **kw)
        colc = p["chunks"][0]["colc"].copy()
        colc[0] = (colc[0] + 1) % p["chunks"][0]["C"]
        p["chunks"][0]["colc"] = colc
        return p
    monkeypatch.setattr(htab, "plan", shifted)


def _chunk_left_at_zero(monkeypatch):
    """The chunk at column CHUNK_COLS placed as zeros."""
    from safepy_tpu_torch.ops import enrich_band

    place = enrich_band._place_chunk

    def zeroed(logsf, nbin, logsf_c, bin_c, start):
        if start == CHUNK_COLS:
            logsf_c, bin_c = torch.zeros_like(logsf_c), torch.zeros_like(
                bin_c)
        place(logsf, nbin, logsf_c, bin_c, start)
    monkeypatch.setattr(enrich_band, "_place_chunk", zeroed)


FAULTS = {"call_flipped": (_call_flipped, "nes_binary_bad"),
          "class_shifted": (_class_shifted, "nes_ulps"),
          "chunk_left_at_zero": (_chunk_left_at_zero, "nes_ulps")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(root, plans, fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    r = run_small(root)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


def test_control_is_not_correct(root):
    """The reference in the program's place, one precision step down
    (bfloat16 distances, the test in f32), fails the cell's limits."""
    cell = small_cell(root)
    limits = compare.load_limits(root, WORKLOAD, cell.kind.NUMBERS)
    inputs = harness.make_inputs(cell, SEED + 1, CPU)
    control = cell.kind.Reference(inputs, CPU, lowered=True, block=128)
    j = cell.kind.Judge(inputs, CPU, block=128)
    j.judge_neighborhoods(control.neighborhoods())
    for k in range(len(inputs.pool)):
        j.judge_analysis(k, control.outputs(k))
    correct, checks = compare.verdict(j.readings, limits)
    assert not correct
    assert checks["nbhd_ulps"]["value"] > checks["nbhd_ulps"]["limit"]
    assert checks["nes_ulps"]["value"] > checks["nes_ulps"]["limit"]


def test_pool_shares_one_mask_and_repeats_from_the_seed(root):
    cell = small_cell(root)
    net = SimpleNamespace(coords=np.random.default_rng(1).uniform(
        -1, 1, (NODES, 2)))
    a = cell.kind.make(cell, net, 99, CPU)["pool"]
    b = cell.kind.make(cell, net, 99, CPU)["pool"]
    c = cell.kind.make(cell, net, 100, CPU)["pool"]
    assert all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0], equal_nan=True)
    mask = np.isnan(a[0])
    assert np.array_equal(mask, np.isnan(a[1]))
    assert np.array_equal(mask.all(axis=1), mask.any(axis=1))
    assert not np.array_equal(a[0], a[1], equal_nan=True)
    sizes = np.nansum(a[0], axis=0)
    assert sizes.min() >= 3 and sizes.max() <= 30
    assert set(np.unique(a[0][~mask])) <= {0.0, 1.0}


# --------------------------------------------------------------- readers

MS = 10 ** 6  # ns


def go_analysis(t0_ms, first_id, *, chunks=2, stream=1.0, attrs=True):
    """The records of one GO analysis: run_pipeline (100 ms) over the
    operand build, a front, and ``enrichment.go`` (80 ms): the sizes'
    census (1 ms), then ``chunks`` chunks of a census (2 ms), a table
    (20 ms; R 256, S_max 256, C 128 + 64 k) and a lookup (5 ms); stream
    times ``stream`` x host (None: no CUDA)."""
    i = iter(range(first_id, first_id + 100))
    out = []

    def rec(name, parent, root, start, host, **a):
        rid = next(i)
        out.append(dict(name=name, id=rid, parent=parent,
                        root=rid if root is None else root, attrs=a,
                        start_ns=int(start * MS),
                        end_ns=int((start + host) * MS), host_ms=host,
                        self_host_ms=host,
                        stream_ms=None if stream is None else stream * host))
        return rid

    run = rec("facade.run_pipeline", None, None, t0_ms, 100.0)
    rec("facade.go_operands", run, run, t0_ms + 1, 3.0)
    go = rec("enrichment.go", run, run, t0_ms + 15, 80.0)
    rec("enrichment.go_census", go, run, t0_ms + 16, 1.0)
    t = t0_ms + 18
    for k in range(chunks):
        rec("enrichment.go_census", go, run, t, 2.0)
        rec("enrichment.go_table", go, run, t + 2, 20.0,
            **(dict(R=256, S_max=256, C=128 + 64 * k) if attrs else {}))
        rec("enrichment.go_lookup", go, run, t + 22, 5.0)
        t += 27
    return out


def sessions_of(**kw):
    recs, t, nid = [], 0.0, 1
    for _ in range(3):
        for _ in range(2):
            recs += go_analysis(t, nid, **kw)
            nid += 100
            t += 101.0
        t += 5000.0
    return recs


def test_go_readers(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: sessions_of(stream=1.5))
    ctx = SimpleNamespace()
    read = {name: spec.reader(name) for name in GO_METRICS}
    assert read["enrichment.go_census_stream_ms"](ctx) == \
        pytest.approx(1.5 * (1 + 2 * 2))
    assert read["enrichment.go_table_host_ms"](ctx) == pytest.approx(40.0)
    assert read["enrichment.go_table_stream_ms"](ctx) == pytest.approx(60.0)
    assert read["enrichment.go_lookup_stream_ms"](ctx) == \
        pytest.approx(15.0)
    assert read["enrichment.go_table_cells"](ctx) == 256 * 256 * (128 + 192)


def test_go_readers_read_nothing_without_the_spans(monkeypatch):
    ctx = SimpleNamespace()
    read = {name: spec.reader(name) for name in GO_METRICS}
    # a program without spans at all, or without the GO spans (the
    # quantitative path's records only)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert all(r(ctx) is None for r in read.values())
    quant = [r for r in sessions_of()
             if not r["name"].startswith(("enrichment.go", "facade.go"))]
    monkeypatch.setattr(spans, "records", lambda: quant)
    assert all(r(ctx) is None for r in read.values())
    # table spans without their attrs; spans without stream times (CPU)
    monkeypatch.setattr(spans, "records", lambda: sessions_of(attrs=False))
    assert read["enrichment.go_table_cells"](ctx) is None
    monkeypatch.setattr(spans, "records", lambda: sessions_of(stream=None))
    assert read["enrichment.go_table_stream_ms"](ctx) is None
    assert read["enrichment.go_table_host_ms"](ctx) == pytest.approx(40.0)


def test_go_metrics_apply_to_the_go_cell_alone(root):
    go = {m["name"] for m in spec.load_cell(root, WORKLOAD).per_layer}
    quant = {m["name"] for m in spec.load_cell(
        root, "genome20k.quant10k").per_layer}
    assert set(GO_METRICS) <= go and not set(GO_METRICS) & quant
