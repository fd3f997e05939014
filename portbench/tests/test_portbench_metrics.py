"""The metric arithmetic: the rate over the whole window, the tail over all
analyses, the trace's unions and gaps, and readers that find nothing."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import spec, trace


def ctx(**kw):
    base = dict(setup_s=9.5, starts=[], ends=[], load_s=[], launches=[],
                peak_bytes=0, spans=[], card={},
                shapes=dict(n=3971, engine="banded-window", window=1024,
                            bt=None, symmetric=True))
    base.update(kw)
    return SimpleNamespace(**base)


def test_rate_is_all_work_over_all_time():
    # three analyses, the last ending at 2.0 s: 1.5 analyses/s, whatever
    # their single times
    c = ctx(starts=[0.0, 0.1, 1.9], ends=[0.1, 1.9, 2.0])
    assert spec.reader("analyses_per_s")(c) == pytest.approx(1.5)


def test_p95_is_over_every_analysis():
    walls = np.arange(1, 101, dtype=float) / 100.0   # 0.01 .. 1.00 s
    starts = np.cumsum(np.r_[0.0, walls[:-1]])
    c = ctx(starts=list(starts), ends=list(starts + walls))
    got = spec.reader("analysis_p95_s")(c)
    assert got == pytest.approx(np.percentile(walls, 95))
    assert got == pytest.approx(0.9505)


def test_host_metrics():
    c = ctx(load_s=[0.001, 0.003],
            launches=[{"close_diag": 32, "relax_panel": 64,
                       "relax_window_sym": 32}] * 2, peak_bytes=2.5e9)
    assert spec.reader("facade.load_attributes_ms")(c) == pytest.approx(2.0)
    assert spec.reader("neighborhoods.fw_launches")(c) == 128
    assert spec.reader("peak_mem_gb")(c) == pytest.approx(2.5)
    assert spec.reader("setup_s")(c) == 9.5


def test_union_seconds():
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0
    assert trace.union_seconds([]) == 0.0


def span():
    # two analyses in 1.0 s of wall; 0.3 s of min-plus kernels, 0.25 s of
    # other device work, overlapping by 0.05 s
    s = trace.Span(1.0, 2)
    s.device = [("void relax_panel_kernel<128>(...)", 10.0, 10.1),
                ("void close_diag_kernel<128>(...)", 10.2, 10.4),
                ("ampere_sgemm_128x64_nn", 10.35, 10.6)]
    s.host = [(trace.ANALYSIS, 10.0, 10.5), (trace.ANALYSIS, 10.5, 11.0),
              ("aten::copy_", 10.56, 10.9), ("aten::index", 10.1, 10.2)]
    return s


def test_device_readers_and_breakdown():
    s = span()
    c = ctx(spans=[s])
    assert s.busy_s() == pytest.approx(0.5)
    assert spec.reader("device.idle_pct")(c) == pytest.approx(50.0)
    assert spec.reader("enrichment.device_ms")(c) == pytest.approx(125.0)
    got = spec.reader("kernels.fw_roofline_pct")(c)
    from portbench import work
    least, _ = work.least_seconds(*work.window_fw_work(3971, 1024))
    assert got == pytest.approx(100 * least / 0.15)
    gaps = trace.idle_gaps(s)
    assert gaps[0][0] == "aten::copy_" and gaps[0][1] == pytest.approx(0.4)
    assert ["aten::index", pytest.approx(0.1)] in gaps
    ops = trace.device_ops([s])
    assert ops[0][0].startswith("ampere_sgemm")


def test_readers_find_nothing_without_a_trace():
    c = ctx()
    for name in ("kernels.fw_roofline_pct", "enrichment.device_ms",
                 "device.idle_pct", "facade.load_attributes_ms",
                 "neighborhoods.fw_launches", "peak_mem_gb"):
        assert spec.reader(name)(c) is None
    # an engine whose FW work is not counted reads nothing
    c = ctx(spans=[span()], shapes=dict(n=10, engine="dense", window=None,
                                        bt=None, symmetric=True))
    assert spec.reader("kernels.fw_roofline_pct")(c) is None
