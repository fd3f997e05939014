"""One run of one cell: set-up, the measured window, the comparison, the
metrics.

The window is a closed loop with one client. One *analysis* is
``SAFE.load_attributes(attribute_file=<array>)``, then
``SAFE.run_pipeline(perm_idx=<the set-up's permutations>)``, then a device
synchronize; it ends when its results are on the host. The session's network
is loaded during set-up, and the window cycles through the attribute pool
that set-up made from the seed.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from portbench import compare, spec, trace
from portbench import traffic as traffic_mod

# spans of the traced window: at these shares of it, each at least
# SPAN_SECONDS of whole analyses and at most SPAN_ANALYSES of them; the
# device metrics read the spans of device ops alone, the breakdown's idle
# gaps the one that records the host's ops too
SPAN_AT = ((0.2, False), (0.5, True), (0.8, False))
SPAN_SECONDS, SPAN_ANALYSES = 0.25, 20
# analyses whose outputs are compared, drawn from the seed among those the
# window completed; the last one always, whose neighborhoods are compared
SAMPLE = 8
FORBIDDEN = ("jax", "jaxlib", "flax", "safepy_tpu")


def make_inputs(cell: spec.Cell, seed: int, device) -> SimpleNamespace:
    """What the benchmark makes from the seed and hands to both sides: the
    network (``networks/<network.kind>.py``), the session's settings, and
    what the mix's kind makes (``kinds/<kind>.py``: the attribute pool and
    the rest of its inputs)."""
    net_seed, kind_seed = traffic_mod.seeds(seed, 2)
    network = spec.module("networks", cell.config["network"]["kind"]).build(
        cell.config["network"], net_seed)
    return SimpleNamespace(network=network, settings=cell.settings,
                           **cell.kind.make(cell, network, kind_seed, device))


def make_session(cell: spec.Cell, inputs, device):
    """A ``SAFE`` session on ``device`` with the cell's settings and its
    network loaded."""
    from safepy_tpu_torch import SAFE

    sf = SAFE(device=device, verbose=False)
    for key, value in inputs.settings.items():
        if not hasattr(sf, key):
            raise AttributeError(f"SAFE has no setting {key!r}")
        setattr(sf, key, value)
    sf.load_network(network_file=inputs.network.network_file)
    return sf


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Client:
    """The closed loop's one client: runs analyses and keeps what the
    window needs of each (times, launch counts when traced) and the
    outputs of a sample: SAMPLE analyses drawn uniformly from the seed among
    those completed (a reservoir, so that the window holds no more), and
    the last."""

    def __init__(self, sf, inputs, kind, device, count_launches: bool,
                 seed: int = 0):
        self.sf, self.inputs, self.kind = sf, inputs, kind
        self.device = device
        self.count_launches = count_launches
        self.reset(seed)

    def reset(self, seed: int):
        """Forget the analyses so far (the warm-up's); draw the sample from
        ``seed``."""
        self.starts, self.ends, self.load_s, self.launches = [], [], [], []
        self.rng = np.random.default_rng(seed)
        self.kept = []     # [(analysis, pool index, outputs)]
        self.last = None
        self.attempted = self.failed = 0

    def analysis(self, i: int):
        """Analysis ``i``: pool entry ``i % len(pool)``."""
        from safepy_tpu_torch.ops import apsp_cuda

        sf, k = self.sf, i % len(self.inputs.pool)
        self.attempted += 1
        if self.count_launches:
            apsp_cuda.reset_launches()
        t0 = time.perf_counter()
        try:
            sf.load_attributes(attribute_file=self.inputs.pool[k])
            t1 = time.perf_counter()
            sf.run_pipeline(**self.kind.run_kwargs(self.inputs))
            _sync(self.device)
        except Exception:  # a failed analysis is counted, the loop goes on
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            return
        t2 = time.perf_counter()
        done = len(self.ends)
        self.starts.append(t0)
        self.ends.append(t2)
        self.load_s.append(t1 - t0)
        self.last = (done, k, self.kind.keep(sf))
        if done < SAMPLE:
            self.kept.append(self.last)
        else:
            slot = int(self.rng.integers(0, done + 1))
            if slot < SAMPLE:
                self.kept[slot] = self.last
        if self.count_launches:
            self.launches.append(dict(apsp_cuda.LAUNCHES))

    def sample(self) -> list:
        """[(pool index, outputs)] of the analyses compared, in order."""
        entries = self.kept + ([self.last] if self.last else [])
        kept = {a: (k, out) for a, k, out in entries}
        return [kept[a] for a in sorted(kept)]


def run_window(client: Client, seconds: float, traced: bool):
    """Analyses until ``seconds`` have passed; with ``traced``, three
    profiled spans of whole analyses inside. Returns (t0, spans)."""
    spans, due = [], list(SPAN_AT) if traced else []
    i = 0
    t0 = time.perf_counter()
    while True:
        if due and time.perf_counter() - t0 >= due[0][0] * seconds:
            host = due.pop(0)[1]

            def one():
                nonlocal i
                client.analysis(i)
                i += 1
            spans.append(trace.profile_span(
                one, SPAN_SECONDS, SPAN_ANALYSES, host=host,
                cuda=torch.device(client.device).type == "cuda"))
        else:
            client.analysis(i)
            i += 1
        if time.perf_counter() - t0 >= seconds:
            return t0, spans


def shapes(sf) -> dict:
    """The shapes of the last analysis's FW, as the session reports them."""
    nbr = getattr(sf, "_neighborhoods_dev", None)
    return dict(n=int(sf._num_nodes), engine=sf.apsp_engine_used,
                window=sf.window_used, bt=getattr(nbr, "bt", None),
                symmetric=True)


def card(device) -> dict:
    """The device block of the result line (``count`` filled by the
    caller)."""
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(0))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def judge(client: Client, program_rows, device):
    """The comparison of the window's outputs with the reference."""
    j = client.kind.Judge(client.inputs, device)
    j.judge_neighborhoods(program_rows)
    for pool_index, outputs in client.sample():
        j.judge_analysis(pool_index, outputs)
    return j


def log_window(log, ctx, setup_s: float, j) -> None:
    """The window's rate by fifths, its spread of walls, and what was
    compared, on standard error."""
    ends = np.asarray(ctx.ends)
    walls = ends - np.asarray(ctx.starts)
    fifths = np.searchsorted(ends, np.linspace(0, ends[-1], 6)[1:],
                             side="right")
    log("analyses/s by fifth of the window: " + " ".join(
        f"{5 * c / ends[-1]:.3f}" for c in np.diff(np.r_[0, fifths])))
    quantiles = np.percentile(walls, [0, 50, 95, 100])
    log(f"window: {len(ends)} analyses in {ends[-1]:.3f} s, wall min / p50 "
        f"/ p95 / max {' / '.join(f'{x:.5f}' for x in quantiles)} s, "
        f"set-up {setup_s:.3f} s; compared {j.checked} analyses, "
        f"{j.rows_off} rows off the reference's neighborhoods; shapes "
        f"{ctx.shapes}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(cell: spec.Cell, limits: dict, seed: int, seconds: float,
        traced: bool, device, t_start: float, log=print) -> dict:
    """One run of ``cell``, judged against ``limits``; returns the result
    line's dict. ``t_start`` is the process's start on the
    ``time.perf_counter`` clock."""
    marks = [("imports and the CUDA context", time.perf_counter())]
    inputs = make_inputs(cell, seed, device)
    marks.append(("inputs from the seed", time.perf_counter()))
    sf = make_session(cell, inputs, device)
    marks.append(("load_network", time.perf_counter()))
    client = Client(sf, inputs, cell.kind, device, count_launches=traced)
    for i in range(int(cell.traffic.get("warmup", 2))):
        client.analysis(i)
    if client.failed:
        raise RuntimeError("the warm-up analyses failed")
    client.reset(traffic_mod.seeds(seed, 3)[2])
    marks.append(("warm-up analyses (the kernel library's load or build "
                  "with the first)", time.perf_counter()))
    log("set-up: " + "; ".join(
        f"{name} {t - (marks[k - 1][1] if k else t_start):.3f} s"
        for k, (name, t) in enumerate(marks)))
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    t0, spans = run_window(client, seconds, traced)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for k, span in enumerate(spans):
        log(f"span {k}: {span.read().summary()}")
    if client.last is None:
        raise RuntimeError("no analysis completed in the window")
    dev = card(device)
    dev.update(count=1 if cuda else 0,
               memory_peak_bytes=int(max(peak, setup_peak)))
    device_spans = [s for s in spans if not s.host_ops] or spans
    ctx = SimpleNamespace(
        setup_s=setup_s, starts=[s - t0 for s in client.starts],
        ends=[e - t0 for e in client.ends], load_s=client.load_s,
        launches=client.launches, peak_bytes=peak, spans=device_spans,
        host_spans=[s for s in spans if s.host_ops], session=sf,
        shapes=shapes(sf), card=dev, config=cell.config,
        traffic=cell.traffic)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs on the device
    program_rows = sf.neighborhoods_sparse()
    client.sf = ctx.session = sf = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    j = judge(client, program_rows, device)
    correct, checks = compare.verdict(j.readings, limits)
    result = dict(correct=bool(correct and client.failed == 0),
                  attempted=client.attempted, failed=client.failed,
                  metrics=metrics, device=dev)
    if traced:
        dev["busy_s"] = sum(s.busy_s() for s in device_spans)
        dev["window_s"] = sum(s.wall_s for s in device_spans)
        gaps = {}
        for s in ctx.host_spans:
            for name, secs in trace.idle_gaps(s):
                gaps[name] = gaps.get(name, 0.0) + secs
        result["breakdown"] = dict(
            device_ops=trace.device_ops(device_spans),
            idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                             key=lambda kv: kv[1], reverse=True)[:10])
        log(f"card: {dev['kind']}, power limit {dev.get('power_limit_w')} W "
            f"(beside kernels.fw_roofline_pct)")
    log_window(log, ctx, setup_s, j)
    result["checks"] = checks
    return result
