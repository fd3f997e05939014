"""The port's dense path, as the benchmark's ``costanzo2016`` cells run it,
against the benchmark's plain reference (``portbench/reference/``).

Upstream's Example_1 network (the ``costanzo2016`` configuration: its
radius type and radius, ``apsp_mode='auto'``, its edges per node) cut to 512
nodes, where 'auto' takes the certified banded window as at 3,971. The
``quant10k`` mix with 200 permutations given as ``perm_idx`` (the dense
null), and the ``gobp`` mix at 48 terms of sizes 3-30 under the f64 tail
loop (``hypergeom_engine='loop'``: at the published 4,373 terms 'auto'
takes the same loop, the class table being over its budget). Every
analysis runs through the benchmark's own client and is held to the cell's
own limits file by the cell's own judge (``portbench.compare``); a fault
planted under the timed path reads ``correct`` false.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, harness, spec  # noqa: E402

CPU = torch.device("cpu")
N_NODES = 512
SEED = 2 ** 41 + 7
# the hypergeometric engine each cell's analyses take (None: no GO)
ENGINES = {"costanzo2016.quant10k": None,
           "costanzo2016.gobp": "loop-dense-fused"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain FW and the tail loop are loops of small torch ops; under
    parallel workers more threads only oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cell(workload: str) -> spec.Cell:
    """The cell at N_NODES nodes, its edges per node kept; a short null or
    a small GO matrix under the tail loop."""
    cell = spec.load_cell(ROOT, workload)
    net = cell.config["network"]
    net["edge_budget"] = round(net["edge_budget"] * N_NODES / net["nodes"])
    net["nodes"] = N_NODES
    if cell.traffic["kind"] == "quantitative":
        cell.traffic.update(pool=3, num_permutations=200)
    else:
        cell.traffic.update(pool=2, terms=48,
                            term_sizes={"low": 3, "high": 30})
        cell.traffic["settings"] = dict(cell.traffic["settings"],
                                        hypergeom_engine="loop")
    return cell


def run_small(workload: str):
    """Every pool entry analysed once through the benchmark's client, then
    judged: (correct, checks, judge, outputs)."""
    cell = small_cell(workload)
    limits = compare.load_limits(ROOT, workload, cell.kind.NUMBERS)
    inputs = harness.make_inputs(cell, SEED, CPU)
    sf = harness.make_session(cell, inputs, CPU)
    client = harness.Client(sf, inputs, cell.kind, CPU,
                            count_launches=False)
    for i in range(len(inputs.pool)):
        client.analysis(i)
        assert sf.apsp_engine_used == "banded-window"
        assert sf._hypergeom_engine_used == ENGINES[workload]
    assert client.failed == 0
    outputs = [out for _, out in client.sample()]
    j = harness.judge(client, sf.neighborhoods_sparse(), CPU)
    correct, checks = compare.verdict(j.readings, limits)
    return correct, checks, j, outputs


@pytest.mark.parametrize("workload", sorted(ENGINES))
def test_dense_path_matches_the_plain_reference(workload):
    correct, checks, j, outputs = run_small(workload)
    assert correct, checks
    assert j.rows_off == 0 and j.checked == len(outputs) >= 2
    assert checks["nbhd_ulps"]["value"] == 0.0
    assert checks["nes_binary_bad"]["value"] == 0
    # some cells are enriched, so the calls are tested
    assert any(np.asarray(out["nes_binary"]).any() for out in outputs)


def _quant_call_flipped(monkeypatch):
    from safepy_tpu_torch import safe

    update = safe.SAFE._update_binary_enrichment

    def flipped(self):
        update(self)
        b = self.nes_binary.copy()
        b[5, 0] = 1.0 - b[5, 0]
        self.nes_binary = b
    monkeypatch.setattr(safe.SAFE, "_update_binary_enrichment", flipped)


def _go_call_flipped(monkeypatch):
    """One call of the tail's device finalization flipped."""
    from safepy_tpu_torch.ops import hypergeom as hyper

    finalize = hyper.finalize_logsf_device

    def flipped(parts, threshold):
        nes, log_sf, nbin = finalize(parts, threshold)
        nbin = nbin.clone()
        nbin[5, 0] = 1 - nbin[5, 0]
        return nes, log_sf, nbin
    monkeypatch.setattr(hyper, "finalize_logsf_device", flipped)


def _go_count_off(monkeypatch):
    """The largest census count one too high in the tail loop's input."""
    from safepy_tpu_torch.ops import hypergeom as hyper

    parts = hyper._sf_parts

    def off(k, *args):
        k = k.clone()
        k.view(-1)[torch.argmax(k)] += 1.0
        return parts(k, *args)
    monkeypatch.setattr(hyper, "_sf_parts", off)


FAULTS = {("costanzo2016.quant10k", "call_flipped"): (_quant_call_flipped,
                                                      "nes_binary_bad"),
          ("costanzo2016.gobp", "call_flipped"): (_go_call_flipped,
                                                  "nes_binary_bad"),
          ("costanzo2016.gobp", "count_off"): (_go_count_off, "nes_ulps")}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_planted_fault_reads_incorrect(workload, fault, monkeypatch):
    plant, number = FAULTS[(workload, fault)]
    plant(monkeypatch)
    correct, checks, _, _ = run_small(workload)
    assert not correct
    assert checks[number]["value"] > checks[number]["limit"]
