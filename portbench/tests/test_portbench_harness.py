"""The harness end to end on the CPU at tiny sizes (its look for a card
skipped): a sound run is correct; each fault the cells can have, planted in
the program underneath the timed path, and the control make it not correct.
Also: no card, no result; what the benchmark may import."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, harness, spec

CPU = torch.device("cpu")
HERE = Path(__file__).resolve().parents[1]
# the cells of BENCHMARK.json and the one waiting (conftest.WAITING), each
# at a tiny size and the engine it takes at full size
SIZES = {"costanzo2016.quant10k": (400, "auto"),
         "genome20k.quant10k": (900, "band")}
CELLS = [w["name"] for w in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


def tiny_cell(root, bench, workload):
    nodes, mode = SIZES[workload]
    cell = spec.load_cell(root, workload, bench)
    cell.config["network"]["nodes"] = nodes
    if cell.config["network"].get("edge_budget"):
        cell.config["network"]["edge_budget"] = 7 * nodes
    cell.config["settings"]["apsp_mode"] = mode
    cell.traffic["num_permutations"] = 300
    return cell


def run_tiny(root, bench, workload, traced=False, seed=2 ** 36 + 17):
    cell = tiny_cell(root, bench, workload)
    limits = compare.load_limits(root, workload, cell.kind.NUMBERS)
    return harness.run(cell, limits, seed, 0.05, traced, CPU,
                       time.perf_counter(), log=lambda line: None)


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_sound_run_is_correct(root, bench, workload):
    r = run_tiny(root, bench, workload, traced=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(
        spec.load_cell(root, workload, bench).kind.NUMBERS)
    assert {"facade.load_attributes_ms", "neighborhoods.fw_launches"} <= set(
        r["metrics"])


def _fw_unchanged(monkeypatch):
    from safepy_tpu_torch.ops import apsp_banded, apsp_bandstore

    monkeypatch.setattr(apsp_banded, "fw_round", lambda *a, **k: None)
    monkeypatch.setattr(apsp_bandstore, "band_fw_round",
                        lambda *a, **k: None)


def _half_the_null(monkeypatch):
    """Half of the permutations scanned, the counts scaled up to P: the
    mean taken over the rest."""
    from safepy_tpu_torch import pipeline
    from safepy_tpu_torch.ops import permutation

    scan = permutation.count_scan

    def half_scan(chunk_scores, obs, *, num_permutations, batch_size):
        neg, pos = scan(chunk_scores, obs,
                        num_permutations=num_permutations // 2,
                        batch_size=batch_size)
        return 2 * neg, 2 * pos
    monkeypatch.setattr(permutation, "count_scan", half_scan)

    band = pipeline.scan_counts_band

    def half_band(*args, num_permutations, perm_idx=None, batch_size,
                  **kw):
        half = num_permutations // 2
        neg, pos = band(*args, num_permutations=half,
                        perm_idx=None if perm_idx is None
                        else perm_idx[:half],
                        batch_size=min(batch_size, half), **kw)
        return 2 * neg, 2 * pos
    monkeypatch.setattr(pipeline, "scan_counts_band", half_band)


def _score_altered(monkeypatch):
    from safepy_tpu_torch import safe

    store = safe.SAFE._store_null

    def altered(self, obs, counts_neg, counts_pos):
        obs = obs.clone()
        obs[0] += 1.0
        store(self, obs, counts_neg, counts_pos)
    monkeypatch.setattr(safe.SAFE, "_store_null", altered)


def _call_altered(monkeypatch):
    from safepy_tpu_torch import safe

    update = safe.SAFE._update_binary_enrichment

    def altered(self):
        update(self)
        flipped = self.nes_binary.copy()
        flipped[0, 0] = 1.0 - flipped[0, 0]
        self.nes_binary = flipped
    monkeypatch.setattr(safe.SAFE, "_update_binary_enrichment", altered)


# the faults these one-card cells can have; no exchange between chips
FAULTS = {"state_unchanged": (_fw_unchanged, "nbhd_ulps"),
          "half_the_batch": (_half_the_null, "count_flips_ppm"),
          "score_altered": (_score_altered, "score_rel"),
          "call_altered": (_call_altered, "nes_binary_bad")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_fault_makes_the_run_incorrect(root, bench, workload, fault,
                                      monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    r = run_tiny(root, bench, workload)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_is_not_correct(root, bench, workload):
    """The reference in the program's place, one precision step down
    (bfloat16 distances, TF32 contractions), fails the cell's limits."""
    cell = tiny_cell(root, bench, workload)
    limits = compare.load_limits(root, workload, cell.kind.NUMBERS)
    inputs = harness.make_inputs(cell, 2 ** 36 + 3, CPU)
    control = cell.kind.Reference(inputs, CPU, lowered=True, block=128)
    j = cell.kind.Judge(inputs, CPU, block=128)
    j.judge_neighborhoods(control.neighborhoods())
    for k in range(4):
        j.judge_analysis(k, control.outputs(k))
    correct, checks = compare.verdict(j.readings, limits)
    assert not correct
    assert checks["nbhd_ulps"]["value"] > checks["nbhd_ulps"]["limit"]
    assert checks["score_rel"]["value"] > checks["score_rel"]["limit"]


def test_no_card_no_result(root, tmp_path):
    """Without a card the command exits non-zero and prints no result, also
    in a directory holding only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (root, tmp_path):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            "genome20k.quant10k", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=where,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def sources(sub=""):
    return sorted((HERE / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "math", "__future__"), \
                (path, name)
    p = subprocess.run(
        [sys.executable, "-c", "import sys; import portbench.reference."
         "shortpath_weighted_layout, portbench.reference.enrichment; "
         "print(sorted(m for m in sys.modules if m.startswith('safepy')))"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and json.loads(p.stdout.replace("'", '"')) == []


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    import safepy_tpu_torch  # noqa: F401  (its name begins with safepy_tpu)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "safepy_tpu", object())
    assert harness.forbidden_modules() == ["jax", "safepy_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(root, workload, cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "12345678901", "--seconds", "3",
                        "--trace", "1"], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


def test_every_cell_finds_its_code_by_name(root, bench):
    """A cell's network generator, distance reference, kind of analysis,
    limits and metric readers are files found by the names its entries
    give: a later cell, configuration, mix or metric adds files."""
    for w in bench["workloads"]:
        cell = spec.load_cell(root, w["name"], bench)
        kind = cell.kind
        for attr in ("NUMBERS", "make", "run_kwargs", "keep", "Reference",
                     "Judge"):
            assert hasattr(kind, attr), (w["name"], attr)
        assert "nbhd_ulps" in kind.NUMBERS
        assert callable(spec.module(
            "networks", cell.config["network"]["kind"]).build)
        metric = spec.module("reference",
                             cell.settings["node_distance_metric"])
        assert callable(metric.radius) and callable(metric.distances)
        assert set(compare.load_limits(root, w["name"], kind.NUMBERS)) == \
            set(kind.NUMBERS)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    with pytest.raises(FileNotFoundError):
        spec.module("kinds", "no_such_kind")


def test_limits_need_every_number_of_the_kind(root, tmp_path):
    (tmp_path / "portbench" / "limits").mkdir(parents=True)
    (tmp_path / "portbench" / "limits" / "x.json").write_text(
        json.dumps({"limits": {"nbhd_ulps": 1}}))
    assert compare.load_limits(tmp_path, "x", ("nbhd_ulps",)) == \
        {"nbhd_ulps": 1}
    with pytest.raises(ValueError):
        compare.load_limits(tmp_path, "x", ("nbhd_ulps", "score_rel"))


def _client(seed, analyses):
    from types import SimpleNamespace

    sf = SimpleNamespace(load_attributes=lambda attribute_file: None,
                         run_pipeline=lambda: None, out=None)
    kind = SimpleNamespace(run_kwargs=lambda inputs: {},
                           keep=lambda s: s.out)
    client = harness.Client(sf, SimpleNamespace(pool=list(range(5))), kind,
                            CPU, count_launches=False, seed=seed)
    for i in range(analyses):
        sf.out = i
        client.analysis(i)
    return client


def test_sample_is_drawn_from_the_seed_and_keeps_the_last():
    """SAMPLE analyses drawn uniformly among those completed, and the last;
    the window holds no more outputs than that."""
    s = [out for _, out in _client(5, 40).sample()]
    assert len(s) == harness.SAMPLE + 1 and s[-1] == 39 and s == sorted(s)
    assert s == [out for _, out in _client(5, 40).sample()]
    assert len(_client(5, 40).kept) == harness.SAMPLE
    assert [out for _, out in _client(5, 3).sample()] == [0, 1, 2]
    hits = np.zeros(30)
    for seed in range(600):
        for _, _, out in _client(seed, 30).kept:
            hits[out] += 1
    expect = 600 * harness.SAMPLE / 30
    assert np.all(np.abs(hits - expect) < 0.25 * expect), hits
