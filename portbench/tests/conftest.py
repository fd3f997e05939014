"""CPU tests of the benchmark (``python -m pytest portbench/tests``).

Tests that need the card carry the ``cuda`` marker and skip without one,
decided inside the ``cuda_device`` fixture. Imports neither ``jax`` nor the
JAX package.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the benchmark on the card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def root():
    return ROOT


# the cell that waits under PERF.md's Open questions: its configuration,
# mix and limits are files here, its entry not yet in BENCHMARK.json
WAITING = {
    "config": {"name": "costanzo2016",
               "file": "portbench/configs/costanzo2016.json"},
    "workload": {"name": "costanzo2016.quant10k", "config": "costanzo2016",
                 "traffic": "quant10k", "chips": 1},
}


@pytest.fixture(scope="session")
def bench():
    """``BENCHMARK.json`` with the waiting cell's entries added."""
    import json

    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append(dict(WAITING["config"]))
    b["workloads"].append(dict(WAITING["workload"]))
    return b
