"""Importing the port pulls in no jax, triton, networkx or pandas and builds
nothing; a CUDA session never falls back to the CPU; the kernel loader raises
instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_is_light_and_builds_nothing():
    build = os.path.join(REPO, "build")
    before = sorted(os.listdir(build)) if os.path.isdir(build) else None
    code = ("import sys, safepy_tpu_torch, safepy_tpu_torch.safe, "
            "safepy_tpu_torch.state, safepy_tpu_torch.pipeline, "
            "safepy_tpu_torch.domains, safepy_tpu_torch.debug, "
            "safepy_tpu_torch.ops.domains_device, "
            "safepy_tpu_torch.ops.apsp_bandstore, "
            "safepy_tpu_torch.ops.enrich_band, safepy_tpu_torch.ops.fdr, "
            "safepy_tpu_torch.ops.hypergeom, "
            "safepy_tpu_torch.ops.hypergeom_table, "
            "safepy_tpu_torch.parallel, "
            "safepy_tpu_torch.parallel.band_sharded\n"
            "from safepy_tpu_torch import ops\n"
            "assert callable(ops.apsp) and callable(ops.min_plus_product)\n"
            "assert callable(ops.hypergeom_sf)\n"
            "assert callable(ops.hypergeom_neglog10_sf)\n"
            "from safepy_tpu_torch.parallel import make_mesh\n"
            "assert callable(make_mesh)\n"
            "bad = [m for m in ('jax', 'triton', 'networkx', 'pandas', "
            "'safepy_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    after = sorted(os.listdir(build)) if os.path.isdir(build) else None
    assert after == before


def test_cuda_session_never_falls_back_to_cpu():
    from safepy_tpu_torch import SAFE

    if torch.cuda.is_available():
        assert SAFE(device="cuda", verbose=False).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            SAFE(verbose=False)  # device="cuda" is the default


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from safepy_tpu_torch import native

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a system nvcc exists; the missing-toolchain path "
                    "cannot be reached")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build()
    assert not (tmp_path / "build").exists()
    assert shutil.which("nvcc") is None


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Every import statement of the port's modules and of chip_smoke.py
    names neither jax nor safepy_tpu (the port keeps its own copies of the
    host helpers it needs)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "safepy_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "safepy_tpu")]
    assert not bad, bad
