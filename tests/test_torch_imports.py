"""Importing the port (the file-driven modules included: config, io,
output, cli) pulls in no jax, triton, networkx, pandas or matplotlib and
builds nothing; a CUDA session never falls back to the CPU; the kernel loader raises
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
            "safepy_tpu_torch.parallel.band_sharded, "
            "safepy_tpu_torch.dryrun, "
            "safepy_tpu_torch.config, safepy_tpu_torch.output, "
            "safepy_tpu_torch.cli, safepy_tpu_torch.io, "
            "safepy_tpu_torch.io.network, safepy_tpu_torch.io.layout, "
            "safepy_tpu_torch.io.attributes, safepy_tpu_torch.io.table, "
            "safepy_tpu_torch.io.record, safepy_tpu_torch.io.edgelist, "
            "safepy_tpu_torch.io.matlab\n"
            "from safepy_tpu_torch import ops\n"
            "assert callable(ops.apsp) and callable(ops.min_plus_product)\n"
            "assert callable(ops.hypergeom_sf)\n"
            "assert callable(ops.hypergeom_neglog10_sf)\n"
            "from safepy_tpu_torch.parallel import make_mesh\n"
            "assert callable(make_mesh)\n"
            "bad = [m for m in ('jax', 'triton', 'networkx', 'pandas', "
            "'matplotlib', 'safepy_tpu') if m in sys.modules]\n"
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


HOST_EXTRAS = ("safepy_tpu_torch", "safepy_tpu_torch.safe",
               "safepy_tpu_torch.checkpoint", "safepy_tpu_torch.profiling",
               "safepy_tpu_torch.debug", "safepy_tpu_torch.utils.make_go",
               "safepy_tpu_torch.colormaps", "safepy_tpu_torch.io.xlsx",
               "safepy_tpu_torch.plot_data")


def test_host_extras_import_no_jax_pandas_networkx_or_matplotlib():
    """The save, checkpoint, profiling, debug and make_go modules import on
    a machine without the plotting stack; the plotting names of ``safe``
    and MidpointRangeNormalize import matplotlib on first access only."""
    code = ("import sys, importlib\n"
            f"for m in {HOST_EXTRAS!r}:\n"
            "    importlib.import_module(m)\n"
            "import safepy_tpu_torch.safe as s\n"
            "assert callable(s.get_colors) and callable(s.run_safe_batch)\n"
            "bad = [m for m in ('jax', 'matplotlib', 'pandas', 'networkx', "
            "'safepy_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "s.plot_network, s.MidpointRangeNormalize\n"
            "assert 'matplotlib' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def _jax_safe_namespace():
    """The names JAX's safe module defines or re-exports after its SAFE
    class (safepy_tpu/safe.py:2314-2364), read from its source."""
    with open(os.path.join(REPO, "safepy_tpu", "safe.py")) as f:
        tree = ast.parse(f.read())
    start = next(n.lineno for n in tree.body
                 if isinstance(n, ast.FunctionDef)
                 and n.name == "run_safe_batch")
    names = []
    for node in tree.body:
        if node.lineno < start:
            continue
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.FunctionDef):
            names.append(node.name)
    return names


def test_safe_module_has_the_reference_namespace():
    import inspect

    import safepy_tpu_torch.safe as port_safe

    names = _jax_safe_namespace()
    assert len(names) >= 20 and "run_permutations" in names
    missing = [n for n in names if not hasattr(port_safe, n)]
    assert not missing, missing
    for name in ("run_safe_batch", "run_permutations"):
        assert list(inspect.signature(getattr(port_safe, name)).parameters) \
            == (["attribute_file"] if name == "run_safe_batch"
                else ["arg_tuple", "kwargs"])
    with pytest.raises(AttributeError):
        port_safe.no_such_name


def test_reference_run_permutations_on_cpu_tensors():
    """run_permutations(arg_tuple) computes where its neighborhoods are and
    returns JAX's f64 numpy counts; the counts are those of the ops null
    with the seed's generator."""
    import numpy as np

    import safepy_tpu_torch.safe as port_safe
    from safepy_tpu_torch.ops import permutation, score

    rng = np.random.default_rng(0)
    nbr = (rng.random((40, 40)) < 0.2).astype(np.float32)
    vals = rng.normal(size=(40, 2))
    vals[rng.random(40) < 0.3, 0] = np.nan
    cn, cp = port_safe.run_permutations(
        (torch.as_tensor(nbr), vals, "sum", 60, 7))
    assert cn.dtype == np.float64 and cn.shape == (40, 2)
    ok = np.isfinite(score.compute_neighborhood_score(
        torch.as_tensor(nbr), torch.as_tensor(vals)).numpy())
    assert ((cn + cp)[ok] >= 60).all()
    valid = np.flatnonzero(np.isfinite(vals).any(axis=1))
    t = torch.as_tensor(nbr)
    want = permutation.run_permutations(
        t, torch.as_tensor(vals), torch.as_tensor(valid),
        score.compute_neighborhood_score(t, torch.as_tensor(vals)),
        generator=torch.Generator().manual_seed(7), num_permutations=60)
    np.testing.assert_array_equal(cn, want[0].numpy())
    np.testing.assert_array_equal(cp, want[1].numpy())


def test_facade_null_calls_the_ops_run_permutations(monkeypatch):
    """The module's reference-signature run_permutations shadows nothing:
    the facade's null goes to ops.permutation.run_permutations."""
    import numpy as np

    import safepy_tpu_torch.safe as port_safe
    from safepy_tpu_torch import SAFE
    from safepy_tpu_torch.ops import permutation

    calls = []
    real = permutation.run_permutations

    def spy(*args, **kwargs):
        calls.append(kwargs["num_permutations"])
        return real(*args, **kwargs)

    monkeypatch.setattr(permutation, "run_permutations", spy)
    assert port_safe._perm is permutation
    assert port_safe.run_permutations is not real
    rng = np.random.default_rng(1)
    coords = rng.uniform(0, 1, (30, 2))
    edges = np.array([(i, i + 1) for i in range(29)])
    lengths = np.hypot(*(coords[edges[:, 0]] - coords[edges[:, 1]]).T)
    sf = SAFE(verbose=False, device="cpu")
    sf.random_seed = 2
    sf.load_network(network_file=(coords, edges, lengths, None))
    sf.load_attributes(attribute_file=rng.normal(size=30))
    sf.define_neighborhoods()
    sf.compute_pvalues(num_permutations=25)
    assert calls == [25]
