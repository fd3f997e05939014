"""The attribute matrix's upload (``enrich_band.upload_f32_counted``) on the
card against numpy's f32 cast uploaded whole. Every test needs an NVIDIA GPU
and skips without one; like tests/test_torch_cuda.py this file imports no
jax:

    python -m pytest tests/test_torch_cuda_attr_prep.py -q --noconftest

The card casts each f64 block into its rows of the f32 matrix, so the
comparison is bitwise (NaN payloads included): at the GO-BP cell's shape
(20,480 genes x 4,373 terms), within the full-device prep's modeled peak,
and on planted values (rounding to 1, overflow to inf, subnormals) in five
layouts.
"""

import numpy as np
import pytest
import torch

from safepy_tpu_torch import hbm
from safepy_tpu_torch.ops import enrich_band as peb

pytestmark = pytest.mark.cuda

PLANTED = np.array([0.0, 1.0, -0.0, np.nan, 0.5, 1 + 1e-9, 1 - 1e-9, 1e39,
                    -1e39, np.finfo(np.float64).max, np.inf, -np.inf, 1e-40,
                    1e-45, 3e-45, 1e-46, -1e-40, 0.1])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32)


def _host_upload(m, dev):
    with np.errstate(over="ignore"):
        want = np.asarray(m, np.float32)
    count = int(np.count_nonzero(np.isfinite(want) & (want != 0)
                                 & (want != 1)))
    return torch.as_tensor(want, device=dev), count


def test_gobp_shape_is_the_host_cast_within_the_prep_peak(dev):
    """A GO-BP matrix of the cell's shape (0.4% ones, 10% NaN rows) with a
    few planted values: the upload equals the host cast's, and its peak
    over what was allocated before stays within ``hbm.prep_peak``."""
    n, a = 20480, 4373
    rng = np.random.default_rng(7)
    m = (rng.random((n, a)) < 0.004).astype(np.float64)
    m[rng.random(n) < 0.1] = np.nan
    m[rng.integers(0, n, 64), rng.integers(0, a, 64)] = rng.choice(
        PLANTED, 64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, count = peb.upload_f32_counted(m, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= hbm.prep_peak(n, a, chunked=False), peak
    want, want_count = _host_upload(m, dev)
    assert torch.equal(_bits(got), _bits(want))
    assert count == want_count


@pytest.mark.parametrize("layout", ["C", "fortran", "strided", "one-column",
                                    "reversed"])
def test_planted_values_are_the_host_cast(dev, layout):
    m = np.random.default_rng(0).choice(PLANTED, (3001, 37))
    m = {"C": m, "fortran": np.asfortranarray(m), "strided": m[:, ::2],
         "one-column": m[:, :1], "reversed": m[::-1, ::-1]}[layout]
    got, count = peb.upload_f32_counted(m, device=dev)
    want, want_count = _host_upload(m, dev)
    assert torch.equal(_bits(got), _bits(want))
    assert count == want_count
