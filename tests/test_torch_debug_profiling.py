"""The port's debug and profiling helpers: validate_network_arrays against
JAX's (the cases of tests/test_debug.py:23, parametrised the same way),
the checkify counterpart, StageTimer, log_compile_time and a CPU trace."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from safepy_tpu.debug import ValidationError as JaxValidationError
from safepy_tpu.debug import validate_network_arrays as jax_validate
from safepy_tpu_torch.debug import (ValidationError, checkify_pipeline,
                                    validate_attributes,
                                    validate_network_arrays)
from safepy_tpu_torch.profiling import StageTimer, log_compile_time, trace


def _d():
    return np.array([[0, 1, np.inf], [1, 0, 2], [np.inf, 2, 0.0]])


def test_validate_network_ok():
    validate_network_arrays(_d())
    validate_network_arrays(torch.as_tensor(_d()))


@pytest.mark.parametrize("mutate,msg", [
    (lambda d: d.__setitem__((0, 0), 1.0), "diagonal"),
    (lambda d: d.__setitem__((0, 1), -1.0), "negative"),
    (lambda d: d.__setitem__((0, 1), np.nan), "NaN"),
    (lambda d: d.__setitem__((0, 1), 5.0), "symmetric"),
    (lambda d: None, "square"),
])
def test_validate_network_failures_match_jax(mutate, msg):
    d = _d() if msg != "square" else np.zeros((2, 3))
    mutate(d)
    with pytest.raises(JaxValidationError) as want:
        jax_validate(d)
    with pytest.raises(ValidationError, match=msg) as got:
        validate_network_arrays(d)
    assert str(got.value) == str(want.value)


def test_sampled_symmetry_check_matches_jax():
    """The same default_rng(0) sample of entries: an asymmetry the sample
    misses passes in both, one it hits fails in both."""
    n = 3000
    d = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(0)
    ii = rng.integers(0, n, 4096)
    jj = rng.integers(0, n, 4096)
    hit = d.copy()
    hit[ii[0], jj[0]] = 1.0
    miss = d.copy()
    sampled = set(zip(ii.tolist(), jj.tolist())) | set(zip(jj.tolist(),
                                                           ii.tolist()))
    i, j = next((i, j) for i in range(1, n) for j in range(i + 1, n)
                if (i, j) not in sampled)
    miss[i, j] = 1.0
    validate_network_arrays(miss)
    jax_validate(miss)
    with pytest.raises(ValidationError, match="symmetric"):
        validate_network_arrays(hit)
    with pytest.raises(JaxValidationError, match="symmetric"):
        jax_validate(hit)


def test_validate_attributes():
    validate_attributes(np.ones((5, 2)), 5)
    with pytest.raises(ValidationError, match="rows"):
        validate_attributes(np.ones((4, 2)), 5)
    with pytest.raises(ValidationError, match="inf"):
        validate_attributes(np.array([[np.inf]]), 1)


def test_checkify_catches_nan():
    run = checkify_pipeline(torch.log)
    out = run(torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), np.log([1.0, 2.0]), rtol=1e-6)
    with pytest.raises(ValidationError, match="NaN"):
        run(torch.tensor([-1.0]))


def test_checkify_walks_nested_outputs():
    def f(x):
        return {"ok": (x, torch.arange(3)), "bad": [x.sqrt(), x.numpy()]}

    run = checkify_pipeline(f)
    run(torch.tensor([4.0]))  # integer tensors are not checked
    with pytest.raises(ValidationError, match="NaN"):
        run(torch.tensor([-4.0]))
    with pytest.raises(ValidationError, match="array holds NaN"):
        checkify_pipeline(lambda: (np.array([np.nan]),))()


def test_checkify_sees_outputs_only():
    """A NaN made and dropped inside the function passes (JAX's checkify
    would catch it); the docstring says so."""
    def f(x):
        _ = torch.log(-x)
        return x

    assert checkify_pipeline(f)(torch.tensor([1.0])).item() == 1.0


def test_stage_timer():
    t = StageTimer()
    with t.stage("a", sync=torch.zeros(2)):
        sum(range(1000))
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    assert list(t.stages) == ["a", "b"]
    report = t.report()
    assert "a:" in report and "total" in report


def test_log_compile_time():
    calls = []

    def double(x):
        calls.append(1)
        return x * 2

    out = log_compile_time(double, torch.arange(4.0), label="double")
    np.testing.assert_array_equal(out.numpy(), [0, 2, 4, 6])
    assert len(calls) == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path / "tr")) as prof:
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert files == [prof.trace_path] and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    with trace(str(tmp_path / "tr")):
        pass
    assert len(glob.glob(str(tmp_path / "tr" / "*.json"))) == 2
