"""The class table's two routes, on the CPU.

A CPU ``K_dist`` runs the torch slot loop and launches nothing (its table
is held to the JAX package's in tests/test_torch_hypergeom.py). The kernel
(``csrc/hypergeom_table.cu``) is among the library's sources and C
signatures; a call routed to it (``htab.route`` and ``native.launch``
replaced, so no card is needed) hands the C entry its arguments in order,
counts one launch in ``htab.LAUNCHES`` and never runs the loop. The kernel
itself is held to the loop on the card (tests/test_torch_cuda_go_table.py).
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from safepy_tpu_torch import native
from safepy_tpu_torch.ops import hypergeom_table as htab


@pytest.fixture(autouse=True)
def _fresh_counts():
    htab.reset_launches()
    yield
    htab.reset_launches()


def test_cpu_table_runs_the_loop_and_launches_nothing():
    K_dist = torch.as_tensor(np.array([0.0, 3.0, 40.0, 99.0]))
    kw = dict(R=256, S_max=128, C=4)
    got = htab.build_logsf_table(K_dist, 100, float(np.log(0.05)), **kw)
    assert torch.equal(got, htab._build_logsf_table_torch(
        K_dist, 100, float(np.log(0.05)), **kw))
    assert htab.LAUNCHES == {"logsf_table": 0}


@pytest.mark.parametrize("device,want", [
    ("cpu", "torch"), ("cuda", "cuda"), (torch.device("cuda", 1), "cuda"),
    ("meta", "torch")])
def test_route_follows_the_device_alone(device, want):
    assert htab.route(device) == want


def test_native_builds_and_binds_the_table_kernel():
    assert "hypergeom_table.cu" in native.SOURCES
    assert (native.CSRC / "hypergeom_table.cu").is_file()
    assert native._SIGNATURES["safepy_logsf_table"] == (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p)


@pytest.fixture
def to_kernel(monkeypatch):
    """Route every table to the kernel, with ``native.launch`` recording its
    calls, a fake current stream, and the loop made to fail if entered."""
    calls = []
    monkeypatch.setattr(htab, "route", lambda device: "cuda")
    monkeypatch.setattr(native, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=4242))

    def no_loop(*a, **k):
        raise AssertionError("the slot loop ran on the kernel's route")
    monkeypatch.setattr(htab, "_build_logsf_table_torch", no_loop)
    return calls


@pytest.mark.parametrize("R,S_max,C,M,alpha", [
    (256, 256, 256, 18440, 0.05), (128, 64, 1, 500, 0.05),
    (4096, 128, 64, 3971, 1e-3)])
def test_kernel_route_hands_the_c_entry_its_arguments(to_kernel, R, S_max,
                                                      C, M, alpha):
    K_dist = torch.arange(C, dtype=torch.float32)
    log_thr = float(np.log(alpha))
    table = htab.build_logsf_table(K_dist, np.int64(M), log_thr, R=R,
                                   S_max=S_max, C=C)
    assert table.shape == (S_max, C, R) and table.dtype == torch.float32
    assert htab.LAUNCHES == {"logsf_table": 1}
    [(name, args)] = to_kernel
    assert name == "logsf_table"
    argtypes = native._SIGNATURES["safepy_" + name]
    assert len(args) == len(argtypes)
    for t, a in zip(argtypes, args):
        t.from_param(a)  # each argument converts to its C type
    table_p, k_p, r, s, c, m, thr, thr32, thr_lo32, stream = args
    assert table_p.value == table.data_ptr()
    assert (r, s, c) == (R, S_max, C)
    assert type(m) is float and m == M
    assert thr == log_thr
    assert thr32 == float(np.float32(log_thr))
    assert thr_lo32 == float(np.nextafter(np.float32(log_thr),
                                          np.float32(-np.inf)))
    assert thr_lo32 < thr32 and stream.value == 4242


@pytest.mark.parametrize("K_len,R,S_max,C", [
    (4, 128, 64, 8), (8, 0, 64, 8), (8, 128, 0, 8), (1 << 16, 1 << 15, 64,
                                                     1 << 16)],
    ids=["classes-not-C", "no-rows", "no-slots", "grid-too-large"])
def test_kernel_route_refuses_what_the_kernel_cannot_take(to_kernel, K_len,
                                                          R, S_max, C):
    with pytest.raises(ValueError):
        htab.build_logsf_table(torch.zeros(K_len), 100, -3.0, R=R,
                               S_max=S_max, C=C)
    assert to_kernel == [] and htab.LAUNCHES == {"logsf_table": 0}
