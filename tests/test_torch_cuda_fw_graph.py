"""The band-storage FW's rounds replayed as one CUDA graph, against the
eager round loop on the card. Every test needs an NVIDIA GPU and nvcc and
skips without one; like tests/test_torch_cuda.py this file imports no jax:

    python -m pytest tests/test_torch_cuda_fw_graph.py -q --noconftest

A band is run eagerly the first time it is met at its address, captured the
second time and replayed after (``ops.apsp_bandstore._band_fw_run``); each
call must leave the band bitwise what the eager loop leaves and count the
same kernel launches.
"""

import pytest
import torch

from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.ops import apsp_cuda as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bs._fw_graphs.clear()
    yield torch.device("cuda")
    bs._fw_graphs.clear()


def _band(dev, n, bt, block, seed):
    """A band of a random graph whose edges lie within the band: (nb + 2 bt)
    block rows from band_init_from_edges, on ``dev``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    band = (bt - 1) * block
    u = torch.randint(0, n, (6 * n,), generator=gen)
    v = (u + torch.randint(1, band + 1, (6 * n,), generator=gen)).clamp_max(
        n - 1)
    w = torch.rand(6 * n, generator=gen) + 0.05
    return bs.band_init_from_edges(u.to(dev), v.to(dev), w.to(dev), n=n,
                                   band=band, block=block)


def _eager(s0, bt, block, symmetric):
    """The rounds on a copy of ``s0``, on the host, a fresh workspace each."""
    want = s0.clone()
    nb = s0.shape[0] // block - 2 * bt
    for kb in range(nb):
        bs.band_fw_round(want, kb, bt=bt, block=block, symmetric=symmetric)
    torch.cuda.synchronize()
    return want, nb


def _calls(s, s0, bt, block, symmetric, times):
    """``times`` calls of apsp_band_fw on ``s``, refilled from ``s0`` before
    each: [(the band after, the FW_GRAPHS key the call counted in, its
    launches)]."""
    out = []
    for _ in range(times):
        s.copy_(s0)
        before = dict(bs.FW_GRAPHS)
        K.reset_launches()
        bs.apsp_band_fw(s, bt=bt, block=block, symmetric=symmetric)
        torch.cuda.synchronize()
        moved = [k for k in bs.FW_GRAPHS if bs.FW_GRAPHS[k] != before[k]]
        assert len(moved) == 1 and bs.FW_GRAPHS[moved[0]] == before[moved[0]] + 1
        out.append((s.clone(), moved[0], dict(K.LAUNCHES)))
    return out


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("block,bt,n", [(128, 8, 4096), (128, 2, 1280),
                                        (64, 3, 1024)],
                         ids=["whole-tiles-bt8", "sub-tiles-bt2",
                              "block64-bt3"])
def test_replay_is_bitwise_the_eager_loop(dev, symmetric, block, bt, n):
    """Eager, capture, then replays: each call's band is the eager loop's,
    bit for bit, and each launches 3 nb kernels, nb of each (bt 8 takes the
    skew kernels' whole-tile form at block 128, bt 2 their sub-tiles)."""
    s0 = _band(dev, n, bt, block, seed=bt + 10 * symmetric)
    want, nb = _eager(s0, bt, block, symmetric)
    assert not torch.equal(want, s0)
    s = torch.empty_like(s0)
    skew = "relax_skew_sym" if symmetric else "relax_skew"
    calls = _calls(s, s0, bt, block, symmetric, 4)
    assert [mode for _, mode, _ in calls] == ["eager", "captures", "replays",
                                              "replays"]
    for got, _, launches in calls:
        assert torch.equal(got, want)
        assert launches["close_diag"] == launches["relax_panel"] == nb
        assert launches[skew] == nb and sum(launches.values()) == 3 * nb


def test_new_address_or_shape_is_captured_anew(dev):
    """A band at another address, or of another shape, is a new key: run
    eagerly, then captured, still the eager loop's; the cache keeps the
    newest two keys, so the first band, evicted, starts over eagerly."""
    block, bt = 128, 2
    s0 = _band(dev, 1280, bt, block, seed=1)
    want, _ = _eager(s0, bt, block, True)
    first = torch.empty_like(s0)
    assert [m for _, m, _ in _calls(first, s0, bt, block, True, 3)] == [
        "eager", "captures", "replays"]
    other = torch.empty_like(s0)  # first is alive: another address
    calls = _calls(other, s0, bt, block, True, 3)
    assert [m for _, m, _ in calls] == ["eager", "captures", "replays"]
    assert all(torch.equal(got, want) for got, _, _ in calls)
    t0 = _band(dev, 1664, bt, block, seed=2)
    want_t, _ = _eager(t0, bt, block, True)
    third = torch.empty_like(t0)
    calls = _calls(third, t0, bt, block, True, 3)
    assert [m for _, m, _ in calls] == ["eager", "captures", "replays"]
    assert all(torch.equal(got, want_t) for got, _, _ in calls)
    assert len(bs._fw_graphs) == bs.FW_GRAPH_CACHE
    calls = _calls(first, s0, bt, block, True, 2)
    assert [m for _, m, _ in calls] == ["eager", "captures"]
    assert all(torch.equal(got, want) for got, _, _ in calls)
