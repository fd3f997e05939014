"""The (n, A) results' downloads (``transfer.download_f64``: row blocks
through pinned staging buffers, widened to f64 by host threads) on the
card against ``.cpu().numpy().astype(np.float64)``. Every test needs an
NVIDIA GPU and skips without one; like tests/test_torch_cuda.py this file
imports no jax:

    python -m pytest tests/test_torch_cuda_result_download.py -q --noconftest

The comparisons are bitwise (as int64 bits): at the GO-BP cell's shape
(20,480 genes x 4,373 terms) in f32 and int8, with no device allocation
over the download; at ragged shapes with blocks of a few rows; on a
result that a kernel is still writing when the download starts; and
through ``SAFE.nes`` and ``SAFE.nes_binary`` of a band GO session on the
card.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu_torch import SAFE, transfer
from safepy_tpu_torch.io.graph_arrays import edge_lengths

pytestmark = pytest.mark.cuda

# f32 bit patterns: NaNs with payloads and both signs, infinities, signed
# zeros, subnormals, 1 +/- 1 ulp
F32_BITS = np.array([0x7FC00000, 0x7FC00001, 0xFFC12345, 0x7FFFFFFF,
                     0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                     0x00000001, 0x007FFFFF, 0x80000001, 0x3F800001,
                     0x3F7FFFFF, 0x3F800000, 0x40490FDB], np.uint32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _old(x):
    with np.errstate(invalid="ignore"):
        return x.cpu().numpy().astype(np.float64)


def _same_bits(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    assert got.flags.c_contiguous and got.flags.owndata
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def _planted(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        m = (rng.random(shape) < 0.05).astype(np.int8)
    else:
        m = rng.random(shape, dtype=np.float32) * 30
        k = max(1, m.size // 1000)
        m.flat[rng.integers(0, m.size, k)] = rng.choice(F32_BITS, k).view(
            np.float32)
    return torch.from_numpy(m).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_gobp_shape_is_the_host_cast_with_no_device_allocation(dev, dtype):
    n, a = 20480, 4373
    x = _planted((n, a), dtype, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = transfer.download_f64(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == base
    _same_bits(got, _old(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("shape,rows", [((1001, 37), 3), ((10, 7), 3),
                                        ((1, 7), 3), ((7, 1), 2),
                                        ((6, 5), 3), ((2, 3), 1)])
def test_ragged_shapes_in_small_blocks(dev, monkeypatch, dtype, shape,
                                       rows):
    """Blocks of a few rows, so that both staging buffers turn over many
    times and the last block is short."""
    monkeypatch.setattr(transfer, "_BLOCK_ELEMS", rows * shape[1])
    assert transfer._block_rows(shape[1]) == rows
    x = _planted(shape, dtype, dev, seed=sum(shape))
    _same_bits(transfer.download_f64(x), _old(x))


def test_reads_what_a_running_kernel_writes(dev):
    """The result is written after a kernel that spins for ~0.2 s on the
    current stream: the download waits for each block's copy, so it reads
    the written values, not what the buffers held before."""
    n, a = 20480, 4373
    src = _planted((n, a), torch.float32, dev, seed=3)
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))
    x.copy_(src)
    got = transfer.download_f64(x)
    _same_bits(got, _old(src))


def _network(n=600, k=7, seed=3):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def test_session_properties_are_the_whole_cast(dev, monkeypatch):
    """A band GO session on the card, with blocks of 7 rows: ``sf.nes`` and
    ``sf.nes_binary`` are the old route's arrays of the device results."""
    terms = 40
    monkeypatch.setattr(transfer, "_BLOCK_ELEMS", 7 * terms)
    net = _network()
    rng = np.random.default_rng(4)
    go = (rng.random((len(net[0]), terms)) < 0.08).astype(float)
    go[rng.random(len(net[0])) < 0.1] = np.nan
    sf = SAFE(device=dev, verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=go)
    sf.run_pipeline()
    assert sf._nes_device().is_cuda and sf._nes_binary_dev.is_cuda
    want_nes = _old(sf._nes_device())
    want_bin = sf._nes_binary_dev.cpu().numpy().astype(float)
    _same_bits(sf.nes, want_nes)
    _same_bits(sf.nes_binary, want_bin)
