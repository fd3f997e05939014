"""The class table's kernel (``csrc/hypergeom_table.cu``) against the torch
slot loop run on the same card. Every test needs an NVIDIA GPU and nvcc and
skips without one; like tests/test_torch_cuda.py this file imports no jax:

    python -m pytest tests/test_torch_cuda_go_table.py -q --noconftest

The kernel rounds every operation of the loop once, in the loop's order, so
the comparison is ``torch.equal``: at the band GO cell's geometry, where
rows run past the population (n > M, n + K > M), with classes K = 0 and
K = M, at the smallest geometry, where the support outgrows the slots,
where T is renormalized, and at a dense-route geometry.
"""

import numpy as np
import pytest
import torch

from safepy_tpu_torch import SAFE, profiling
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.ops import hypergeom_table as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cell_classes(c=256, distinct=212, seed=5):
    """A chunk's classes at the band GO cell's scale: ``distinct`` term
    sizes among 3-300, sorted, padded with zeros to ``c``."""
    rng = np.random.default_rng(seed)
    out = np.zeros(c)
    out[:distinct] = np.sort(rng.choice(np.arange(3, 301), distinct,
                                        replace=False))
    return out


# (M, K_dist, R, S_max, log threshold)
GEOMETRIES = {
    # the cell: M 18,440 annotated genes, R 256 x S_max 256 x C 256
    "cell": (18440, _cell_classes(), 256, 256, np.log(0.05)),
    # rows past the population: lo > hi and den <= 0 at n > M, n + K > M;
    # the classes K = 0 and K = M
    "small-M": (100, np.r_[0.0, 1.0, 2.0, 5.0, 37.0, 50.0, 99.0, 100.0],
                256, 128, np.log(0.05)),
    # the smallest geometry the planner makes
    "smallest": (500, np.array([7.0]), 128, 64, np.log(0.05)),
    # classes beyond the slots (hi >= S_max on rows past n_max), a
    # stricter threshold
    "support-beyond-slots": (5000, np.r_[3.0, 40.0, 150.0, 200.0], 256, 64,
                             np.log(1e-3)),
    # T past 1e250 on the rows near n = 500: the renormalization steps
    "renorm": (1000, np.r_[500.0, 499.0], 1024, 512, np.log(0.05)),
    # the dense fused route at Example_1's population (R 4,096)
    "dense": (3971, np.r_[np.arange(3, 120, 2), [0.0] * 5], 4096, 128,
              np.log(0.05)),
}


def _tables(dev, name):
    M, K, R, S_max, log_thr = GEOMETRIES[name]
    K_dist = torch.as_tensor(np.asarray(K, np.float64), device=dev)
    kw = dict(R=R, S_max=S_max, C=len(K))
    got = T.build_logsf_table(K_dist, M, float(log_thr), **kw)
    want = T._build_logsf_table_torch(K_dist, M, float(log_thr), **kw)
    torch.cuda.synchronize()
    return got, want


def _diff_note(got, want):
    bad = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
    first = [(i, got[tuple(i)].item(), want[tuple(i)].item())
             for i in bad.nonzero()[:5].tolist()]
    return f"{int(bad.sum())} cells differ, first (s, c, n): {first}"


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_table_is_the_torch_loop_bitwise(dev, name):
    got, want = _tables(dev, name)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), _diff_note(got, want)


@pytest.mark.parametrize("name", ["cell", "small-M", "dense"])
def test_lookup_on_the_kernel_table_equals_the_loops(dev, name):
    """``table_lookup`` on the two tables: identical NES, log sf and
    indicator over counts that cover the support and beyond it."""
    M, K, R, S_max, log_thr = GEOMETRIES[name]
    got, want = _tables(dev, name)
    rng = np.random.default_rng(11)
    C = len(K)
    nsize = torch.as_tensor(rng.integers(0, R, 700).astype(np.float32),
                            device=dev)
    colc = torch.as_tensor(rng.integers(0, C, 300), device=dev)
    counts = torch.as_tensor(rng.integers(0, S_max + 3, (700, 300))
                             .astype(np.float32), device=dev)
    thr32 = float(np.float32(log_thr))
    kw = dict(S_max=S_max, R=R, C=C)
    for a, b in zip(T.table_lookup(got, counts, nsize, colc, thr32, **kw),
                    T.table_lookup(want, counts, nsize, colc, thr32, **kw)):
        assert torch.equal(a, b)


def test_kernel_counts_its_launches_and_takes_the_current_stream(dev):
    T.reset_launches()
    K_dist = torch.as_tensor(np.array([3.0, 9.0]), device=dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        got = T.build_logsf_table(K_dist, 1000, float(np.log(0.05)), R=128,
                                  S_max=64, C=2)
    side.synchronize()
    want = T._build_logsf_table_torch(K_dist, 1000, float(np.log(0.05)),
                                      R=128, S_max=64, C=2)
    assert torch.equal(got, want)
    assert T.LAUNCHES == {"logsf_table": 1}
    with pytest.raises(ValueError):
        T.build_logsf_table(K_dist, 1000, -3.0, R=128, S_max=64, C=4)


def _network(n, k=8, seed=3):
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


def test_band_go_analysis_builds_its_nine_tables_by_the_kernel(dev,
                                                                tmp_path):
    """One band GO analysis of 4,373 terms (the cell's 9 chunks of 512
    columns): 9 kernel launches, and 9 ``enrichment.go_table`` spans
    whose ``route`` reads ``cuda``."""
    net = _network(900)
    rng = np.random.default_rng(6)
    n, terms = len(net[0]), 4373
    sizes = np.round(np.exp(rng.uniform(np.log(3), np.log(300), terms)))
    vals = np.zeros((n, terms))
    for j, size in enumerate(sizes.astype(int)):
        vals[rng.choice(n, size, replace=False), j] = 1.0
    vals[rng.random(n) < 0.1] = np.nan
    sf = SAFE(device=dev, verbose=False)
    sf.apsp_mode = "band"
    sf.load_network(network_file=net)
    sf.load_attributes(attribute_file=vals)
    T.reset_launches()
    profiling.reset_spans()
    try:
        with profiling.trace(str(tmp_path / "tr")):
            sf.run_pipeline()
        routes = [r["attrs"]["route"] for r in profiling.span_records()
                  if r["name"] == "enrichment.go_table"]
    finally:
        profiling.reset_spans()
    assert sf._hypergeom_engine_used == "table-band"
    assert T.LAUNCHES == {"logsf_table": 9}
    assert routes == ["cuda"] * 9
