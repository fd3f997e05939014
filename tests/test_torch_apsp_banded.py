"""The port's banded-window FW and neighborhood ops against the JAX package.

The host certificate must equal the JAX one; the banded FW must be bitwise
equal to ``apsp_banded_fw(use_pallas=False, symmetric=True)`` (same rounds,
same f32 roundings); the radius indicator must equal scipy Dijkstra's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path
from scipy.spatial import cKDTree

from safepy_tpu.ops import apsp_banded as jab
from safepy_tpu.ops import neighborhoods as jnb
from safepy_tpu.ops.apsp import pad_distances as jax_pad
from safepy_tpu_torch.ops import apsp_banded as tab
from safepy_tpu_torch.ops import neighborhoods as tnb
from safepy_tpu_torch.ops.apsp import pad_distances


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geometric_graph(n, k, seed):
    """tests/test_apsp_banded.py:15: kNN graph, Euclidean edge lengths."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    w = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                 coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
    return coords, edges, w


def _oracle(n, edges, w):
    a = coo_matrix((w, tuple(edges.T)), shape=(n, n))
    return shortest_path(a.maximum(a.T), method="D", directed=False)


@pytest.mark.parametrize("seed,n,radius,exact_below", [
    (0, 600, None, 50_000), (3, 600, None, 50_000), (1, 400, 0.3, 50_000),
    (2, 500, 0.2, 100)])  # the last one takes the window_halfwidth route
def test_host_certificate_matches_jax(seed, n, radius, exact_below):
    coords, _, _ = _geometric_graph(n, 6, seed)
    nr = radius or 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    j_order, j_band = jab.banded_order(coords, nr, exact_below=exact_below)
    t_order, t_band = tab.banded_order(coords, nr, exact_below=exact_below)
    np.testing.assert_array_equal(t_order, j_order)
    assert t_band == j_band
    np.testing.assert_array_equal(tab.hilbert_order(coords),
                                  jab.hilbert_order(coords))
    for block in (64, 128):
        assert (tab.window_width(n, t_band, block)
                == jab.window_width(n, j_band, block))
    assert (tab.window_halfwidth(coords[:, 1], nr)
            == jab.window_halfwidth(coords[:, 1], nr))


@pytest.mark.parametrize("seed", [0, 3])
def test_banded_fw_bitwise_equals_jax(seed):
    """n = 600, block 64: the graph of tests/test_apsp_banded.py:34."""
    n, block = 600, 64
    coords, edges, w = _geometric_graph(n, 7, seed)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = jab.banded_order(coords, nr)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    d0 = tnb.dense_initial_distances(n, inv[edges], w)
    window = jab.window_width(n, band, block)
    assert window < n  # the band really restricts the rounds
    want = np.asarray(jab.apsp_banded_fw(
        jax_pad(jnp.asarray(d0), block), window=window, block=block,
        use_pallas=False, symmetric=True))
    d = pad_distances(torch.as_tensor(d0), block)
    got = tab.apsp_banded_fw(d, window=window, block=block)
    assert got is d  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_banded_unpermuted_matches_dijkstra_and_jax():
    n, block = 500, 128
    coords, edges, w = _geometric_graph(n, 6, 2)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = tab.banded_order(coords, nr * (1 + 1e-5))
    window = tab.window_width(n, band, block)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    p = rank[edges]
    r = tnb.inclusive_radius(nr)
    got = tab.apsp_banded_unpermuted(
        (torch.as_tensor(p[:, 0]), torch.as_tensor(p[:, 1]),
         torch.as_tensor(w.astype(np.float32))),
        torch.as_tensor(rank), r, window=window, block=block).numpy()

    ref = _oracle(n, edges, w)
    # the thresholded indicator is exact everywhere
    np.testing.assert_array_equal(got <= r, ref <= r)
    # inside the radius the distances are the true ones to f32 rounding
    inside = ref <= float(r)
    np.testing.assert_allclose(got[inside], ref[inside], rtol=1e-6)
    assert np.isinf(got[~inside]).all()

    want = np.asarray(jab.apsp_banded_unpermuted(
        (jnp.asarray(p[:, 0], jnp.int32), jnp.asarray(p[:, 1], jnp.int32),
         jnp.asarray(w, jnp.float32)), jnp.asarray(rank, jnp.int32), r,
        window=window, block=block))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strict", [False, True])
def test_threshold_and_stats_matches_jax(strict):
    rng = np.random.default_rng(4)
    dist = rng.uniform(0, 1, (300, 300)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.2] = np.inf
    r = np.float32(0.3)
    j_nbr, j_mean, j_std = jnb.threshold_and_stats(jnp.asarray(dist), r,
                                                   strict=strict)
    t_nbr, t_mean, t_std = tnb.threshold_and_stats(torch.as_tensor(dist), r,
                                                   strict=strict)
    np.testing.assert_array_equal(t_nbr.numpy(), np.asarray(j_nbr))
    # integer sizes: the f32 sum is exact, so the mean is one rounding
    assert float(t_mean) == float(j_mean)
    # the std reduces in another order (ddof=0 on both sides): f32 rounding
    np.testing.assert_allclose(float(t_std), float(j_std), rtol=1e-6)


def test_initial_distances_match_jax():
    # parallel edges keep the minimum, self-loops never beat the 0 diagonal
    edges = np.array([[0, 1], [1, 0], [1, 2], [3, 3], [4, 0], [2, 1]])
    w = np.array([0.5, 0.25, 1.0, 2.0, 0.75, 3.0])
    want = np.asarray(jnb.initial_distances_device(6, edges, w))
    np.testing.assert_array_equal(
        tnb.initial_distances_device(6, edges, w, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tnb.dense_initial_distances(6, edges, w),
                                  jnb.dense_initial_distances(6, edges, w))
    np.testing.assert_array_equal(
        tnb.initial_distances_device(6, np.zeros((0, 2), int),
                                     device="cpu").numpy(),
        np.asarray(jnb.initial_distances_device(6, np.zeros((0, 2), int))))
    # built at a padded size directly == padding afterwards
    u, v = (torch.as_tensor(edges[:, i]) for i in (0, 1))
    padded = tnb._initial_distances(u, v, torch.as_tensor(w), num_nodes=6,
                                    size=8)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jax_pad(jnp.asarray(want), 8)))
    assert tnb.inclusive_radius(0.3) == jnb.inclusive_radius(0.3)
