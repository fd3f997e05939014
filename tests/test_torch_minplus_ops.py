"""The port's op-level min-plus surface against the JAX package's.

``safepy_tpu_torch.ops`` (``apsp`` in all its methods, ``min_plus_product``,
the classic dense and banded Floyd-Warshall, ``euclidean_distance_matrix``,
``fdr_bh``) against ``safepy_tpu.ops`` on the same numpy inputs. The JAX
Pallas kernels run in interpret mode, as tests/test_apsp.py runs them; the
port's wrappers run their plain torch versions on CPU tensors. Min-plus
results are compared bitwise: each candidate a + b is one f32 rounding and
min is exact, so any tiling and k order gives the same bits. Against the
JAX textbook loop (``_apsp_jax``, what ``apsp`` runs by default off a TPU)
the sums associate differently: within 1e-6 relative, the ROADMAP's
distance contract, with the same +inf pattern.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from scipy.spatial import cKDTree

import __graft_entry__ as ge
from safepy_tpu import ops as jops
from safepy_tpu.ops import apsp_banded as jab
from safepy_tpu.ops import apsp_pallas as jp
from safepy_tpu.ops import permutation as jperm
from safepy_tpu.ops.apsp import pad_distances as jax_pad
from safepy_tpu_torch import ops
from safepy_tpu_torch.ops import apsp_banded as tab
from safepy_tpu_torch.ops import apsp_cuda as K
from safepy_tpu_torch.ops import permutation as tperm
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


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _inf_laced(rng, shape, inf_share=0.3):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    x[rng.random(shape) < inf_share] = np.inf
    return x


def _directed(n, p, seed):
    """Dense f32 matrix of random arcs i -> j, not mirrored."""
    rng = np.random.default_rng(seed)
    d = np.full((n, n), np.inf, np.float32)
    arcs = rng.random((n, n)) < p
    d[arcs] = rng.uniform(0.1, 2.0, int(arcs.sum())).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _directed_knn(n, k, seed):
    """Coordinates and the dense f32 matrix of the arcs i -> each of i's k
    nearest neighbours, of Euclidean length, not mirrored."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k + 1)
    u = np.repeat(np.arange(n), k)
    v = nn[:, 1:].ravel()
    d = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(d, 0.0)
    np.minimum.at(d, (u, v), np.hypot(*(coords[u] - coords[v]).T)
                  .astype(np.float32))
    return coords, d


@pytest.mark.parametrize("method", ["auto", "pallas", "jax"])
def test_min_plus_product_matches_pallas(method):
    """tests/test_apsp.py:59's ragged (100, 130) x (130, 70) product."""
    rng = np.random.default_rng(0)
    a = _inf_laced(rng, (100, 130))
    b = _inf_laced(rng, (130, 70))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.min_plus_pallas(a, b, block=64))
    np.testing.assert_array_equal(
        np.asarray(jops.min_plus_product(a, b, method="jax")), want)
    got = ops.min_plus_product(_t(a), _t(b), method=method, block=64)
    assert got.dtype == torch.float32 and got.shape == (100, 70)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(40, 16, 70), (130, 17, 20), (3, 1, 129)],
                         ids=["k-one-slab", "k-ragged", "k-one"])
def test_minplus_product_plain_matches_pallas_signs_and_inf_lines(m, k, n):
    """minplus_product's plain version (what the CUDA kernel is held
    against) on the kernel's edge cases: a k of one 16-deep slab, a k no
    multiple of it, negative entries, whole rows of a and columns of b at
    +inf (their outputs stay +inf)."""
    rng = np.random.default_rng(m + k + n)
    a = _inf_laced(rng, (m, k)) * 4 - 2
    b = _inf_laced(rng, (k, n)) * 4 - 2
    a[::3] = np.inf
    b[:, ::4] = np.inf
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.min_plus_pallas(a, b, block=64))
    got = K.minplus_product_plain(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(K.minplus_product(_t(a), _t(b)).numpy(),
                                  want)
    assert np.isinf(want[::3]).all() and np.isinf(want[:, ::4]).all()
    assert (want < 0).any()


def test_apsp_squaring_matches_pallas():
    n = 150
    d0 = _directed(n, 0.03, 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jops.apsp(jnp.asarray(d0), method="pallas_squaring",
                                    block=64))
        short = np.asarray(jops.apsp(jnp.asarray(d0), method="pallas_squaring",
                                     block=64, max_hops=3))
    np.testing.assert_array_equal(
        ops.apsp(_t(d0), method="pallas_squaring", block=64).numpy(), want)
    # two squarings reach 4 hops, not yet every path
    got = ops.apsp(_t(d0), method="pallas_squaring", block=64, max_hops=3)
    np.testing.assert_array_equal(got.numpy(), short)
    assert not np.array_equal(short, want)


@pytest.mark.parametrize("block", [32, 64])
def test_apsp_blocked_fw_classic_matches_pallas_on_directed(block):
    n = 200
    d0 = _directed(n, 0.02, 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jp.apsp_blocked_fw(jnp.asarray(d0), block=block,
                                             symmetric=False))
    src = _t(d0)
    K.reset_launches()
    got = K.apsp_blocked_fw(src, block=block)
    assert set(K.LAUNCHES.values()) == {0}  # CPU tensors: plain versions
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), d0)  # input left as it was
    assert np.isinf(want).any() and np.isfinite(want).any()


def test_apsp_defaults_match_jax_on_directed_matrix():
    """The fault the port had: ``apsp(d)`` defaulted to the mirror-halved
    round and mirrored arcs that do not exist, so on a directed matrix it
    gave distances shorter than the true shortest paths. With the JAX
    defaults it gives JAX's distances, under every JAX method name."""
    n = 200
    d0 = _directed(n, 0.02, 3)
    want = np.asarray(jops.apsp(jnp.asarray(d0)))  # off a TPU: the jnp loop
    got = ops.apsp(_t(d0)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        fw = np.asarray(jops.apsp(jnp.asarray(d0), method="pallas_fw"))
    np.testing.assert_array_equal(got, fw)  # the TPU's default, bitwise
    np.testing.assert_array_equal(
        ops.apsp(_t(d0), method="pallas_fw").numpy(), fw)
    np.testing.assert_array_equal(ops.apsp(_t(d0), method="jax").numpy(),
                                  want)
    np.testing.assert_allclose(
        ops.apsp(_t(d0), method="pallas_squaring").numpy(), want, rtol=1e-6)
    # the mirror-halved round is a promise about the input, not a default
    wrong = ops.apsp(_t(d0), symmetric=True).numpy()
    assert (wrong < want * (1 - 1e-6)).sum() > 0.1 * n * n


@pytest.mark.parametrize("band_tiles,shape", [
    (None, (4, 4)), (None, (3, 5)), (1, (5, 5)), (2, (6, 6)), (0, (4, 4)),
    (1, (3, 5)), (0, (5, 3))])
def test_relax_full_matches_pallas(band_tiles, shape):
    """B5 (``_relax_full``, rectangular too) and B6 (``_relax_full_banded``)
    against their plain version, in place on a window of a larger matrix;
    everything outside the window stays untouched."""
    block = 32
    rng = np.random.default_rng(sum(shape) + (band_tiles or 0))
    m, n = shape[0] * block, shape[1] * block
    q = _inf_laced(rng, (m, block))
    p = _inf_laced(rng, (block, n))
    d = _inf_laced(rng, (m + 2 * block, n + 2 * block))
    win = d[block:block + m, block:block + n]
    with pltpu.force_tpu_interpret_mode():
        if band_tiles is None:
            want = jp._relax_full(jnp.asarray(q), jnp.asarray(p),
                                  jnp.asarray(win), block=block)
        else:
            want = jp._relax_full_banded(jnp.asarray(q), jnp.asarray(p),
                                         jnp.asarray(win), block=block,
                                         band_tiles=band_tiles)
    got = _t(d)
    K.relax_full(_t(q), _t(p), got[block:block + m, block:block + n],
                 band_tiles)
    got = got.numpy()
    np.testing.assert_array_equal(got[block:block + m, block:block + n],
                                  np.asarray(want))
    outside = np.ones_like(d, dtype=bool)
    outside[block:block + m, block:block + n] = False
    np.testing.assert_array_equal(got[outside], d[outside])


@pytest.mark.parametrize("bt", ["0", "1", "nb-1", "nb"])
@pytest.mark.parametrize("shape", [(4, 4), (3, 5), (5, 3)])
def test_full_tiles_are_the_tiles_pallas_changes(shape, bt):
    """The banded relax_full kernel's tile list is the set of tiles that
    ``_relax_full_banded`` changes: with +inf-free Q and P over an all-+inf
    D, every in-band tile changes and no other; no tile is listed twice."""
    block = 32
    nb = max(shape)
    band = {"0": 0, "1": 1, "nb-1": nb - 1, "nb": nb}[bt]
    rng = np.random.default_rng(nb + band)
    m, n = shape[0] * block, shape[1] * block
    q = rng.uniform(0, 1, (m, block)).astype(np.float32)
    p = rng.uniform(0, 1, (block, n)).astype(np.float32)
    d = np.full((m, n), np.inf, np.float32)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jp._relax_full_banded(jnp.asarray(q), jnp.asarray(p),
                                               jnp.asarray(d), block=block,
                                               band_tiles=band))
    tiles = out.reshape(shape[0], block, shape[1], block)
    changed = {(int(i), int(j)) for i, j in np.argwhere(
        np.isfinite(tiles).all(axis=(1, 3)))}
    assert not np.isfinite(tiles).any(axis=(1, 3))[
        ~np.isfinite(tiles).all(axis=(1, 3))].any()
    listed = K.full_tiles(*shape, band).tolist()
    assert len(listed) == len(changed)
    assert {(i, j) for i, j, _, _ in listed} == changed
    assert all(mi == mj == -1 for _, _, mi, mj in listed)


@pytest.mark.parametrize("block,seed", [(32, 0), (64, 1)])
def test_banded_fw_classic_matches_jax_on_directed(block, seed):
    """A directed kNN matrix in the geometric banded order: the port's
    classic banded FW equals JAX's with the Pallas kernels (interpret) and
    with ``use_pallas=False``; within the radius it equals the dense FW."""
    n = 200
    coords, d = _directed_knn(n, 6, seed)
    nr = 0.12 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = tab.banded_order(coords, nr * (1 + 1e-5))
    window = tab.window_width(n, band, block)
    assert window < -(-n // block) * block  # the band restricts the rounds
    d0 = d[np.ix_(order, order)]
    padded = jax_pad(jnp.asarray(d0), block)
    kw = dict(window=window, block=block, symmetric=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jab.apsp_banded_fw(padded, use_pallas=True, **kw))
    np.testing.assert_array_equal(
        np.asarray(jab.apsp_banded_fw(padded, use_pallas=False, **kw)), want)
    got = pad_distances(_t(d0), block)
    assert tab.apsp_banded_fw(got, **kw) is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    # a path within the radius stays in the disk, so directed arcs keep the
    # certificate: the thresholded indicator equals the dense FW's
    full = ops.apsp(_t(d0), block=block).numpy()
    r = float(np.float32(nr))
    np.testing.assert_array_equal(got.numpy()[:n, :n] <= r, full <= r)
    assert not np.array_equal(full, full.T)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_euclidean_distance_matrix_matches_jax(dtype):
    coords = np.random.default_rng(4).uniform(-1, 1, (150, 2)).astype(dtype)
    want = np.asarray(jops.euclidean_distance_matrix(coords))
    got = ops.euclidean_distance_matrix(_t(coords))
    assert got.dtype == _t(coords).dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        # |x|^2 + |y|^2 - 2 x.y leaves a few f32 ulps of |x|^2 (~1e-7) in
        # the squared distance whichever order the matmul sums in, and the
        # square root magnifies that near 0: compare the squares
        np.testing.assert_allclose(got.numpy() ** 2, want ** 2, atol=1e-6)
    assert (got.diagonal() == 0).all()


def test_fdr_bh_matches_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, (60, 40)) ** 3
    p[rng.random(p.shape) < 0.15] = np.nan
    p[3] = np.nan  # a row with no test at all
    p[4, :5] = p[4, 5]  # ties
    want = np.asarray(jops.fdr_bh(p))
    got = ops.fdr_bh(_t(p))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    one = ops.fdr_bh(torch.tensor([0.01, 0.04, 0.03, 0.5],  # last axis
                                  dtype=torch.float64))
    np.testing.assert_allclose(one.numpy(), np.asarray(jops.fdr_bh(
        np.array([0.01, 0.04, 0.03, 0.5]))), rtol=1e-12)


def test_flagship_step_matches_jax():
    """``__graft_entry__.entry()``'s forward step at its own n = 96, radius
    0.35, 32 permutations, through both packages' op-level functions with
    the same permutation indices."""
    from safepy_tpu.ops.score import compute_neighborhood_score as jscore

    d0, vals, valid = ge._example_problem()
    radius = np.float32(0.35)
    dist_j = np.asarray(jops.apsp(jnp.asarray(d0)))
    nbr_j = (dist_j <= radius).astype(np.float32)
    obs_j = np.asarray(jscore(jnp.asarray(nbr_j), jnp.asarray(vals), "sum"))
    nv, v, m = jperm.prepare_valid(jnp.asarray(nbr_j), jnp.asarray(vals),
                                   valid)
    perm_idx = np.stack([np.random.default_rng(i).permutation(len(valid))
                         for i in range(32)])
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))

    dist = ops.apsp(_t(d0))
    nbr = (dist <= radius).to(torch.float32)
    obs = ops.compute_neighborhood_score(nbr, _t(vals), "sum")
    nv_t, v_t, m_t = tperm.prepare_valid(nbr, _t(vals), _t(valid))
    cn, cp = tperm.scan_counts(nv_t, v_t, m_t, obs, score_type="sum",
                               num_permutations=32, batch_size=16,
                               perm_idx=perm_idx)

    np.testing.assert_array_equal(np.isinf(dist.numpy()), np.isinf(dist_j))
    np.testing.assert_allclose(dist.numpy(), dist_j, rtol=1e-6)
    with pltpu.force_tpu_interpret_mode():  # the step as a TPU runs it
        dist_tpu = np.asarray(jops.apsp(jnp.asarray(d0), method="pallas_fw"))
    np.testing.assert_array_equal(dist.numpy(), dist_tpu)
    np.testing.assert_array_equal(nbr.numpy(), nbr_j)
    np.testing.assert_allclose(obs.numpy(), obs_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cn.numpy(), (scores <= obs_j[None]).sum(0))
    np.testing.assert_array_equal(cp.numpy(), (scores >= obs_j[None]).sum(0))
    # the same counts from the exported entry point
    cn2, cp2 = ops.run_permutations(nbr, _t(vals), _t(valid), obs,
                                    perm_idx=perm_idx, num_permutations=32,
                                    batch_size=16)
    assert torch.equal(cn2, cn) and torch.equal(cp2, cp)
