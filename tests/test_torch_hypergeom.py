"""The binary enrichment ops of the port against the JAX package's.

The same seeded numpy inputs go through JAX (CPU, x64 as the package enables
it) and the port's plain torch versions on CPU tensors. Tolerances:

  * ``hypergeom_sf`` / ``hypergeom_neglog10_sf``: within 1e-12 absolute of
    JAX (the tail parts are exact integer arithmetic and equal bitwise
    here) and 1e-6 of scipy;
  * ``finalize_logsf_device``: log sf and NES within 4 f32 ulps, the
    indicator exactly. The complement branch takes an f32 ``exp`` and an
    f32 ``log1p`` as JAX does, and XLA's CPU versions and torch's round
    differently (XLA's f32 ``exp`` differs from torch's in about 12% of
    arguments), one ulp each, and ``log1p(-t)`` doubles the tail's ulp
    for small t (measured: at most 4 ulps over 3e5 cells);
  * ``log_factorial`` within 1e-12 relative; ``build_logsf_table`` within
    1 f32 ulp plus 1e-11 absolute (near log sf = 0 the f64 recurrence
    cancels terms of order 1e3, the log factorials and the 1e250
    renormalizations, whose last bits XLA's f64 ``log`` and torch's round
    differently), the significance bits exactly, also at thresholds on
    stored values;
  * ``table_lookup``'s gather equal to JAX's slot loop;
  * ``fdr_bh_logsf``, chunked and unchunked, with ``-inf`` and NaN: within
    1 f32 ulp, indicator and counts exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.stats import hypergeom as scipy_hypergeom

import safepy_tpu  # noqa: F401  (enables x64 as the package does)
from safepy_tpu.ops import fdr as jfdr
from safepy_tpu.ops import hypergeom as jhyp
from safepy_tpu.ops import hypergeom_table as jtab
from safepy_tpu_torch import ops
from safepy_tpu_torch.ops import fdr as tfdr
from safepy_tpu_torch.ops import hypergeom as thyp
from safepy_tpu_torch.ops import hypergeom_table as ttab


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
    return torch.as_tensor(np.array(x))


def _ulps(got, want):
    """|got - want| in f32 ulps of ``want`` (0 where both are equal,
    infinities included)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    return np.where(same, 0.0, diff / ulp)


def _grid(M, seed, N=40, A=30):
    """Counts anywhere in [0, min(K, n)] plus some beyond the support."""
    rng = np.random.default_rng(seed)
    K = rng.integers(0, M + 1, (1, A)).astype(float)
    n = rng.integers(0, M + 1, (N, 1)).astype(float)
    k = np.floor(np.minimum(K, n) * rng.random((N, A)))
    k[::5] += rng.integers(1, 4, (1, A))[0]
    return k, K, n


@pytest.mark.parametrize("M,seed", [(50, 0), (300, 1), (3971, 2)])
def test_hypergeom_sf_matches_jax_and_scipy(M, seed):
    k, K, n = _grid(M, seed)
    want = scipy_hypergeom.sf(k - 1, M, K, n)
    got = ops.hypergeom_sf(_t(k), M, _t(K), _t(n))
    ref = np.asarray(jhyp.hypergeom_sf(k, M, K, n))
    assert isinstance(got, np.ndarray)
    assert np.max(np.abs(got - ref)) <= 1e-12
    assert np.max(np.abs(got - want)) <= 1e-6
    nes = ops.hypergeom_neglog10_sf(_t(k), M, _t(K), _t(n))
    nes_ref = np.asarray(jhyp.hypergeom_neglog10_sf(k, M, K, n))
    np.testing.assert_array_equal(np.isinf(nes), np.isinf(nes_ref))
    fin = np.isfinite(nes_ref)
    assert np.max(np.abs(nes[fin] - nes_ref[fin])) <= 1e-12


@pytest.mark.parametrize("k,K,n", [
    (0, 10, 5),    # k at the support's lower bound: 1
    (6, 10, 5),    # above the upper bound: 0
    (11, 10, 50),  # above K: 0
    (5, 10, 5),    # at the upper bound
    (10, 10, 100),  # n = M: X = K
    (3, 0, 40)])   # K = 0
def test_hypergeom_sf_edge_cases(k, K, n):
    """The edge cases of tests/test_hypergeom.py:45, at M = 100."""
    M = 100
    got = ops.hypergeom_sf(_t([float(k)]), M, _t([float(K)]), _t([float(n)]))
    ref = np.asarray(jhyp.hypergeom_sf(k, M, K, n))
    assert np.max(np.abs(got - ref)) <= 1e-12
    assert abs(got[0] - scipy_hypergeom.sf(k - 1, M, K, n)) <= 1e-12


def test_tail_iterations_and_lgamma_table_match_jax():
    for m, d in [(50, 50), (3971, 300), (4000, 16), (10, 3)]:
        assert thyp.tail_iterations(m, d) == jhyp.tail_iterations(m, d)
    np.testing.assert_array_equal(thyp.lgamma_table(500),
                                  jhyp.lgamma_table(500))


@pytest.mark.parametrize("M,seed,threshold", [(300, 3, 0.05), (3971, 4, 0.01)])
def test_finalize_logsf_device_matches_jax(M, seed, threshold):
    k, K, n = np.broadcast_arrays(*_grid(M, seed, N=60, A=50))
    it = jhyp.tail_iterations(M, M)
    lgt = jhyp.lgamma_table(M)
    jparts = jhyp._sf_parts(jnp.asarray(k), M, jnp.asarray(K), jnp.asarray(n),
                            jnp.asarray(lgt), it)
    tparts = thyp._sf_parts(_t(k), M, _t(K), _t(n), _t(lgt), it)
    for a, b in zip(jparts, tparts):  # exact integer arithmetic: equal bits
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jnes, jlog, jbin = jhyp.finalize_logsf_device(jparts, threshold)
    tnes, tlog, tbin = thyp.finalize_logsf_device(tparts, threshold)
    assert tlog.dtype == tnes.dtype == torch.float32
    assert tbin.dtype == torch.int8
    assert _ulps(tlog.numpy(), jlog).max() <= 4
    assert _ulps(tnes.numpy(), jnes).max() <= 4
    np.testing.assert_array_equal(tbin.numpy(), np.asarray(jbin))
    # the p-values the facade recovers are within 1e-6 of scipy
    p = np.exp(tlog.numpy().astype(np.float64))
    assert np.max(np.abs(p - scipy_hypergeom.sf(k - 1, M, K, n))) <= 1e-6


def test_log_factorial_matches_jax():
    x = np.concatenate([np.arange(0, 40),
                        np.unique(np.geomspace(40, 1_000_000, 60).astype(int))]
                       ).astype(np.float64)
    got = ttab.log_factorial(_t(x)).numpy()
    want = np.asarray(jtab.log_factorial(jnp.asarray(x)))
    assert np.max(np.abs(got - want)) <= 1e-12 * np.maximum(1, np.abs(want)).max()


def _tables(K_dist, M, n_max, log_thr):
    R, S_max = jtab.table_geometry(K_dist, n_max, M)
    assert (R, S_max) == ttab.table_geometry(K_dist, n_max, M)
    C = 1
    while C < len(K_dist):
        C *= 2
    kd = np.zeros(C)
    kd[:len(K_dist)] = K_dist
    want = np.asarray(jtab.build_logsf_table(jnp.asarray(kd), M, log_thr,
                                             R=R, S_max=S_max, C=C))
    got = ttab.build_logsf_table(_t(kd), M, log_thr, R=R, S_max=S_max,
                                 C=C).numpy()
    return got, want


def _assert_table_close(got, want, log_thr):
    assert got.dtype == np.float32
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(diff <= np.spacing(np.abs(want)) + 1e-11)
    thr32 = np.float32(log_thr)
    np.testing.assert_array_equal(got < thr32, want < thr32)


@pytest.mark.parametrize("case", ["geometric", "renorm", "small-M",
                                  "beyond-slots"])
def test_build_logsf_table_matches_jax(case):
    """A GO-like class set, the extreme-overlap class of
    tests/test_hypergeom_table.py:78 whose 1/pmf(lo) overflows f64, rows
    past the population (n > M) with classes K = 0 and K = M, and a class
    whose support outgrows the slots on rows past n_max."""
    log_thr = float(np.log(0.05))
    if case == "geometric":
        K_dist = np.unique(np.random.default_rng(0).integers(0, 120, 21))
        got, want = _tables(K_dist, 400, 400, log_thr)
    elif case == "renorm":
        got, want = _tables(np.array([2000.0]), 4000, 2000, log_thr)
        assert np.all(np.isfinite(got[::-1, 0, 2000][:2001]))
    elif case == "small-M":
        got, want = _tables(np.array([0.0, 1.0, 5.0, 37.0, 99.0, 100.0]),
                            100, 200, log_thr)
    else:
        log_thr = float(np.log(1e-3))
        got, want = _tables(np.array([3.0, 40.0]), 5000, 60, log_thr)
    _assert_table_close(got, want, log_thr)


def test_table_nudge_at_the_threshold():
    """Thresholds on stored values and one f64 ulp either side: many cells'
    f64 log sf round to the f32 threshold, and ``stored < thr32`` must
    reproduce each package's f64 decision, the same in both."""
    K_dist = np.array([7.0, 30.0, 64.0])
    base, _ = _tables(K_dist, 150, 150, float(np.log(0.05)))
    on = base[(base < -0.5) & (base > -30)]
    for v in np.unique(on)[::37][:4]:
        v64 = float(v)
        for log_thr in (np.nextafter(v64, -np.inf), v64,
                        np.nextafter(v64, np.inf)):
            got, want = _tables(K_dist, 150, 150, float(log_thr))
            _assert_table_close(got, want, log_thr)


def test_table_lookup_gather_equals_jax_slot_loop():
    rng = np.random.default_rng(3)
    N, A, M = 300, 17, 260
    nsize = rng.integers(0, 200, N).astype(np.float32)
    K = rng.integers(0, 120, A).astype(np.float64)
    counts = np.floor(np.minimum(nsize[:, None], K[None, :])
                      * rng.random((N, A))).astype(np.float32)
    k_dist, colc = np.unique(K, return_inverse=True)
    R, S_max = ttab.table_geometry(k_dist, M, M)
    C = 32
    kd = np.zeros(C)
    kd[:len(k_dist)] = k_dist
    log_thr = float(np.log(0.05))
    table = np.asarray(jtab.build_logsf_table(jnp.asarray(kd), M, log_thr,
                                              R=R, S_max=S_max, C=C))
    nes, logsf, nbin = ttab.table_lookup(
        _t(table), _t(counts), _t(nsize), _t(colc), np.float32(log_thr),
        S_max=S_max, R=R, C=C)
    k = jnp.clip(jnp.round(jnp.asarray(counts)).astype(jnp.int32), 0,
                 S_max - 1)
    n_i = jnp.clip(jnp.round(jnp.asarray(nsize)).astype(jnp.int32), 0, R - 1)
    want = np.asarray(jtab._lookup_slot_loop(
        jnp.asarray(table), k, n_i, jnp.asarray(colc, jnp.int32),
        S_max=S_max))
    np.testing.assert_array_equal(logsf.numpy(), want)
    jnes, jlog, jbin = jtab.table_lookup(
        jnp.asarray(table), jnp.asarray(counts), jnp.asarray(nsize),
        jnp.asarray(colc, jnp.int32), np.float32(log_thr), S_max=S_max, R=R,
        C=C)
    np.testing.assert_array_equal(logsf.numpy(), np.asarray(jlog))
    np.testing.assert_array_equal(nes.numpy(), np.asarray(jnes))
    np.testing.assert_array_equal(nbin.numpy(), np.asarray(jbin))


def _logp(seed, rows=13, cols=29):
    rng = np.random.default_rng(seed)
    logp = np.log(rng.random((rows, cols))).astype(np.float32)
    logp[0, :5] = np.float32([-500.0, -80.0, -37.0, -1e-8, 0.0])
    logp[1, 2] = -np.inf
    logp[2, 4] = np.nan
    logp[3] = np.nan  # a row with nothing to test
    logp[4, 6:9] = logp[4, 5]  # ties
    return logp


@pytest.mark.parametrize("row_chunk", [None, 4, 13, 64])
def test_fdr_bh_logsf_matches_jax(row_chunk):
    logp = _logp(row_chunk or 0)
    thr = np.log(0.05)
    adj, nbin, counts = tfdr.fdr_bh_logsf(_t(logp), thr, row_chunk=row_chunk)
    jadj, jbin, jcounts = jfdr.fdr_bh_logsf(logp, thr, row_chunk=row_chunk)
    assert adj.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(adj.numpy()),
                                  np.isnan(np.asarray(jadj)))
    assert _ulps(adj.numpy(), jadj).max() <= 1
    assert adj[1, 2] == -np.inf
    np.testing.assert_array_equal(nbin.numpy(), np.asarray(jbin))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    # the host twin, from both packages
    hadj, hbin, hcounts = tfdr.fdr_bh_logsf_np(logp, thr)
    jhadj, jhbin, jhcounts = jfdr.fdr_bh_logsf_np(logp, thr)
    np.testing.assert_array_equal(hadj, jhadj)
    np.testing.assert_array_equal(hbin, jhbin)
    np.testing.assert_array_equal(hcounts, jhcounts)
    assert _ulps(adj.numpy(), hadj).max() <= 1
    np.testing.assert_array_equal(nbin.numpy(), hbin)


def test_fdr_bh_logsf_chunked_equals_unchunked():
    logp = _logp(5, rows=21)
    whole = tfdr.fdr_bh_logsf(_t(logp), np.log(0.05))
    for chunk in (1, 4, 8, 20):
        for a, b in zip(whole, tfdr.fdr_bh_logsf(_t(logp), np.log(0.05),
                                                 row_chunk=chunk)):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


def test_hypergeom_entry_points_take_array_likes_onto_the_card():
    """As the other op-level entry points: numpy operands go to the card,
    which raises here naming CPU tensors; CPU tensors compute on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy operands compute there")
    k, K, n = _grid(80, 6, N=5, A=4)
    for fn in (ops.hypergeom_sf, ops.hypergeom_neglog10_sf):
        with pytest.raises(RuntimeError, match="CPU tensors"):
            fn(k, 80, K, n)
    with pytest.raises(RuntimeError, match="CPU tensors"):
        tfdr.fdr_bh_logsf(np.zeros((2, 3), np.float32), np.log(0.05))
