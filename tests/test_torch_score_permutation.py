"""The port's neighborhood scores and permutation null against the JAX package.

Scores agree within 1e-5 (f32 matmuls summed in different orders). With
integer-valued attributes every f32 sum is exact, so when both packages get
the same permutation indices the null counts must be exactly equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from safepy_tpu.ops import permutation as jperm
from safepy_tpu.ops import score as jscore
from safepy_tpu_torch.ops import permutation as tperm
from safepy_tpu_torch.ops import score as tscore


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, n=120, a=3, integer=False, nan_share=0.3):
    rng = np.random.default_rng(seed)
    nbr = (rng.random((n, n)) < 0.15).astype(np.float32)
    nbr[10:14] = 0.0  # neighborhoods too small for a z-score
    np.fill_diagonal(nbr, 1.0)
    vals = (rng.integers(-4, 5, (n, a)).astype(np.float64) if integer
            else rng.normal(size=(n, a)) * 3 + 1)
    vals[rng.random((n, a)) < nan_share] = np.nan
    vals[:5] = np.nan  # some rows with no annotated value at all
    return rng, nbr, vals


@pytest.mark.parametrize("score_type", ["sum", "z-score"])
def test_neighborhood_score_matches_jax(score_type):
    _, nbr, vals = _inputs(0)
    want = np.asarray(jscore.compute_neighborhood_score(
        jnp.asarray(nbr), jnp.asarray(vals, jnp.float32), score_type))
    got = tscore.compute_neighborhood_score(
        torch.as_tensor(nbr), torch.as_tensor(vals), score_type).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if score_type == "z-score":
        assert np.isnan(want).any() and np.isfinite(want).any()


def _jax_counts(nbr, vals, valid_rows, obs, perm_idx):
    """JAX side of the null with explicit indices: prepare_valid +
    permutation_scores + two-sided tie-inclusive counting."""
    nbr_valid, v, m = jperm.prepare_valid(jnp.asarray(nbr),
                                          jnp.asarray(vals, jnp.float32),
                                          valid_rows)
    scores = np.asarray(jperm.permutation_scores(
        nbr_valid, v, m, jnp.asarray(perm_idx), "sum"))
    return ((scores <= obs[None]).sum(0), (scores >= obs[None]).sum(0))


@pytest.mark.parametrize("batch_size", [None, 37])  # 37: a ragged last chunk
def test_null_counts_exact_with_injected_permutations(batch_size):
    rng, nbr, vals = _inputs(1, integer=True)
    valid_rows = np.flatnonzero(np.isfinite(vals).any(axis=1))
    obs = np.asarray(jscore.compute_neighborhood_score(
        jnp.asarray(nbr), jnp.asarray(vals, jnp.float32), "sum"))
    P = 150
    perm_idx = np.stack([rng.permutation(len(valid_rows)) for _ in range(P)])
    want_neg, want_pos = _jax_counts(nbr, vals, valid_rows, obs, perm_idx)

    cn, cp = tperm.run_permutations(
        torch.as_tensor(nbr), torch.as_tensor(vals),
        torch.as_tensor(valid_rows), torch.as_tensor(obs.copy()),
        perm_idx=perm_idx,
        num_permutations=P, batch_size=batch_size)
    assert cn.dtype == torch.int32
    np.testing.assert_array_equal(cn.numpy(), want_neg)
    np.testing.assert_array_equal(cp.numpy(), want_pos)
    assert (want_neg + want_pos >= P).all()  # ties count on both sides


def test_zscore_permutation_scores_match_jax():
    rng, nbr, vals = _inputs(2)
    valid_rows = np.flatnonzero(np.isfinite(vals).any(axis=1))
    perm_idx = np.stack([rng.permutation(len(valid_rows)) for _ in range(20)])
    nv, v, m = jperm.prepare_valid(jnp.asarray(nbr),
                                   jnp.asarray(vals, jnp.float32), valid_rows)
    shift = jscore.zscore_shift(v, m)
    want = np.asarray(jperm.permutation_scores(
        nv, v - m * shift, m, jnp.asarray(perm_idx), "z-score", shift=shift))

    tv, tvals, tm = tperm.prepare_valid(torch.as_tensor(nbr),
                                        torch.as_tensor(vals),
                                        torch.as_tensor(valid_rows))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(nv))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))
    tshift = tscore.zscore_shift(tvals, tm)
    np.testing.assert_allclose(tshift.numpy(), np.asarray(shift), rtol=1e-6)
    got = tperm.permutation_scores(tv, tvals - tm * tshift, tm,
                                   torch.as_tensor(perm_idx), "z-score",
                                   shift=tshift).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generator_null_is_seeded_and_consistent():
    _, nbr, vals = _inputs(3)
    n2a = torch.as_tensor(vals)
    obs = tscore.compute_neighborhood_score(torch.as_tensor(nbr), n2a)
    valid = torch.as_tensor(np.flatnonzero(np.isfinite(vals).any(axis=1)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tperm.run_permutations(torch.as_tensor(nbr), n2a, valid, obs,
                                      generator=g, num_permutations=90,
                                      batch_size=40)

    a, b = run(11), run(11)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert ((a[0] + a[1]) >= 90).all()
    assert not torch.equal(a[0], run(12)[0])
    perms = tperm.random_permutations(50, 33, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.sort(perms.numpy(), axis=1),
                                  np.tile(np.arange(33), (50, 1)))


def test_batch_size_and_argument_checks():
    for v, a, p in ((2660, 1, 1000), (20_000, 4373, 1000), (10, 2, 7)):
        assert (tperm.default_batch_size(v, a, p)
                == jperm.default_batch_size(v, a, p))
    x = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="generator or perm_idx"):
        tperm.scan_counts(torch.zeros((4, 4)), x, x, x, score_type="sum",
                          num_permutations=10, batch_size=10)
    with pytest.raises(ValueError, match="perm_idx must be"):
        tperm.scan_counts(torch.zeros((4, 4)), x, x, x, score_type="sum",
                          num_permutations=10, batch_size=10,
                          perm_idx=np.zeros((3, 4), int))


def test_fp32_matmul_guard():
    a = torch.ones((3, 3))
    with pytest.raises(NotImplementedError, match="'default'"):
        tscore.compute_neighborhood_score(a, a, precision="default")
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full f32"):
            tscore.compute_neighborhood_score(a, a)
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="full f32"):
            tscore.compute_neighborhood_score(a, a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
        torch.set_float32_matmul_precision(old_prec)
