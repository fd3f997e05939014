"""The op-level surface takes array-likes onto the card, as JAX's does.

Every entry point of ``safepy_tpu.ops`` turns its operands into device
arrays (``jnp.asarray``), so numpy input computes on the accelerator. The
port's seven entry points of ``safepy_tpu_torch.ops`` do the same through
``ops._device.on_device``: numpy arrays and lists go to the device of the
call's first tensor operand (or generator), else to the card; with no card
they raise before anything is allocated, naming CPU tensors as the way to
the host. CPU tensors made from the same numpy give JAX's result on the
numpy: min-plus bitwise (the Pallas kernels in interpret mode), FDR within
1e-12, distances and scores within 1e-6 relative, indicators and counts
exactly (integer-valued attributes and injected permutations).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from safepy_tpu import ops as jops
from safepy_tpu.ops import permutation as jperm
from safepy_tpu_torch import ops
from safepy_tpu_torch.ops import _device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 90


def _inf_laced(rng, shape):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = np.inf
    return x


def _directed(rng):
    d = np.full((N, N), np.inf, np.float32)
    arcs = rng.random((N, N)) < 0.05
    d[arcs] = rng.uniform(0.1, 2.0, int(arcs.sum())).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _neighborhood_case(rng):
    """(indicator f32, integer-valued attributes with NaN, observed sums)."""
    coords = rng.uniform(-1, 1, (N, 2))
    d = np.hypot(*(coords[:, None] - coords[None]).transpose(2, 0, 1))
    nbr = (d <= 0.5).astype(np.float32)
    vals = rng.integers(-3, 4, (N, 2)).astype(np.float64)
    vals[rng.random((N, 2)) < 0.25] = np.nan
    obs = nbr @ np.nan_to_num(vals).astype(np.float32)
    return nbr, vals, obs


def _perm_idx(rng, count=24):
    return np.stack([rng.permutation(N) for _ in range(count)])


def _want_counts(nbr, vals, obs, perm_idx):
    nv, v, m = jperm.prepare_valid(jnp.asarray(nbr), jnp.asarray(vals), None)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))
    return (scores <= obs[None]).sum(0), (scores >= obs[None]).sum(0)


def _case(name, rng):
    """(port function, numpy operands, keyword arguments, JAX's result,
    compare(got, want))."""
    exact = np.testing.assert_array_equal
    if name == "apsp":
        d0 = _directed(rng)
        with pltpu.force_tpu_interpret_mode():  # the default's kernels
            want = np.asarray(jops.apsp(d0, method="pallas_fw"))
        return ops.apsp, (d0,), {}, want, exact
    if name == "min_plus_product":
        a, b = _inf_laced(rng, (60, 40)), _inf_laced(rng, (40, 50))
        want = np.asarray(jops.min_plus_product(a, b, method="jax"))
        return ops.min_plus_product, (a, b), {}, want, exact
    if name == "euclidean_distance_matrix":
        coords = rng.uniform(-1, 1, (N, 2))
        want = np.asarray(jops.euclidean_distance_matrix(coords))
        return (ops.euclidean_distance_matrix, (coords,), {}, want,
                lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6))
    if name == "neighborhoods_from_distances":
        coords = rng.uniform(-1, 1, (N, 2))
        d = np.array(jops.euclidean_distance_matrix(coords))
        want = np.asarray(jops.neighborhoods_from_distances(d, 0.4,
                                                            strict=False))
        return (lambda x: ops.neighborhoods_from_distances(x, 0.4,
                                                           strict=False),
                (d,), {}, want, exact)
    if name == "compute_neighborhood_score":
        nbr, vals, _ = _neighborhood_case(rng)
        want = np.asarray(jops.compute_neighborhood_score(nbr, vals))
        return (ops.compute_neighborhood_score, (nbr, vals), {}, want,
                lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6))
    if name == "run_permutations":
        nbr, vals, obs = _neighborhood_case(rng)
        perm_idx = _perm_idx(rng)
        want = np.stack(_want_counts(nbr, vals, obs, perm_idx))
        return (lambda *x: torch.stack(ops.run_permutations(
                    *x[:2], None, x[2], perm_idx=perm_idx,
                    num_permutations=len(perm_idx), batch_size=10)),
                (nbr, vals, obs), {}, want, exact)
    assert name == "fdr_bh"
    p = rng.uniform(0, 1, (20, 30)) ** 3
    p[rng.random(p.shape) < 0.15] = np.nan
    want = np.asarray(jops.fdr_bh(p))
    return (ops.fdr_bh, (p,), {}, want,
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-12,
                                                    atol=1e-12))


ENTRIES = ["apsp", "min_plus_product", "euclidean_distance_matrix",
           "neighborhoods_from_distances", "compute_neighborhood_score",
           "run_permutations", "fdr_bh"]


@pytest.mark.parametrize("name", ENTRIES)
def test_array_likes_go_to_the_card_and_cpu_tensors_stay(name, monkeypatch):
    """Numpy and list operands mean the card: with none here, a
    RuntimeError naming CPU tensors, raised before any operand is
    converted; CPU tensors of the same numpy give JAX's result on the
    numpy, on the CPU."""
    rng = np.random.default_rng(ENTRIES.index(name))
    fn, args, kw, want, compare = _case(name, rng)
    if not torch.cuda.is_available():
        def refuse(*a, **k):
            raise AssertionError("an operand was converted before the check")
        with monkeypatch.context() as m:
            m.setattr(torch, "as_tensor", refuse)
            for operands in (args, [x.tolist() for x in args]):
                with pytest.raises(RuntimeError, match="pass CPU tensors"):
                    fn(*operands, **kw)
    got = fn(*(torch.as_tensor(x) for x in args), **kw)
    assert got.device.type == "cpu"
    compare(got.numpy(), want)


def test_array_likes_follow_the_first_tensor_or_the_generator():
    """A numpy operand beside a CPU tensor computes on the CPU, as does a
    call of numpy operands whose generator lies on the CPU; the dtype is
    the operand's own (f64 stays f64, as ``jnp.asarray`` keeps it)."""
    rng = np.random.default_rng(9)
    nbr, vals, obs = _neighborhood_case(rng)
    perm_idx = _perm_idx(rng)
    want = _want_counts(nbr, vals, obs, perm_idx)
    got = ops.run_permutations(nbr, torch.as_tensor(vals), None, obs,
                               perm_idx=perm_idx,
                               num_permutations=len(perm_idx))
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    gen = torch.Generator().manual_seed(0)
    cn, cp = ops.run_permutations(nbr, vals, None, obs, generator=gen,
                                  num_permutations=16)
    assert cn.device.type == "cpu" and ((cn + cp) >= 16).all()
    a, b = _inf_laced(rng, (30, 20)), _inf_laced(rng, (20, 10))
    got = ops.min_plus_product(a, torch.as_tensor(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.min_plus_product(a, b, method="jax")))
    x, = _device.on_device("f", torch.zeros(2), rng.uniform(size=3))[1:]
    assert x.dtype == torch.float64 and x.device.type == "cpu"
    assert _device.on_device("f", [1.0, 2.0], torch.zeros(1))[0].dtype == (
        torch.float64)


def test_tensors_pass_through_unchanged():
    """The internal callers pass tensors: the helper hands back the very
    objects, None included, and needs no card for them."""
    t, u = torch.zeros(3), torch.ones(2, dtype=torch.float64)
    out = _device.on_device("f", t, None, u)
    assert out[0] is t and out[1] is None and out[2] is u
