"""The port's band GO path against the benchmark's plain f64 hypergeometric
reference (``portbench/reference/hypergeom.py``), and that reference
against ``scipy.stats.hypergeom``.

A 640-node geometric network with band storage forced
(``apsp_mode='band'``) and the mean neighborhood of the ``genome20k``
configuration (radius sqrt(125 / (pi n)) of the extent, ~104 nodes); two
matrices of 48 binary terms, sizes log-uniform on 3-30, 10% of the genes
unannotated (the ``gobp`` mix at a small size). Each analysis is held to
the ``genome20k.gobp`` cell's own limits, by its own judge: neighborhoods
as the reference's, the NES within the stated f32 ulps and every call the
reference's f64 call. The reference's log-survival matches scipy's within
1e-10 relative at populations up to 5,000, and exact sums (mpmath) within
the same up to 20,000.
"""

import math
import sys
from pathlib import Path

import mpmath as mp
import numpy as np
import pytest
import torch
from scipy.stats import hypergeom

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, harness, spec  # noqa: E402
from portbench.reference import hypergeom as ref_hyper  # noqa: E402

CPU = torch.device("cpu")
WORKLOAD = "genome20k.gobp"
N_NODES, TERMS, POOL = 640, 48, 2
SEED = 2 ** 40 + 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain FW and the table's slot loop are loops of small torch
    ops; under parallel workers more threads only oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cell(engine: str):
    cell = spec.load_cell(ROOT, WORKLOAD)
    cell.config["network"]["nodes"] = N_NODES
    cell.config["settings"]["apsp_mode"] = "band"
    cell.config["settings"]["neighborhood_radius"] = math.sqrt(
        125 / (math.pi * N_NODES))
    cell.traffic.update(pool=POOL, terms=TERMS,
                        term_sizes={"low": 3, "high": 30})
    cell.traffic["settings"] = dict(cell.traffic["settings"],
                                    hypergeom_engine=engine)
    return cell


@pytest.mark.parametrize("engine,used", [("auto", "table-band"),
                                         ("loop", "loop-band")])
def test_band_go_matches_the_plain_reference(engine, used):
    cell = small_cell(engine)
    limits = compare.load_limits(ROOT, WORKLOAD, cell.kind.NUMBERS)
    inputs = harness.make_inputs(cell, SEED, CPU)
    pool = inputs.pool
    assert len(pool) == POOL and pool[0].shape == (N_NODES, TERMS)
    # one NaN mask for the pool, 10% of the genes; every term has members
    nan_rows = np.isnan(pool[0]).all(axis=1)
    assert all(np.array_equal(np.isnan(m).all(axis=1), nan_rows)
               for m in pool)
    assert abs(nan_rows.mean() - 0.1) < 0.05
    assert all(np.nansum(m, axis=0).min() >= 3 for m in pool)

    sf = harness.make_session(cell, inputs, CPU)
    outs = []
    for k in range(POOL):
        sf.load_attributes(attribute_file=pool[k])
        sf.run_pipeline()
        assert sf.apsp_engine_used == "band-storage"
        assert sf._hypergeom_engine_used == used
        outs.append(cell.kind.keep(sf))
    j = cell.kind.Judge(inputs, CPU, block=128)
    j.judge_neighborhoods(sf.neighborhoods_sparse())
    for k, out in enumerate(outs):
        j.judge_analysis(k, out)
    correct, checks = compare.verdict(j.readings, limits)
    assert correct, checks
    assert j.rows_off == 0 and j.checked == POOL
    assert checks["nes_binary_bad"]["value"] == 0
    # the terms are enriched somewhere, so the calls are tested
    assert any(out["nes_binary"].any() for out in outs)


def _cases(seed, count=100, m_max=5000):
    """``count`` (M, K, n, k) with M <= ``m_max`` and k >= 1 within the
    support."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        M = int(rng.integers(20, m_max + 1))
        K = int(rng.integers(1, min(M, 300) + 1))
        n = int(rng.integers(1, min(M, 400) + 1))
        lo, hi = max(1, n + K - M), min(K, n)
        if lo <= hi:
            out.append((M, K, n, int(rng.integers(lo, hi + 1))))
    return out


def _log_sf(M, K, n, k):
    return ref_hyper.log_sf(torch.tensor([k]), torch.tensor([K]),
                            torch.tensor([n]), M,
                            ref_hyper.log_factorials(M))[0].item()


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_reference_log_sf_matches_scipy(seed):
    """scipy's ``hypergeom.logsf(k - 1, M, K, n)`` within 1e-10 relative,
    at populations up to 5,000. Past that scipy's own log-pmf (a sum of
    ``betaln``) drifts: at (M, K, n, k) = (16072, 71, 232, 1) it is 1.0e-10
    off the exact value, the reference 9.5e-12; the test below holds the
    reference to exact values there."""
    for M, K, n, k in _cases(seed):
        got, want = _log_sf(M, K, n, k), hypergeom.logsf(k - 1, M, K, n)
        assert abs(got - want) <= 1e-10 * abs(want), (M, K, n, k, got,
                                                       want)


def test_reference_log_sf_matches_exact_sums_at_genome_scale():
    """The exact log P(X >= k), a sum of integer binomials in 40-digit
    arithmetic (mpmath), within 1e-10 relative at populations up to 20,000
    (the ``genome20k`` cell's M is ~18,400)."""
    mp.mp.dps = 40
    for M, K, n, k in _cases(21, count=40, m_max=20000):
        hi = min(K, n)
        exact = float(mp.log(
            sum(mp.binomial(K, j) * mp.binomial(M - K, n - j)
                for j in range(k, hi + 1)) / mp.binomial(M, n)))
        got = _log_sf(M, K, n, k)
        assert abs(got - exact) <= 1e-10 * abs(exact), (M, K, n, k, got,
                                                        exact)


def test_reference_log_sf_at_the_support_ends():
    """log P(X >= k) is exactly 0 at and below the support's lowest value,
    -inf past its highest; one call over many cells equals cell by cell."""
    M, K, n = 50, 30, 40       # support 20..30
    lf = ref_hyper.log_factorials(M)
    k = torch.tensor([0, 1, 20, 21, 30, 31])
    got = ref_hyper.log_sf(k, torch.full_like(k, K), torch.full_like(k, n),
                           M, lf)
    assert got[:3].tolist() == [0.0, 0.0, 0.0]
    assert got[5].item() == -math.inf
    assert got[4].item() == pytest.approx(hypergeom.logpmf(30, M, K, n),
                                          rel=1e-12)
    one = [ref_hyper.log_sf(k[i:i + 1], torch.tensor([K]),
                            torch.tensor([n]), M, lf).item()
           for i in range(len(k))]
    assert got.tolist() == one


def test_reference_census_counts_members_and_annotated_genes():
    rng = np.random.default_rng(3)
    nbr = torch.as_tensor(rng.random((30, 30)) < 0.3)
    vals = (rng.random((30, 5)) < 0.4).astype(float)
    vals[rng.random(30) < 0.2] = np.nan
    pop = ref_hyper.Population(vals, CPU)
    k, n = pop.census(nbr)
    x0 = np.nan_to_num(vals)
    ann = ~np.isnan(vals).all(axis=1)
    assert np.array_equal(k.numpy(), nbr.numpy().astype(int) @ x0)
    assert np.array_equal(n.numpy(), nbr.numpy().astype(int) @ ann)
    assert pop.M == ann.sum()
    assert pop.K.tolist() == x0.sum(axis=0).astype(int).tolist()
