"""The euclidean metric's band form in the port (``euclidean_band_distances``
and ``euclidean_band_indicator`` in safepy_tpu_torch/ops/apsp_bandstore.py,
``euclidean_band_neighborhoods`` in safepy_tpu_torch/pipeline.py, and the
facade's plan and dispatch, which follows it with the band null tail)
against the JAX package's (apsp_bandstore.py:643-731, pipeline.py:267-297,
439-474, safe.py:443-466, 734, 1664-1681, 1795-1870), on the same seeded
numpy inputs.

Tolerances: distance bands, indicators (int8 and packed), plans and
engine choices bitwise / exactly JAX's: the port takes JAX's arithmetic,
including the fused multiply-add XLA's CPU backend makes of the sum of
two squares. Scores exact on dyadic values, counts exact with the same
permutations, hypergeometric p within 1e-6 of the dense run's (the class
table against the f64 tail loop, as tests/test_bandstore_facade.py:351 holds
them); the mean and std of the neighborhood sizes within 1e-6 (f32 sums in
another order).
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
import jax.numpy as jnp

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu import pipeline as jpipe
from safepy_tpu.ops import apsp_bandstore as jbs
from safepy_tpu.ops import permutation as jperm
from safepy_tpu_torch import SAFE
from safepy_tpu_torch import pipeline as pipe
from safepy_tpu_torch.ops import apsp_bandstore as bs
from safepy_tpu_torch.state import (BAND_SETTINGS, ENRICHMENT_SETTINGS,
                                    from_numpy_state)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(n, seed):
    """(n, 2) f32 points in [-1, 1]^2 in the x-sorted (banded) order."""
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
    return coords[np.argsort(coords[:, 0], kind="stable")].astype(np.float32)


@pytest.mark.parametrize("n,band,block,r", [
    (450, 96, 64, 0.11), (450, 160, 64, 0.2), (3000, 300, 128, 0.06),
    (130, 700, 128, 0.5)])
def test_euclidean_band_matches_jax(n, band, block, r):
    """tests/test_apsp_bandstore.py:187 on both packages: the distance
    band, pads and the exact-zero diagonal included, and the indicator
    built directly (int8 and packed) are JAX's bytes, and the indicator is
    the distance band's ``< r``."""
    cp = _points(n, n)
    r = np.float32(r)
    got = bs.euclidean_band_distances(torch.as_tensor(cp), n=n, band=band,
                                      block=block)
    want = jbs.euclidean_band_distances(jnp.asarray(cp), n=n, band=band,
                                        block=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bt = band // block + 1
    i = torch.arange(n)
    assert (got[bt * block + i, i % block + bt * block] == 0).all()
    for packed in (False, True):
        ind = bs.euclidean_band_indicator(torch.as_tensor(cp), r, n=n,
                                          band=band, block=block,
                                          packed=packed)
        j_ind = jbs.euclidean_band_indicator(jnp.asarray(cp), r, n=n,
                                             band=band, block=block,
                                             packed=packed)
        np.testing.assert_array_equal(ind.numpy(), np.asarray(j_ind))
        plain = bs.unpack_band_bits(ind) if packed else ind
        assert torch.equal(plain, (got < float(r)).to(torch.int8))


@pytest.mark.parametrize("keep,packed", [(True, False), (False, False),
                                         (False, True)])
def test_euclidean_band_neighborhoods_match_jax(keep, packed):
    n, band = 900, 200
    cp = _points(n, 5)
    r = np.float32(0.1)
    dist, s_ind, mean, std = pipe.euclidean_band_neighborhoods(
        torch.as_tensor(cp), r, n=n, band=band, keep_distances=keep,
        packed=packed)
    jd, js, jm, jstd = jpipe.euclidean_band_neighborhoods(
        jnp.asarray(cp), r, n=n, band=band, keep_distances=keep,
        packed=packed)
    np.testing.assert_array_equal(s_ind.numpy(), np.asarray(js))
    # f32 means of the same sizes, summed in another order
    np.testing.assert_allclose([float(mean), float(std)],
                               [float(jm), float(jstd)], rtol=1e-6)
    if keep:
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    else:
        assert dist is None and np.asarray(jd).shape[0] == 0
    with pytest.raises(ValueError, match="keep_distances=False"):
        pipe.euclidean_band_neighborhoods(torch.as_tensor(cp), r, n=n,
                                          band=band, packed=True)


# ------------------------------------------------------------------- facade

def _scatter(n=500, seed=2):
    coords = np.random.default_rng(seed).uniform(-1, 1, (n, 2))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    return g


@pytest.fixture(scope="module")
def scatter():
    return _scatter()


def _jax(graph, vals, **settings):
    jsf = JaxSAFE(verbose=False)
    jsf.node_distance_metric = "euclidean"
    jsf.random_seed = 5
    for k, v in settings.items():
        setattr(jsf, k, v)
    jsf.load_network(network_file=graph, node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(len(vals))]))
    return jsf


def _port(jsf):
    return from_numpy_state(
        jsf._graph_to_arrays_cached(), jsf.node2attribute,
        neighborhood_radius=jsf.neighborhood_radius,
        random_seed=jsf.random_seed, device="cpu",
        **{k: getattr(jsf, k) for k in ENRICHMENT_SETTINGS + BAND_SETTINGS})


def _dyadic(n, seed=8, a=2):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-8, 9, (n, a)) / 4
    vals[rng.random(n) < 0.3] = np.nan
    return vals


def _perm_idx(vals, count=30, seed=9):
    v = int(np.isfinite(vals).any(axis=1).sum())
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(v) for _ in range(count)])


def _jax_counts(jsf, perm_idx):
    """Counts of the JAX session's own neighborhoods and scores under
    ``perm_idx`` (tests/test_torch_enrichment_facade.py:197)."""
    n2a = jsf.node2attribute
    valid_rows = np.flatnonzero(np.isfinite(n2a).any(axis=1))
    nv, v, m = jperm.prepare_valid(jnp.asarray(jsf.neighborhoods, jnp.float32),
                                   jnp.asarray(n2a, jnp.float32), valid_rows)
    scores = np.asarray(jperm.permutation_scores(nv, v, m,
                                                 jnp.asarray(perm_idx), "sum"))
    return (scores <= jsf.ns[None]).sum(0), (scores >= jsf.ns[None]).sum(0)


@pytest.mark.parametrize("settings", [
    dict(apsp_mode="auto"), dict(apsp_mode="auto", band_storage_min_nodes=400),
    dict(apsp_mode="band"), dict(apsp_mode="band", band_bt_bucket=0),
    dict(apsp_mode="band", band_indicator_bits="auto",
         band_bits_min_bytes=10 ** 5),
    dict(apsp_mode="band", band_indicator_bits="auto",
         band_bits_min_bytes=10 ** 7),
    dict(apsp_mode="band", band_indicator_bits=True),
    dict(apsp_mode="full", band_indicator_bits=True)])
def test_euclidean_plan_and_packing_choice_match_jax(scatter, settings):
    """The facade's decisions for the euclidean metric, checked before
    porting its band form: the band plan (``_euclidean_band_plan``, JAX
    safe.py:734) and whether the band is packed (``_band_bits_selected``,
    :990), for each plan setting carried across by from_numpy_state. At
    500 points 'auto' never beats half the dense bytes."""
    jsf = _jax(scatter, _dyadic(500), neighborhood_radius=0.05, **settings)
    psf = _port(jsf)
    coords = jsf._graph_to_arrays_cached()[0]
    nr = 0.05 * (coords[:, 0].max() - coords[:, 0].min())
    jp = jsf._euclidean_band_plan(coords, 500, nr)
    pp = psf._euclidean_band_plan(coords, 500, nr)
    assert (pp is None) == (jp is None)
    if jp is not None:
        assert pp["band"] == jp["band"]
        np.testing.assert_array_equal(pp["rank"], jp["rank"])
        assert (psf._band_bits_selected(500, pp["band"])
                == jsf._band_bits_selected(500, jp["band"]))


@pytest.mark.parametrize("keep,bits", [(True, False), (False, False),
                                       (False, True), (True, True)])
def test_facade_euclidean_band_run_matches_jax(scatter, keep, bits):
    """run_pipeline's fused euclidean band form (JAX safe.py:1795) on both
    packages: the band (packed only without kept distances), the
    distances, the scores, and the counts of the same permutations."""
    vals = _dyadic(500)
    jsf = _jax(scatter, vals, apsp_mode="band", keep_node_distances=keep,
               band_indicator_bits=bits)
    jsf.run_pipeline(num_permutations=30)
    psf = _port(jsf)
    perm_idx = _perm_idx(vals)
    psf.run_pipeline(perm_idx=perm_idx)
    assert psf.apsp_engine_used == "band-storage"
    data = psf._neighborhoods_dev.data
    assert data.dtype == (torch.uint8 if bits and not keep else torch.int8)
    np.testing.assert_array_equal(data.numpy(),
                                  np.asarray(jsf._neighborhoods_dev.data))
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    if keep:
        np.testing.assert_array_equal(psf.node_distances, jsf.node_distances)
    else:
        assert psf.node_distances is None and jsf.node_distances is None
    np.testing.assert_array_equal(psf.ns, jsf.ns)
    cn, cp = _jax_counts(jsf, perm_idx)
    np.testing.assert_array_equal(psf.counts_neg, cn)
    np.testing.assert_array_equal(psf.counts_pos, cp)


@pytest.mark.parametrize("attrs", ["binary", "quantitative"])
def test_euclidean_band_matches_dense_and_staged(scatter, attrs):
    """The euclidean band equals the dense metric through the stages
    (tests/test_bandstore_facade.py:351): neighborhoods, and downstream
    the hypergeometric results or the null; and the fused quantitative
    run equals the stages (:482)."""
    n = 500
    if attrs == "binary":
        vals = (np.random.default_rng(12).random((n, 4)) < 0.1).astype(float)
    else:
        vals = _dyadic(n, seed=13)
    perm_idx = _perm_idx(vals)
    runs = {}
    for mode in ("full", "band"):
        sf = SAFE(device="cpu", verbose=False)
        sf.apsp_mode = mode
        sf.node_distance_metric = "euclidean"
        sf.load_network(network_file=_port(_jax(scatter, vals))._graph_arrays)
        sf.load_attributes(attribute_file=vals)
        sf.define_neighborhoods()
        sf.compute_pvalues(perm_idx=perm_idx)
        runs[mode] = sf
    dense, band = runs["full"], runs["band"]
    assert (dense.apsp_engine_used, band.apsp_engine_used) == (
        "euclidean", "band-storage")
    np.testing.assert_array_equal(band.neighborhoods, dense.neighborhoods)
    if attrs == "binary":
        assert band._hypergeom_engine_used == "table-band-staged"
        np.testing.assert_array_equal(band.nes_binary, dense.nes_binary)
        assert np.nanmax(np.abs(band.pvalues_pos - dense.pvalues_pos)) <= 1e-6
        return
    np.testing.assert_array_equal(band.ns, dense.ns)
    np.testing.assert_array_equal(band.counts_neg, dense.counts_neg)
    fused = SAFE(device="cpu", verbose=False)
    fused.apsp_mode = "band"
    fused.node_distance_metric = "euclidean"
    fused.load_network(network_file=band._graph_arrays)
    fused.load_attributes(attribute_file=vals)
    fused.run_pipeline(perm_idx=perm_idx)
    np.testing.assert_array_equal(fused.neighborhoods, band.neighborhoods)
    np.testing.assert_array_equal(fused.ns, band.ns)
    np.testing.assert_array_equal(fused.counts_neg, band.counts_neg)
    np.testing.assert_array_equal(fused.counts_pos, band.counts_pos)
