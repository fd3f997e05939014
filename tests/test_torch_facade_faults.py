"""Facade rules that the port must apply as the JAX facade does.

Each test pins one repaired fault of the port against the JAX package:

  * the band-storage plan is decided on the band rounded up to the
    ``band_bt_bucket`` lattice (``safe.py:806``), so both packages take the
    same engine and store the same band;
  * binary detection counts the non-0/1 values of the f32 upload
    (``safe.py:1102-1105``), not of the f64 host values, and the binary
    run it selects equals JAX's (p-values within 1e-9 plus 4 f32 ulps of
    their stored log-survival, tests/test_torch_hypergeom.py);
  * ``run_pipeline`` takes ``neighborhood_radius_type`` (``safe.py:1646``);
  * ``parallel.make_mesh`` runs on the card unless the caller asks for the
    CPU, as ``SAFE`` does;
  * so does ``ops.neighborhoods.initial_distances_device``, which JAX builds
    on the accelerator;
  * ``load_attributes`` refuses +/-inf with a ``ValueError`` and warns on
    all-NaN columns (``debug.validate_attributes``, ``safe.py:416-419``);
  * a failed settings check restores the offending setting to its default
    before it raises (``config.validate_config``, ``config.py:140-193``).

Tolerances as in tests/test_torch_band_pipeline.py: neighborhoods identical,
distances within 1e-6 relative (the inf pattern equal).
"""

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu.io.layout import calculate_edge_lengths
from safepy_tpu_torch import SAFE
from safepy_tpu_torch.io.graph_arrays import edge_lengths
from safepy_tpu_torch.parallel import make_mesh
from safepy_tpu_torch.state import from_numpy_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under the test
    runner's parallel workers, torch's per-process intra-op thread pools
    oversubscribe the cores and run them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# 1,000 nodes at radius 0.05: the certified band is 59 (bt 1), whose
# storage is within half the dense bytes; bucketed to bt 4 it is not
N_NODES, RADIUS = 1000, 0.05


def _arrays(n=N_NODES, k=7, seed=3):
    """(coords, edges, lengths, weights) of a kNN geometric graph."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    weights = np.ones(len(edges))
    return coords, edges, edge_lengths(coords, edges, weights), weights


@pytest.fixture(scope="module")
def net():
    return _arrays()


def _plans(net, mode, min_nodes, frac, bucket):
    """(port plan, JAX plan) of ``_band_storage_plan`` on one network."""
    coords, edges, lengths, _ = net
    nr = frac * (coords[:, 0].max() - coords[:, 0].min())
    plans = []
    for sf in (SAFE(device="cpu", verbose=False), JaxSAFE(verbose=False)):
        sf.apsp_mode, sf.band_storage_min_nodes = mode, min_nodes
        sf.band_bt_bucket = bucket
        plans.append(sf._band_storage_plan(coords, edges, lengths,
                                           len(coords), nr))
    return plans


@pytest.mark.parametrize("mode,min_nodes,frac,bucket", [
    ("auto", 500, RADIUS, 4),     # raw band passes the rule, bucketed fails
    ("auto", 500, RADIUS, 0),     # no bucketing: both take the raw band
    ("band", 16384, RADIUS, 4),   # forced: bt 1 stored as bt 4
    ("band", 16384, 0.2, 3),      # another lattice
    ("auto", 2000, RADIUS, 4)])   # below band_storage_min_nodes
def test_band_storage_plan_matches_jax(net, mode, min_nodes, frac, bucket):
    ours, theirs = _plans(net, mode, min_nodes, frac, bucket)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours["band"] == theirs["band"]
        np.testing.assert_array_equal(ours["rank"], theirs["rank"])
        bt = ours["band"] // 128 + 1
        assert bucket <= 1 or bt % bucket == 0


def test_bucket_band_matches_jax():
    ours, theirs = SAFE(device="cpu", verbose=False), JaxSAFE(verbose=False)
    for bucket in (None, 0, 1, 3, 4):
        ours.band_bt_bucket = theirs.band_bt_bucket = bucket
        for band in (0, 59, 127, 128, 440, 511, 512, 1510, 1535, 1536):
            assert ours._bucket_band(band) == theirs._bucket_band(band)


def _graph(net):
    coords, edges, _, _ = net
    g = nx.Graph()
    g.add_nodes_from(range(len(coords)))
    g.add_edges_from(map(tuple, edges))
    for i, (x, y) in enumerate(coords):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(x), y=float(y))
    calculate_edge_lengths(g, verbose=False)
    return g


def _facades(net, mode, min_nodes, perms=20, seed=7):
    """The JAX facade and the port's, run on one network and attribute."""
    n = len(net[0])
    vals = np.random.default_rng(4).normal(size=(n, 1))
    vals[np.random.default_rng(5).random(n) < 0.3] = np.nan
    jsf = JaxSAFE(verbose=False)
    jsf.apsp_mode, jsf.band_storage_min_nodes = mode, min_nodes
    jsf.random_seed = seed
    jsf.load_network(network_file=_graph(net), node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(n)], columns=["q"]))
    jsf.run_pipeline(num_permutations=perms, neighborhood_radius=RADIUS)
    psf = from_numpy_state(jsf._graph_to_arrays_cached(), jsf.node2attribute,
                           neighborhood_radius=RADIUS, random_seed=seed,
                           device="cpu")
    psf.apsp_mode, psf.band_storage_min_nodes = mode, min_nodes
    psf.run_pipeline(num_permutations=perms)
    return jsf, psf


def test_auto_engine_follows_the_bucketed_band():
    """Above a lowered band_storage_min_nodes the raw band beats half the
    dense bytes but the bucketed one does not: both facades take the
    banded window, with the same neighborhoods."""
    jsf, psf = _facades(_arrays(), "auto", 500)
    assert list(jsf._bandstore_cache.values()) == [None]
    assert [p is not None for p in jsf._banded_cache.values()] == [True]
    assert list(psf._bandstore_cache.values()) == [None]
    assert psf.apsp_engine_used == "banded-window"
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)


def test_forced_band_stores_the_bucketed_band():
    """apsp_mode='band' with a raw bt of 1: both store the band of bt 4,
    with the same neighborhoods and node_distances."""
    jsf, psf = _facades(_arrays(), "band", 16384)
    j_plan = next(p for p in jsf._bandstore_cache.values() if p is not None)
    p_plan = next(p for p in psf._bandstore_cache.values() if p is not None)
    assert p_plan["band"] == j_plan["band"] == 4 * 128 - 1
    assert psf._neighborhoods_dev.band == jsf._neighborhoods_dev.band
    assert psf._node_distances_dev.bt == jsf._node_distances_dev.bt == 4
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    ours, theirs = psf.node_distances, jsf.node_distances
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


@pytest.mark.parametrize("other", [1 + 1e-9, 1e39],
                         ids=["rounds-to-one", "overflows-to-inf"])
def test_binary_detection_counts_on_f32(other):
    """A column of 0, 1 and a value that is 1 or inf in f32: JAX counts no
    non-binary value, so 'auto' is the binary test, which the port takes
    too, with JAX's engine and results, rather than the permutation null."""
    n = 300
    net = _arrays(n)
    vals = (np.arange(n) % 2).astype(float)[:, None]
    vals[::7] = other
    jsf = JaxSAFE(verbose=False)
    jsf.load_network(network_file=_graph(net), node_key_attribute="key")
    jsf.load_attributes(attribute_file=pd.DataFrame(
        vals, index=[f"g{i}" for i in range(n)], columns=["b"]))
    with np.errstate(over="ignore"):
        assert jsf._num_other_values() == 0
        jsf.run_pipeline(neighborhood_radius=RADIUS)
    sf = from_numpy_state(jsf._graph_to_arrays_cached(), vals,
                          neighborhood_radius=RADIUS, random_seed=0,
                          device="cpu")
    assert sf._num_other_values() == 0
    with np.errstate(over="ignore"):
        sf.run_pipeline(num_permutations=20)
    assert sf._hypergeom_engine_used == jsf._hypergeom_engine_used
    np.testing.assert_array_equal(sf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(sf.nes_binary, jsf.nes_binary)
    np.testing.assert_array_equal(sf.attributes["num_neighborhoods_enriched"],
                                  jsf.attributes["num_neighborhoods_enriched"])
    pj = jsf.pvalues_pos
    assert np.all(np.abs(sf.pvalues_pos - pj)
                  <= 1e-9 + 2.0 ** -21 * pj
                  * np.abs(np.log(np.maximum(pj, 1e-300))))
    sf.enrichment_type = "permutation"  # the quantitative null still runs
    sf.run_pipeline(num_permutations=20)
    assert sf.ns.shape == (n, 1)


def test_run_pipeline_takes_neighborhood_radius_type():
    n = 200
    vals = np.random.default_rng(1).normal(size=(n, 1))
    sf = from_numpy_state(_arrays(n), vals, neighborhood_radius=RADIUS,
                          random_seed=0, device="cpu")
    jsf = JaxSAFE(verbose=False)
    assert sf.neighborhood_radius_type == jsf.neighborhood_radius_type
    sf.run_pipeline(num_permutations=20, neighborhood_radius_type="radius")
    assert sf.neighborhood_radius_type == "radius"
    assert np.isfinite(sf.ns).all()


def test_make_mesh_runs_on_the_card_unless_asked_for_the_cpu():
    """Without device_type, make_mesh means the card; with no card it
    raises, naming the CPU option, before it looks for a process group
    (so no group is needed here)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh is the default")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh({"data": 1})
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh({"data": 1}, device_type="cuda")
    # asking for the CPU goes on to the process-group check
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh({"data": 1}, device_type="cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_initial_distances_device_runs_on_the_card_unless_asked_for_the_cpu(
        weighted):
    """Without device, the dense FW initialization is built on the card, as
    JAX builds it on the accelerator (``ops/neighborhoods.py:73``); with no
    card it raises, naming the CPU option; with device='cpu' it equals
    JAX's, parallel edges at their minimum and self-loops under the 0
    diagonal."""
    from safepy_tpu.ops import neighborhoods as jnb
    from safepy_tpu_torch.ops import neighborhoods as tnb

    edges = np.array([[0, 1], [1, 0], [1, 2], [3, 3], [4, 0], [2, 1]])
    w = np.array([0.5, 0.25, 1.0, 2.0, 0.75, 3.0]) if weighted else None
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tnb.initial_distances_device(6, edges, w, device=device)
    got = tnb.initial_distances_device(6, edges, w, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnb.initial_distances_device(6, edges, w)))


# C8: the attribute checks of load_attributes

DRY_N = 200


def _dry_graph():
    """200 uniform nodes, edges under 0.18 (``__graft_entry__.py:97-110``)."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 1, (DRY_N, 2))
    g = nx.Graph()
    for i in range(DRY_N):
        g.add_node(i, x=float(coords[i, 0]), y=float(coords[i, 1]),
                   label=f"g{i}", key=f"g{i}")
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    g.add_edges_from(zip(*np.nonzero(np.triu(d < 0.18, 1))))
    calculate_edge_lengths(g, verbose=False)
    return g


def _inf_matrix(kind):
    rng = np.random.default_rng(1)
    if kind == "quantitative":
        vals = rng.normal(size=(DRY_N, 6))
    else:
        vals = (rng.random((DRY_N, 6)) < 0.2).astype(float)
    vals[3, 0] = np.inf
    return vals


@pytest.mark.parametrize("kind", ["quantitative", "binary"])
@pytest.mark.parametrize("form", ["array", "dataframe"])
def test_load_attributes_refuses_inf_as_jax_does(kind, form):
    g = _dry_graph()
    vals = _inf_matrix(kind)
    df = pd.DataFrame(vals, index=[f"g{i}" for i in range(DRY_N)],
                      columns=[f"c{j}" for j in range(6)])
    jsf = JaxSAFE(verbose=False)
    jsf.load_network(network_file=g, node_key_attribute="key")
    with pytest.raises(ValueError, match="inf"):
        jsf.load_attributes(attribute_file=df)
    psf = SAFE(device="cpu", verbose=False)
    if form == "array":
        psf.load_network(network_file=jsf._graph_to_arrays_cached())
    else:
        psf.load_network(network_file=g, node_key_attribute="key")
    with pytest.raises(ValueError, match=r"\+/-inf; use NaN"):
        psf.load_attributes(attribute_file=vals if form == "array" else df)


def test_all_nan_column_warns_as_jax_does(caplog):
    g = _dry_graph()
    vals = np.random.default_rng(2).normal(size=(DRY_N, 3))
    vals[:, 1] = np.nan
    df = pd.DataFrame(vals, index=[f"g{i}" for i in range(DRY_N)],
                      columns=["a", "b", "c"])
    for sf in (JaxSAFE(verbose=True), SAFE(device="cpu", verbose=True)):
        sf.load_network(network_file=g, node_key_attribute="key")
        caplog.clear()
        sf.load_attributes(attribute_file=df)
        assert "1 attribute column(s) are entirely NaN" in caplog.text


# C9: a failed check restores the default

@pytest.mark.parametrize("setting,value", [
    ("background", "nope"), ("node_distance_metric", "nope"),
    ("attribute_sign", "nope"), ("num_permutations", 5),
    ("num_permutations", 100.0), ("enrichment_threshold", 1.5),
    ("enrichment_threshold", 0.0), ("enrichment_threshold", 1),
    ("apsp_mode", "nope"), ("attribute_enrichment_min_size", 1),
    ("attribute_enrichment_min_size", 2.5),
    ("attribute_distance_threshold", 1.5),
    ("attribute_distance_threshold", 1), ("cluster_engine", "pdist")])
def test_failed_check_restores_the_default_as_jax_does(setting, value):
    """Every check of the port: the setting after the error equals JAX's
    after its ``validate_config`` error. JAX checks no ``apsp_mode``; the
    port restores JAX's constructor default there."""
    psf, jsf = SAFE(device="cpu", verbose=False), JaxSAFE(verbose=False)
    setattr(psf, setting, value)
    with pytest.raises(ValueError):
        psf._validate()
    if setting == "apsp_mode":
        want = jsf.apsp_mode
    else:
        setattr(jsf, setting, value)
        with pytest.raises(ValueError):
            jsf.validate_config()
        want = getattr(jsf, setting)
    got = getattr(psf, setting)
    assert got == want and type(got) is type(want)
    psf._validate()  # the restored settings pass
