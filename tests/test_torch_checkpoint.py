"""Saving a session: ``SAFE.save`` (pickle) and the .npz + .meta.json
checkpoints, the port against the JAX package.

- The pickle keeps the compact forms (f32 log-survival, int8 indicator,
  bands as bands) and holds no tensor; every public array is bitwise equal
  after loading (tests/test_aux.py:56-94), and the stages resume on the
  loaded session with the original's results.
- A session whose device is the card serves its host views and plots after
  unpickling where there is none, without touching a device; a stage that
  needs the device raises.
- ``save_session`` in one package and ``load_session`` in the other, both
  ways: arrays bitwise, the tables' columns equal (the meta JSON byte for
  byte where the sessions agree), a band in its own dtype (int8, uint8
  when bit-packed).
"""

import json
import pickle
import pickletools

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from safepy_tpu import SAFE as JaxSAFE  # noqa: E402
from safepy_tpu import checkpoint as jax_ck  # noqa: E402
from safepy_tpu.io.layout import calculate_edge_lengths  # noqa: E402
from safepy_tpu.ops.apsp_bandstore import BandedMatrix as JaxBanded  # noqa: E402
from safepy_tpu_torch import SAFE  # noqa: E402
from safepy_tpu_torch import checkpoint as ck  # noqa: E402
from safepy_tpu_torch.ops.apsp_bandstore import BandedMatrix  # noqa: E402

PUBLIC = ("neighborhoods", "node_distances", "node2attribute", "ns",
          "pvalues_neg", "pvalues_pos", "nes", "nes_binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _knn(n=160, k=6, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from({(min(i, int(j)), max(i, int(j)))
                      for i in range(n) for j in nn[i, 1:]})
    for i in range(n):
        g.nodes[i].update(label=f"g{i}", key=f"g{i}", x=float(coords[i, 0]),
                          y=float(coords[i, 1]))
    calculate_edge_lengths(g, verbose=False)
    return g, coords


def _terms(coords, a=8, seed=5):
    """Binary terms of members near random centres, 10% of rows NaN."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    out = np.zeros((n, a))
    for j in range(a):
        near = (np.linalg.norm(coords - rng.uniform(-0.6, 0.6, 2), axis=1)
                < rng.uniform(0.3, 0.7))
        out[:, j] = (near & (rng.random(n) < 0.7)) | (rng.random(n) < 0.03)
    out[rng.random(n) < 0.1] = np.nan
    return out


def _frame(vals):
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(len(vals))],
                        columns=[f"go term/{j}" for j in range(vals.shape[1])])


@pytest.fixture(scope="module")
def net():
    g, coords = _knn()
    return g, _terms(coords)


def _session(cls, net, how, domains=True, **settings):
    """A session of ``cls`` (either package) run as ``how`` says, then
    (``domains``) the domain stage where it finds domains."""
    g, vals = net
    sf = cls(verbose=False, **({"device": "cpu"} if cls is SAFE else {}))
    sf.random_seed = 4
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.load_network(network_file=g, node_key_attribute="key")
    if how == "quantitative":
        q = np.where(np.isnan(vals[:, :2]), np.nan,
                     np.random.default_rng(1).normal(size=(len(vals), 2)))
        sf.load_attributes(attribute_file=_frame(q))
        sf.run_pipeline(num_permutations=50)
        return sf
    sf.load_attributes(attribute_file=_frame(vals))
    if how == "staged":
        sf.define_neighborhoods()
        sf.compute_pvalues()
    else:
        sf.run_pipeline()
    if not domains:
        return sf
    sf.define_top_attributes(attribute_enrichment_min_size=3)
    if np.sum(sf.attributes["top"]) >= 2:
        sf.define_domains()
        sf.trim_domains()
    return sf


SESSIONS = {
    "dense fused": dict(how="fused"),
    "dense staged": dict(how="staged"),
    "dense fused FDR": dict(how="fused", multiple_testing=True),
    "dense quantitative": dict(how="quantitative"),
    "band fused": dict(how="fused", apsp_mode="band"),
    "band packed FDR": dict(how="fused", apsp_mode="band",
                            band_indicator_bits=True, multiple_testing=True),
    "band quantitative": dict(how="quantitative", apsp_mode="band"),
}


@pytest.fixture(scope="module")
def sessions(net):
    return {name: _session(SAFE, net, **kw) for name, kw in SESSIONS.items()}


def _globals(blob):
    """The modules of the globals a pickle names."""
    mods = set()
    strings = []
    for op, arg, _ in pickletools.genops(blob):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            strings.append(arg)
        elif op.name == "STACK_GLOBAL" and len(strings) >= 2:
            mods.add(strings[-2])
        elif op.name == "GLOBAL":
            mods.add(arg.split(" ")[0])
    return mods


def _public(sf):
    return {k: getattr(sf, k) for k in PUBLIC}


def _assert_public_equal(got, want):
    for k in PUBLIC:
        a, b = got[k], want[k]
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", list(SESSIONS))
def test_pickle_is_compact_numpy_and_bitwise(sessions, name):
    sf = sessions[name]
    blob = pickle.dumps(sf)  # before any property materializes f64
    mods = _globals(blob)
    assert not any(m.split(".")[0] == "torch" for m in mods), mods
    back = pickle.loads(blob)
    assert back.device == torch.device("cpu")
    if sf._logsf_dev is not None:
        assert back._logsf_np.dtype == np.float32
        assert back._pvalues_pos_np is None
    if sf._nes_binary_dev is not None:
        assert back._nes_binary_i8_np.dtype == np.int8
        assert back._nes_binary_np is None
    band = isinstance(sf._neighborhoods_dev, BandedMatrix)
    if band:
        assert isinstance(back._neighborhoods_dev.data, np.ndarray)
        assert back._neighborhoods_dev.data.dtype == (
            np.uint8 if sf.band_indicator_bits is True else np.int8)
        n = sf._num_nodes
        assert not any(isinstance(v, np.ndarray) and v.size >= n * n
                       for v in back.__dict__.values())
    _assert_public_equal(_public(back), _public(sf))
    for j in range(sf.nes.shape[1]):
        np.testing.assert_array_equal(back._nes_column(j), sf.nes[:, j])
        np.testing.assert_array_equal(back._nes_binary_column(j),
                                      sf.nes_binary[:, j])
    assert back.nes_binary.dtype == np.float64
    # a second pickle of the loaded session: the same state
    _assert_public_equal(_public(pickle.loads(pickle.dumps(back))),
                         _public(sf))


@pytest.mark.parametrize("name", ["dense fused", "band fused",
                                  "band quantitative"])
def test_unpickled_session_resumes(sessions, name, tmp_path):
    """save() / unpickle, then the stages on the loaded session equal the
    same calls on the original (the band uploaded on first use)."""
    sf = sessions[name]
    path = str(tmp_path / "s.p")
    sf.save(output_file=path)
    with open(path, "rb") as f:
        back = pickle.load(f)
    if sf.node2attribute is not None and name.endswith("quantitative"):
        for s in (sf, back):
            s.compute_pvalues(perm_idx=np.stack(
                [np.random.default_rng(r).permutation(
                    int(np.isfinite(sf.node2attribute).any(axis=1).sum()))
                 for r in range(20)]))
        _assert_public_equal(_public(back), _public(sf))
        return
    for s in (sf, back):
        s.define_domains(attribute_distance_threshold=0.5)
        s.trim_domains()
    np.testing.assert_array_equal(back.node2domain.counts,
                                  sf.node2domain.counts)
    np.testing.assert_array_equal(back.node2domain.primary_nes,
                                  sf.node2domain.primary_nes)
    np.testing.assert_array_equal(back.attributes["domain"],
                                  sf.attributes["domain"])
    assert back.domains["label"] == sf.domains["label"]


def test_card_session_serves_host_views_without_a_device(sessions,
                                                         monkeypatch):
    """A session saved with device 'cuda' unpickles where there is no card:
    nes, nes_binary, _nes_column, node2domain and the plots read the
    pickled numpy; a stage that needs the card raises."""
    sf = sessions["dense fused"]
    saved = sf.device
    want = _public(sf)
    try:
        sf.device = torch.device("cuda")
        blob = pickle.dumps(sf)
    finally:
        sf.device = saved

    def no_device(*args, **kwargs):
        raise AssertionError("a device was touched")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    back = pickle.loads(blob)
    assert back.device == torch.device("cuda")
    _assert_public_equal(_public(back), want)
    np.testing.assert_array_equal(back._nes_column(1), want["nes"][:, 1])
    np.testing.assert_array_equal(back.node2domain.counts,
                                  sf.node2domain.counts)
    back.plot_sample_attributes(attributes=list(back.attributes["name"][:2]),
                                show_significant_nodes=True)
    back.plot_composite_network(color_seed=0)
    plt.close("all")
    with pytest.raises((RuntimeError, AssertionError)):
        back.compute_pvalues()


def test_column_views_read_one_column(net):
    """_nes_column / _nes_binary_column slice the device matrices (the
    deferred log-survival included) and check the index on the host."""
    sf = _session(SAFE, net, "fused", domains=False, multiple_testing=True)
    assert sf._nes_from_logsf and sf._nes_np is None
    a = sf._logsf_dev.shape[1]
    for j in range(a):
        col = sf._nes_column(j)
        assert sf._nes_np is None  # no (N, A) host matrix made
        np.testing.assert_array_equal(col, sf.nes[:, j])
        sf._nes_np = None
        np.testing.assert_array_equal(sf._nes_binary_column(j),
                                      sf._nes_binary_dev[:, j].numpy())
    for j in (a, -1, 10 ** 6):
        with pytest.raises(IndexError, match="out of range"):
            sf._nes_column(j)
        with pytest.raises(IndexError, match="out of range"):
            sf._nes_binary_column(j)


# ------------------------------------------------------------ checkpoints


def _fix_jax_sizes(jax_sf):
    """JAX's define_top_attributes stores a one-component size as a 0-d
    array, which pandas' to_json refuses; store it as 1-d so that JAX's
    save_session can write the table (what the port writes for it)."""
    if "size_connected_components" in jax_sf.attributes:
        jax_sf.attributes["size_connected_components"] = [
            np.atleast_1d(v) if isinstance(v, np.ndarray) else v
            for v in jax_sf.attributes["size_connected_components"]]


def _meta(path):
    with open(path + ".meta.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def staged_pair(net):
    jax_sf = _session(JaxSAFE, net, "staged")
    _fix_jax_sizes(jax_sf)
    return jax_sf, _session(SAFE, net, "staged")


def test_meta_json_is_pandas_to_json(staged_pair, tmp_path):
    """Where the sessions agree, the port's meta JSON is byte for byte what
    JAX's pandas writes: attributes, node2domain and domains."""
    jax_sf, sf = staged_pair
    np.testing.assert_array_equal(sf.nes, jax_sf.nes)
    jax_ck.save_session(jax_sf, str(tmp_path / "j"))
    ck.save_session(sf, str(tmp_path / "p"))
    want, got = _meta(str(tmp_path / "j")), _meta(str(tmp_path / "p"))
    for key in ("attributes", "node2domain", "domains"):
        assert got[key] == want[key], key
    for k in ("enrichment_threshold", "num_permutations", "random_seed",
              "attribute_enrichment_min_size", "neighborhood_radius"):
        assert got["settings"][k] == want["settings"][k]
    with np.load(str(tmp_path / "j.npz")) as a, \
            np.load(str(tmp_path / "p.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if k == "node_distances":  # the distance contract: 1e-6
                np.testing.assert_allclose(b[k], a[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _tables_equal(port_sf, jax_sf):
    """The columns the stages read, equal across packages."""
    pa, ja = port_sf.attributes, jax_sf.attributes
    assert list(pa["name"]) == list(ja["name"])
    for col in ("num_neighborhoods_enriched", "top", "domain"):
        if col in ja:
            np.testing.assert_array_equal(pa[col], ja[col].to_numpy())
            assert np.asarray(pa[col]).dtype == ja[col].dtype, col
    if jax_sf.node2domain is not None:
        n2d = jax_sf.node2domain
        ids = [c for c in n2d.columns if not isinstance(c, str)]
        np.testing.assert_array_equal(port_sf.node2domain.domains, ids)
        np.testing.assert_array_equal(port_sf.node2domain.counts,
                                      n2d[ids].to_numpy())
        for col in ("primary_domain", "primary_nes"):
            np.testing.assert_array_equal(port_sf.node2domain[col],
                                          n2d[col].to_numpy())
    if jax_sf.domains is not None:
        np.testing.assert_array_equal(port_sf.domains["id"],
                                      jax_sf.domains["id"].to_numpy())
        assert list(port_sf.domains["label"]) == \
            list(jax_sf.domains["label"])


@pytest.mark.parametrize("how", ["staged", "fused"])
def test_checkpoints_cross_load(net, tmp_path, how):
    """save_session in one package, load_session in the other, both ways:
    the arrays as saved, and the tables as the saving package reads its
    own file back."""
    jax_sf = _session(JaxSAFE, net, how)
    _fix_jax_sizes(jax_sf)
    sf = _session(SAFE, net, how)
    jp, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jax_ck.save_session(jax_sf, jp)
    ck.save_session(sf, pp)
    g = net[0]

    port_from_jax = ck.load_session(jp, graph=g, verbose=False, device="cpu")
    jax_from_port = jax_ck.load_session(pp, graph=g, verbose=False)
    jax_from_jax = jax_ck.load_session(jp, graph=g, verbose=False)
    port_from_port = ck.load_session(pp, graph=g, verbose=False,
                                     device="cpu")

    def arrays(s):
        return {k: getattr(s, k) for k in PUBLIC}
    for k, v in arrays(jax_sf).items():
        w = arrays(port_from_jax)[k]
        assert (v is None) == (w is None), k
        if v is not None:
            np.testing.assert_array_equal(w, np.asarray(v).astype(w.dtype),
                                          err_msg=k)
    for k, v in arrays(port_from_port).items():
        w = getattr(jax_from_port, k)
        if v is not None:
            np.testing.assert_array_equal(np.asarray(w), v, err_msg=k)
    _tables_equal(port_from_jax, jax_from_jax)
    _tables_equal(port_from_port, jax_from_port)
    # both resume: the top attributes of the loaded session
    for s in (port_from_jax, port_from_port):
        s.define_top_attributes(attribute_enrichment_min_size=3)
        np.testing.assert_array_equal(s.attributes["top"],
                                      sf.attributes["top"])


@pytest.mark.parametrize("bits", [False, True], ids=["int8", "packed"])
def test_band_checkpoint_keeps_its_dtype(net, tmp_path, monkeypatch, bits):
    """A band session that cannot be dense (the guard lowered to this
    scale) checkpoints its band in its own dtype, in both packages; each
    loads the other's, and the loaded session resumes."""
    monkeypatch.setattr(BandedMatrix, "DENSE_MAX_BYTES", 1000)
    monkeypatch.setattr(JaxBanded, "DENSE_MAX_BYTES", 1000)
    settings = dict(apsp_mode="band", band_indicator_bits=bits)
    jax_sf = _session(JaxSAFE, net, "fused", **settings)
    _fix_jax_sizes(jax_sf)
    sf = _session(SAFE, net, "fused", **settings)
    jp, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jax_ck.save_session(jax_sf, jp)
    ck.save_session(sf, pp)
    dtype = np.uint8 if bits else np.int8
    with np.load(jp + ".npz") as a, np.load(pp + ".npz") as b:
        assert "neighborhoods" not in b.files
        assert b["neighborhoods_band"].dtype == dtype
        for k in ("neighborhoods_band", "band_rank", "band_meta"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    port_from_jax = ck.load_session(jp, graph=net[0], verbose=False,
                                    device="cpu")
    jax_from_port = jax_ck.load_session(pp, graph=net[0], verbose=False)
    for loaded in (port_from_jax._neighborhoods_dev,
                   jax_from_port._neighborhoods_dev):
        assert np.asarray(loaded.data).dtype == dtype
        np.testing.assert_array_equal(np.asarray(loaded.data),
                                      sf._neighborhoods_dev.data.numpy())
    np.testing.assert_array_equal(port_from_jax.nes_binary, sf.nes_binary)
    # resume on the loaded band: the enrichment again, then the top terms
    port_from_jax.compute_pvalues()
    np.testing.assert_array_equal(port_from_jax.nes_binary, sf.nes_binary)
    port_from_jax.define_top_attributes(attribute_enrichment_min_size=3)
    np.testing.assert_array_equal(port_from_jax.attributes["top"],
                                  sf.attributes["top"])


def test_split_json_floats_match_pandas():
    """The JSON float writer against pandas' encoder on awkward values."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.random(3000), rng.random(3000) * 1e6, -rng.random(500) * 100,
        10.0 ** rng.uniform(-20, 20, 3000), np.round(rng.random(500), 10),
        [0.0, -0.0, 0.5, 2.5, 0.05, 1e-15, 1e16 - 1, 1e16, 0.99999999999,
         4.9999999999e-11, np.nan, np.inf]])
    assert ck.split_json({"a": vals}, np.arange(len(vals))) == \
        pd.DataFrame({"a": vals}).to_json(orient="split")
