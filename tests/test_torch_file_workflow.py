"""The file-driven workflow through both packages on the CPU: an INI, a
network file, an attribute file, the stages, the domain stage and the
three TSV reports; the scatter input's euclidean pseudo-network; and the
batch CLI.

The slice as a whole runs ``tests/data/mini_network.txt`` and
``mini_attributes.txt`` with ``layoutAlgorithm = spring_embedded`` (the
networkx layout, the same bits in both packages) and seed 77: the
neighborhoods, ``nes_binary`` and enriched counts must be equal, with the
golden counts of tests/test_golden.py (39 enriched; [11, 10, 8, 6, 4]),
and the reports must match cell for cell (NES within 1e-12 relative, the
rest equal). The mini attributes give no top attribute, so the domain
stage runs on a second attribute file of graph balls.
"""

import csv
import os
import pickle

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu_torch import SAFE
from safepy_tpu_torch import cli
from safepy_tpu_torch.io import NetworkRecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETWORK = os.path.join(REPO, "tests", "data", "mini_network.txt")
ATTRIBUTES = os.path.join(REPO, "tests", "data", "mini_attributes.txt")
REPORTS = ("attribute_properties_annotation.txt",
           "node_properties_annotation.txt",
           "domain_properties_annotation.txt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ini(path, network=NETWORK, attributes=ATTRIBUTES, layout="spring_embedded",
         seed=77, extra=""):
    path.write_text(f"[Input files]\nnetworkfile = {network}\n"
                    f"annotationfile = {attributes}\n"
                    f"layoutAlgorithm = {layout}\n"
                    f"[Analysis parameters]\nrandomSeed = {seed}\n{extra}")
    return str(path)


def _sessions(ini):
    jsf = JaxSAFE(path_to_ini_file=ini, verbose=False)
    psf = SAFE(path_to_ini_file=ini, verbose=False, device="cpu")
    for sf in (jsf, psf):
        sf.load_network(node_key_attribute="key")
        sf.load_attributes()
    return jsf, psf


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _same_reports(jdir, pdir, names):
    for name in names:
        want, got = _read(os.path.join(jdir, name)), _read(
            os.path.join(pdir, name))
        assert got[0] == want[0], name
        assert len(got) == len(want), name
        for grow, wrow in zip(got[1:], want[1:]):
            for g, w in zip(grow, wrow):
                if g == w:
                    continue
                # a float cell: the NES of the two packages' enrichment
                assert float(g) == pytest.approx(float(w), rel=1e-12), name


def test_mini_dataset_slice(tmp_path):
    jsf, psf = _sessions(_ini(tmp_path / "run.ini"))
    np.testing.assert_array_equal(psf._graph_arrays[0],
                                  jsf._graph_to_arrays_cached()[0])
    for sf in (jsf, psf):
        sf.define_neighborhoods()
        sf.compute_pvalues()
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    assert int((psf.nes_binary > 0).sum()) == 39
    assert psf.attributes["num_neighborhoods_enriched"].tolist() == \
        [11.0, 10.0, 8.0, 6.0, 4.0]
    for sf in (jsf, psf):
        sf.define_top_attributes()
        with pytest.raises(ValueError, match="at least 2 top attributes"):
            sf.define_domains()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), pdir.mkdir()
    jsf.print_output_files(output_dir=str(jdir))
    psf.print_output_files(output_dir=str(pdir))
    assert not (pdir / REPORTS[2]).exists()  # no domains, no domain report
    _same_reports(jdir, pdir, REPORTS[:2])
    # no domains: the node report is the full NES matrix
    assert _read(pdir / REPORTS[1])[0] == ["", "key", "label"] + [
        f"attr{j}" for j in range(5)]


def _ball_attributes(path, sf, seed=0, terms=12):
    """Binary terms of the nodes within two hops of random centres."""
    _, edges, _, _ = sf._graph_arrays
    n = sf._num_nodes
    a = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    hop = shortest_path(a, directed=False, unweighted=True)
    rng = np.random.default_rng(seed)
    m = np.array([(hop[rng.integers(n)] <= 2).astype(int)
                  for _ in range(terms)]).T
    keys = sf.nodes["key"]
    with open(path, "w") as f:
        f.write("gene\t" + "\t".join(
            f"cell cycle term{t}" if t % 2 else f"DNA repair of term{t}"
            for t in range(terms)) + "\n")
        for i in range(n):
            f.write(keys[i] + "\t" + "\t".join(map(str, m[i])) + "\n")
    return str(path)


def test_domain_stage_and_reports(tmp_path):
    ini = _ini(tmp_path / "run.ini")
    psf = SAFE(path_to_ini_file=ini, verbose=False, device="cpu")
    psf.load_network(node_key_attribute="key")
    balls = _ball_attributes(tmp_path / "balls.txt", psf)
    jsf, psf = _sessions(_ini(tmp_path / "run.ini", attributes=balls))
    for sf in (jsf, psf):
        sf.define_neighborhoods()
        sf.compute_pvalues()
        sf.attribute_enrichment_min_size = 5
        sf.define_top_attributes()
        sf.define_domains()
        sf.trim_domains()
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    np.testing.assert_array_equal(psf.attributes["domain"],
                                  jsf.attributes["domain"])
    assert list(psf.domains["label"]) == list(jsf.domains["label"])
    assert len(psf.domains["id"]) >= 3
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), pdir.mkdir()
    jsf.print_output_files(output_dir=str(jdir))
    psf.print_output_files(output_dir=str(pdir))
    assert 0 not in psf.domains["id"]  # dropped in place, as JAX does
    _same_reports(jdir, pdir, REPORTS)
    assert list(psf.nodes) == ["id", "key", "label", "domain", "nes",
                               "num_domains"]


def test_paths_join_under_safe_data(tmp_path):
    data = tmp_path / "data"
    (data / "networks").mkdir(parents=True)
    (data / "attributes").mkdir()
    (data / "networks" / "net.txt").write_text(open(NETWORK).read())
    (data / "attributes" / "attrs.txt").write_text(open(ATTRIBUTES).read())
    ini = tmp_path / "run.ini"
    ini.write_text(f"[Input files]\nsafe_data = {data}/\n"
                   "networkfile = networks/net.txt\n"
                   "annotationfile = attributes/attrs.txt\n"
                   "layoutAlgorithm = spring_tpu\n"
                   "[Analysis parameters]\nrandomSeed = 3\n")
    sf = SAFE(path_to_ini_file=str(ini), verbose=False, device="cpu")
    assert sf.output_dir == str(tmp_path)
    sf.load_network(node_key_attribute="key")
    assert isinstance(sf.graph, NetworkRecord) and sf.graph.num_nodes == 200
    assert sf.graph.nodes["x"].dtype == np.float32  # the device layout
    sf.load_attributes(attribute_file="attributes/attrs.txt")
    assert sf.node2attribute.dtype == np.float32
    assert sf.path_to_attribute_file == str(data / "attributes/attrs.txt")
    sf.load_network(network_file="networks/net.txt", node_key_attribute="key")
    assert sf.path_to_network_file == str(data / "networks/net.txt")
    bare = NetworkRecord(2, [(0, 1)], {"x": np.zeros(2), "y": np.ones(2)})
    with pytest.raises(ValueError, match=r"node key attribute \(key\)"):
        sf.load_network(network_file=bare)
    out = tmp_path / "net.gpickle"
    sf.save_network(output_file=str(out))
    with open(out, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f).edges, sf.graph.edges)


def _scatter(tmp_path, n=300):
    rng = np.random.default_rng(0)
    centers = np.array([[0, 0], [4, 1], [2, 4]])
    assign = rng.integers(0, 3, n)
    coords = centers[assign] + rng.normal(scale=0.7, size=(n, 2))
    path = tmp_path / "embedding.scatter"
    with open(path, "w") as f:
        f.write("key\tx\ty\tlabel\n")
        for i in range(n):
            f.write(f"cell{i}\t{coords[i, 0]:.4f}\t{coords[i, 1]:.4f}\t"
                    f"cell{i}\n")
    attr = pd.DataFrame(
        {f"marker of blob {c}": ((assign == c)
                                 & (rng.random(n) < 0.8)).astype(float)
         for c in range(3)}, index=[f"cell{i}" for i in range(n)])
    return str(path), attr


def test_scatter_connectivity_uses_the_euclidean_pseudo_network(tmp_path):
    """An edgeless scatter input: define_top_attributes counts the enriched
    nodes' components over graph_euclidean, as JAX does (domains.py:49-50),
    not over the network's (empty) edge list."""
    path, attr = _scatter(tmp_path)
    jsf = JaxSAFE(verbose=False)
    psf = SAFE(verbose=False, device="cpu")
    for sf in (jsf, psf):
        sf.load_network(network_file=path, node_key_attribute="key")
        sf.define_neighborhoods(node_distance_metric="euclidean",
                                neighborhood_radius=0.15)
        sf.load_attributes(attribute_file=attr)
        sf.compute_pvalues()
        sf.define_top_attributes(attribute_enrichment_min_size=5)
    assert psf.graph.number_of_edges() == 0
    assert psf.graph_euclidean.edges.tolist() == [
        list(e) for e in jsf.graph_euclidean.edges()]
    np.testing.assert_array_equal(psf.nes_binary, jsf.nes_binary)
    for col in ("top", "num_connected_components",
                "num_large_connected_components"):
        np.testing.assert_array_equal(psf.attributes[col],
                                      jsf.attributes[col], err_msg=col)
    assert np.asarray(psf.attributes["top"]).any()


def test_cli_on_a_quantitative_file(tmp_path):
    g = nx.connected_watts_strogatz_graph(50, 4, 0.2, seed=2)
    net = tmp_path / "net.txt"
    net.write_text("".join(f"g{u}\tg{v}\t1.0\n" for u, v in g.edges()))
    rng = np.random.default_rng(12345)
    attrs = tmp_path / "attrs.txt"
    attrs.write_text("gene\tq1\tq2\n" + "".join(
        f"g{i}\t{rng.normal():.4f}\t{rng.normal():.4f}\n" for i in range(50)))
    ini = _ini(tmp_path / "run.ini", network=net, attributes=attrs, seed=9)
    out = tmp_path / "nes.p"
    assert cli.main([str(attrs), "--ini", ini, "--num-permutations", "50",
                     "--output", str(out), "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        nes = pickle.load(f)
    assert nes.shape == (50, 2) and np.isfinite(nes).all()
    np.testing.assert_array_equal(nes, cli.run_safe_batch(
        str(attrs), ini, 50, device="cpu"))
    # the observed scores are JAX's (the nulls draw from different RNGs)
    jsf = JaxSAFE(path_to_ini_file=ini, verbose=False)
    jsf.load_network()
    jsf.define_neighborhoods()
    jsf.load_attributes(attribute_file=str(attrs))
    jsf.compute_pvalues(num_permutations=50)
    psf = SAFE(path_to_ini_file=ini, verbose=False, device="cpu")
    psf.load_network()
    psf.define_neighborhoods()
    psf.load_attributes(attribute_file=str(attrs))
    psf.compute_pvalues(num_permutations=50)
    np.testing.assert_array_equal(psf.neighborhoods, jsf.neighborhoods)
    np.testing.assert_allclose(psf.ns, jsf.ns, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="A10"):
        cli.main([str(attrs), "--ini", ini, "--mesh", "auto",
                  "--device", "cpu"])
