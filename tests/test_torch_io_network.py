"""The port's network loaders against the JAX package's, on fixtures built
as ``tests/test_io.py`` builds them: the port's record must hold the JAX
graph's nodes in its order, its labels and keys, its edges in
``Graph.edges()`` order, its weights and, bitwise, its edge lengths
(float32 arithmetic for float32 coordinates, float64 otherwise).
networkx-free paths are exercised with the layouts JAX would take.
"""

import gzip
import pickle
import zipfile

import networkx as nx
import numpy as np
import pytest
import scipy.io as spio
import scipy.sparse as sp

from safepy_tpu.io import graph_arrays as jax_ga
from safepy_tpu.io import layout as jax_layout
from safepy_tpu.io import network as jax_net
from safepy_tpu_torch.io import edgelist
from safepy_tpu_torch.io import graph_arrays as port_ga
from safepy_tpu_torch.io import layout as port_layout
from safepy_tpu_torch.io import network as port_net
from safepy_tpu_torch.io.record import NetworkRecord, graph_edges


def _same_graph(rec, G, key="key", with_lengths=True):
    """The record holds the networkx graph: node order, node columns,
    edges in order, weights and (bitwise) lengths, and graph_to_arrays
    gives the same arrays."""
    n = G.number_of_nodes()
    assert rec.num_nodes == n and list(G.nodes) == list(range(n))
    for name in ("label", key, "x", "y"):
        want = [G.nodes[i].get(name) for i in range(n)]
        if all(w is None for w in want):
            continue
        got = list(rec.nodes[name])
        assert got == want, name
        assert [type(v) for v in np.asarray(rec.nodes[name])[:1].tolist()] \
            == [type(w) for w in np.asarray(want)[:1].tolist()], name
    assert rec.edges.tolist() == [list(e) for e in G.edges()]
    pc, pe, pl, pw = port_ga.graph_to_arrays(rec)
    jc, je, jl, jw = jax_ga.graph_to_arrays(G)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pw, jw)
    if jc is None:
        assert pc is None
    else:
        np.testing.assert_array_equal(pc, jc)
    if with_lengths:
        assert pl.dtype == jl.dtype == np.float64
        np.testing.assert_array_equal(pl, jl)  # bitwise


def _write(path, lines, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        f.write("".join(lines))


def _knn_lines(n=60, k=4, seed=3):
    """3-column lines of a kNN graph with duplicates, reversed duplicates
    and a self-loop, in a shuffled order."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(size=(n, 2))
    d = np.hypot(*(c[:, None] - c[None]).transpose(2, 0, 1))
    pairs = [(i, int(j)) for i in range(n) for j in np.argsort(d[i])[1:k + 1]]
    pairs += [pairs[5][::-1], pairs[7], (3, 3)]
    order = rng.permutation(len(pairs))
    return [f"g{pairs[i][0]}\tg{pairs[i][1]}\t1.0\n" for i in order]


# the native parser keeps keys as strings, where JAX's Python parser types
# the integer columns of a 5-column file: 5col_int runs in Python only
@pytest.mark.parametrize("form,engine", [
    (form, engine) for form in ("txt", "gz", "tsv", "5col", "5col_int")
    for engine in ("python", "native")
    if not (form == "5col_int" and engine == "native")])
def test_txt_loader_matches_jax(tmp_path, form, engine):
    lines = _knn_lines()
    if form == "tsv":
        path, lines = tmp_path / "net.tsv", ["a\tb\tw\n"] + lines
    elif form == "gz":
        path = tmp_path / "net.txt.gz"
    else:
        path = tmp_path / "net.txt"
    if form.startswith("5col"):
        fmt = ("{}\t{}" if form == "5col_int" else "L{}\tORF{}")
        lines = []
        for line in _knn_lines():
            a, b, w = line.rstrip("\n").split("\t")
            a, b = a[1:], b[1:]
            lines.append(fmt.format(a, a) + "\t" + fmt.format(b, b)
                         + f"\t{w}\n")
    _write(path, lines, gz=(form == "gz"))
    key = "label_orf" if form.startswith("5col") else "key"
    G = jax_net.load_network_from_txt(str(path), layout="spring_embedded",
                                      node_key_attribute=key, seed=7,
                                      verbose=False, engine=engine)
    rec = port_net.load_network_from_txt(str(path), layout="spring_embedded",
                                         node_key_attribute=key, seed=7,
                                         verbose=False, engine=engine,
                                         device="cpu")
    _same_graph(rec, G, key=key)


def test_spring_embedded_energy_path_equals_jax(tmp_path):
    """From 500 nodes networkx lays out by its energy method over a sparse
    adjacency; the record's graph gives it JAX's bits too."""
    path = tmp_path / "net.txt"
    _write(path, _knn_lines(n=700, k=5, seed=4))
    G = jax_net.load_network_from_txt(str(path), layout="spring_embedded",
                                      seed=3, verbose=False)
    rec = port_net.load_network_from_txt(str(path), layout="spring_embedded",
                                         seed=3, verbose=False, device="cpu")
    _same_graph(rec, G)


def test_native_parser_equals_python_parser(tmp_path):
    path = tmp_path / "net.txt"
    _write(path, _knn_lines(n=120, seed=9))
    assert edgelist.parse_edgelist(str(path), 3) is not None  # it builds
    recs = [port_net.load_network_from_txt(
        str(path), layout="spring_tpu", seed=1, verbose=False, engine=e,
        device="cpu") for e in ("native", "python")]
    for name in ("label", "key", "x", "y"):
        np.testing.assert_array_equal(recs[0].nodes[name], recs[1].nodes[name])
    np.testing.assert_array_equal(recs[0].edges, recs[1].edges)
    np.testing.assert_array_equal(recs[0].edge_data["length"],
                                  recs[1].edge_data["length"])


def test_native_build_is_keyed_and_atomic(tmp_path):
    """Ten processes (more than the cores) build into one fresh directory
    at once: the file lock lets one compile, every process gets the same
    library named by the source hash, and no temporary file is left (the
    JAX package's thread lock lets such workers race, ROADMAP)."""
    import os
    import subprocess
    import sys

    build = tmp_path / "build"
    code = ("import sys; from pathlib import Path; "
            "from safepy_tpu_torch.io import edgelist as e; "
            "e.BUILD_DIR = Path(sys.argv[1]); print(e.build())")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=repo, stdout=subprocess.PIPE, text=True)
             for _ in range(10)]
    outs = [p.communicate(timeout=180)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0] * 10
    assert len(set(outs)) == 1
    so = build / os.path.basename(outs[0])
    assert so.exists() and so.name.startswith("libsafepy_edgelist-")
    assert sorted(f.name for f in build.iterdir()) == sorted(
        [so.name, ".edgelist.lock"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_edge_lengths_bitwise_in_the_coordinates_dtype(dtype):
    """JAX computes a length with np.hypot on the coordinates' scalars: in
    float32 for the device layouts' float32 coordinates."""
    n = 40
    G = nx.path_graph(n)
    G.add_edge(3, 17, weight=2.5)
    xy = np.random.default_rng(4).uniform(size=(n, 2)).astype(dtype)
    for i in range(n):
        G.nodes[i].update(x=xy[i, 0], y=xy[i, 1], key=f"k{i}")
    jax_layout.calculate_edge_lengths(G, verbose=False)
    rec = NetworkRecord.from_networkx(G)
    del rec.edge_data["length"]
    assert rec.nodes["x"].dtype == dtype
    port_layout.calculate_edge_lengths(rec, verbose=False)
    _same_graph(rec, G)


def _mat_session(path, adjacency):
    n = adjacency.shape[0]
    layout = {"edges": adjacency,
              "label": np.array([f"gene{i}" for i in range(n)], dtype=object),
              "label_orf": np.array([f"ORF{i}" for i in range(n)],
                                    dtype=object),
              "x": np.random.default_rng(1).uniform(size=n),
              "y": np.random.default_rng(2).uniform(size=n)}
    spio.savemat(path, {"layout": layout})


@pytest.mark.parametrize("form", ["dense", "sparse", "asymmetric"])
def test_mat_loader_matches_jax(tmp_path, form):
    n = 30
    rng = np.random.default_rng(5)
    a = np.zeros((n, n))
    for u, v in rng.integers(0, n, (70, 2)):
        a[u, v] = a[v, u] = rng.integers(1, 4)
    a[4, 4] = 1.5  # a self-loop
    if form == "asymmetric":
        a[2, 9], a[9, 2] = 3.0, 0.5  # networkx keeps the later entry
    adjacency = sp.csc_matrix(a) if form == "sparse" else a
    path = str(tmp_path / "session.mat")
    _mat_session(path, adjacency)
    G = jax_net.load_network_from_mat(path, verbose=False)
    rec = port_net.load_network_from_mat(path, verbose=False)
    _same_graph(rec, G)
    assert rec.edge_data["weight"].max() > 1  # weights carried


def test_gpickle_loader_matches_jax(tmp_path):
    G = nx.path_graph(6)
    for i in G:
        G.nodes[i].update(x=float(i), y=0.5 * i, label=f"n{i}", key=f"n{i}")
    G.add_edge(0, 5, weight=2.0)
    jax_layout.calculate_edge_lengths(G, verbose=False)
    path = str(tmp_path / "g.gpickle")
    with open(path, "wb") as f:
        pickle.dump(G, f)
    rec = port_net.load_network_from_gpickle(path)
    _same_graph(rec, jax_net.load_network_from_gpickle(path))
    # a pickled record loads back as it is
    with open(path, "wb") as f:
        pickle.dump(rec, f)
    again = port_net.load_network_from_gpickle(path)
    np.testing.assert_array_equal(again.edges, rec.edges)


def _make_cys(path):
    """The Cytoscape bundle of tests/test_io.py, plus an unplaced node, an
    isolated placed node, a duplicate edge and a partial table."""
    view = """<?xml version="1.0"?>
<graph xmlns:cy="http://www.cytoscape.org">
  <node label="geneA" cy:nodeId="101"><graphics x="0.0" y="0.0"/></node>
  <node label="geneB" cy:nodeId="102"><graphics x="1.0" y="0.5"/></node>
  <node label="geneC" cy:nodeId="103"><graphics x="0.25" y="1.0"/></node>
  <node label="geneD" cy:nodeId="104"><graphics x="3.0" y="1.0"/></node>
  <node label="geneE" cy:nodeId="105"><graphics x="2.0" y="2.0"/></node>
</graph>"""
    net = """<?xml version="1.0"?>
<graph>
  <edge source="103" target="102"/>
  <edge source="101" target="102"/>
  <edge source="102" target="103"/>
  <edge source="101" target="999"/>
  <edge source="104" target="101"/>
</graph>"""
    cytable = ("SUID,shared name,label_orf\n"
               "SUID,shared name,label_orf\n"
               "101,geneA,ORFA\n102,geneB,ORFB\n103,geneC,ORFC\n")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("session/views/view1.xgmml", view)
        zf.writestr("session/networks/net1.xgmml", net)
        zf.writestr("session/tables/net1/SHARED_ATTRSdef node.cytable",
                    cytable)


def test_cys_loader_matches_jax(tmp_path):
    path = str(tmp_path / "session.cys")
    _make_cys(path)
    G = jax_net.load_network_from_cys(path, verbose=False)
    rec = port_net.load_network_from_cys(path, verbose=False)
    _same_graph(rec, G, key="label_orf")
    assert list(rec.nodes["shared name"]) == [
        G.nodes[i].get("shared name") for i in range(G.number_of_nodes())]


def test_scatter_loader_matches_jax(tmp_path):
    path = str(tmp_path / "emb.scatter")
    with open(path, "w") as f:
        f.write("key\tx\ty\tlabel\n")
        for i in range(6):
            f.write(f"k{i}\t{i}.25\t{i}.5\tlab{i}\n")
        f.write("NA\t7\t8.5\t\n")
    G = jax_net.load_network_from_scatter(path, verbose=False)
    rec = port_net.load_network_from_scatter(path, verbose=False)
    assert rec.num_nodes == G.number_of_nodes() and rec.number_of_edges() == 0
    for name in ("key", "x", "y", "label"):
        got = list(rec.nodes[name])
        want = [G.nodes[i][name] for i in range(rec.num_nodes)]
        assert [str(v) for v in got] == [str(v) for v in want], name
    np.testing.assert_array_equal(port_ga.get_node_coordinates(rec),
                                  jax_ga.get_node_coordinates(G))


def test_graph_edges_is_networkx_order():
    rng = np.random.default_rng(6)
    pairs = rng.integers(0, 25, (200, 2))
    G = nx.Graph()
    G.add_nodes_from(range(25))
    G.add_edges_from(pairs.tolist())
    edges, first, last = graph_edges(pairs, 25)
    assert edges.tolist() == [list(e) for e in G.edges()]
    key = np.minimum(pairs[:, 0], pairs[:, 1]) * 25 + pairs.max(axis=1)
    ek = edges[:, 0] * 25 + edges[:, 1]
    for e, f, l in zip(ek, first, last):
        hits = np.flatnonzero(key == e)
        assert (f, l) == (hits[0], hits[-1])
