"""The port's device spring layouts against the JAX package's, on the CPU.

- After a few iterations the coordinates agree elementwise: the dense
  force engine after 3 iterations within 2e-5 and the exact energy engine
  after 5 within 1e-5 (measured 1.3e-5 and 7e-7 at 200 nodes; the two
  packages' float32 reductions round differently, and every step moves a
  node by the temperature along its force, so the difference grows with
  the iterations, to order 1 after 100 force iterations).
- At full length (100 force iterations, 1,000 Adam steps) they are held by
  the neighborhood-preservation statistic of tests/test_layout_quality.py:
  the port's within 0.03 of JAX's on the same graph and seed (measured
  differences up to 0.016), for the dense and tiled force engines and the
  exact and sampled energy engines (the tiled force engine's means over
  three seeds). The sampled engines draw from a torch.Generator where JAX
  draws from jax.random.
- The dispatch is JAX's, ``spring_embedded`` and ``kamada_kawai`` equal
  JAX's networkx layouts bit for bit, and without networkx they raise
  naming ``spring_tpu``.
"""

import sys

import networkx as nx
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from safepy_tpu.io import layout as J
from safepy_tpu_torch.io import layout as P
from safepy_tpu_torch.io.record import NetworkRecord

MARGIN = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geometric(n, k=6, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    return np.asarray(sorted({(min(i, int(j)), max(i, int(j)))
                              for i in range(n) for j in nn[i, 1:]}), np.int64)


def _preservation(coords, edges, L=15):
    coords = np.asarray(coords, np.float64)
    _, nn = cKDTree(coords).query(coords, k=L + 1)
    nbr = [set(map(int, row[1:])) for row in nn]
    return sum(1 for u, v in edges
               if int(v) in nbr[u] or int(u) in nbr[v]) / len(edges)


def _graphs(n, seed):
    edges = _geometric(n, seed=seed)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges.tolist())
    return edges, g, NetworkRecord(n, edges)


def test_dense_force_engine_few_iterations():
    n = 200
    edges = _geometric(n)
    want = J._spring_dense(n, edges, k=0.2, iterations=3, seed=4)
    got = P._spring_dense(n, edges, k=0.2, iterations=3, seed=4,
                          device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_exact_energy_engine_few_iterations():
    n = 200
    edges = _geometric(n)
    want = J.spring_layout_energy_tpu(n, edges, k=0.2, iterations=5, seed=4)
    got = P.spring_layout_energy_device(n, edges, k=0.2, iterations=5,
                                        seed=4, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["force", "energy"])
def test_auto_engines_full_length_preservation(engine):
    """'auto': the dense force engine below 500 nodes, the exact energy
    engine at 500 and above."""
    n = 450 if engine == "force" else 520
    edges, g, rec = _graphs(n, seed=7)
    pos = J.spring_layout_tpu(g, seed=5)
    want = _preservation(np.array([pos[i] for i in range(n)]), edges)
    got = _preservation(P.spring_layout_device(rec, seed=5, device="cpu"),
                        edges)
    assert abs(got - want) <= MARGIN, (got, want)
    assert got > 0.5


def test_tiled_force_engine_preservation(monkeypatch):
    """Above DENSE_LAYOUT_MAX_NODES the force engine goes tiled. Its 128
    repulsors a round make the statistic vary by ~0.06 from seed to seed
    in either package, so the means over three seeds are held."""
    n = 450
    edges, g, rec = _graphs(n, seed=8)
    seeds = (0, 4, 5)
    want = np.mean([_preservation(J.spring_layout_tpu_tiled(
        n, edges, seed=s, repulsors=128), edges) for s in seeds])
    calls = []
    orig = P.spring_layout_device_tiled

    def spy(*args, **kw):
        calls.append(kw)
        return orig(*args, **dict(kw, repulsors=128))

    monkeypatch.setattr(P, "DENSE_LAYOUT_MAX_NODES", 100)
    monkeypatch.setattr(P, "spring_layout_device_tiled", spy)
    got = np.mean([_preservation(P.spring_layout_device(
        rec, seed=s, device="cpu"), edges) for s in seeds])
    assert len(calls) == len(seeds)
    assert abs(got - want) <= MARGIN, (got, want)


def test_sampled_energy_engine_preservation():
    """Above exact_max_nodes the energy engine samples its repulsors."""
    n = 520
    edges, _, _ = _graphs(n, seed=9)
    kw = dict(k=0.2, iterations=1000, seed=5, exact_max_nodes=100,
              repulsors=256)
    want = _preservation(J.spring_layout_energy_tpu(n, edges, **kw), edges)
    got = _preservation(P.spring_layout_energy_device(n, edges, device="cpu",
                                                      **kw), edges)
    assert abs(got - want) <= MARGIN, (got, want)
    # seeded: the same draws again
    short = dict(kw, iterations=20)
    np.testing.assert_array_equal(
        P.spring_layout_energy_device(n, edges, device="cpu", **short),
        P.spring_layout_energy_device(n, edges, device="cpu", **short))


@pytest.mark.parametrize("layout", ["spring_embedded", "kamada_kawai"])
def test_networkx_layouts_equal_jax(layout):
    edges, g, rec = _graphs(60, seed=3)
    J.apply_network_layout(g, layout=layout, seed=11, verbose=False)
    P.apply_network_layout(rec, layout=layout, seed=11, verbose=False)
    np.testing.assert_array_equal(rec.nodes["x"], [g.nodes[i]["x"]
                                                   for i in range(60)])
    np.testing.assert_array_equal(rec.nodes["y"], [g.nodes[i]["y"]
                                                   for i in range(60)])


@pytest.mark.parametrize("layout", ["spring_embedded", "kamada_kawai"])
def test_networkx_layouts_raise_without_networkx(monkeypatch, layout):
    monkeypatch.setitem(sys.modules, "networkx", None)
    rec = NetworkRecord(3, [(0, 1), (1, 2)])
    with pytest.raises(ImportError, match="spring_tpu"):
        P.apply_network_layout(rec, layout=layout, seed=1, verbose=False)
    assert "x" not in rec.nodes  # no other engine was taken
