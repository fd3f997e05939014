"""Network layouts and the edge lengths derived from them.

Port of ``safepy_tpu/io/layout.py``:

- ``spring_embedded`` (networkx ``spring_layout(G, k=0.2, iterations=100,
  seed=seed)``) and ``kamada_kawai`` go through networkx, imported when
  called, so that a seeded layout equals the JAX package's bit for bit;
  where networkx is missing they raise an ``ImportError`` that names the
  device engine, and never take another engine quietly;
- ``spring_tpu`` (the INI value user files carry) runs the spring layouts
  of this module as torch code on the session's device: the force
  iteration dense (:func:`_spring_dense`, JAX ``:92``) up to
  :data:`DENSE_LAYOUT_MAX_NODES` and tiled with sampled repulsors above
  (:func:`spring_layout_device_tiled`, JAX ``spring_layout_tpu_tiled``
  ``:127``), and the Adam energy minimizer (:func:`spring_layout_energy_device`,
  JAX ``spring_layout_energy_tpu`` ``:186``), exact up to 4,096 nodes and
  with sampled repulsors above; :func:`spring_layout_device` (JAX
  ``spring_layout_tpu`` ``:55``) chooses among them;
- edge length = the layout distance of the endpoints times the edge weight
  (:func:`calculate_edge_lengths`, JAX ``:286``), in the coordinates' own
  dtype: the device layouts give float32 coordinates, whose lengths JAX
  computes in float32 (``np.hypot`` of ``np.float32`` scalars).

The device engines start from JAX's numpy draw (``default_rng(seed)``);
the sampled ones draw their repulsors from a ``torch.Generator`` seeded from
the same numpy stream where JAX seeds ``jax.random``, which torch cannot
reproduce: they agree with JAX in distribution, not in bits. Every sum over
edges or components is a deterministic segment sum (:func:`_segment_sum`),
so a seeded layout is the same from run to run on the card too. Each
returns (N, 2) float32 coordinates as a numpy array.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

# above this many nodes the dense (N, N) force matrix stops paying and the
# force engine goes tiled (layout.py:52)
DENSE_LAYOUT_MAX_NODES = 8192


def apply_network_layout(graph, layout: str = "kamada_kawai", seed=None,
                         verbose: bool = True, device="cuda"):
    """Compute the node coordinates of a :class:`NetworkRecord` and store
    them as its ``x`` / ``y`` columns (``layout.py:25``)."""
    if layout in ("kamada_kawai", "spring_embedded"):
        try:
            import networkx as nx
        except ImportError as e:
            raise ImportError(
                f"layout {layout!r} needs networkx, which is not installed; "
                "set layoutAlgorithm = spring_tpu (the device spring layout) "
                "instead") from e
        G = nx.Graph()
        G.add_nodes_from(range(graph.num_nodes))
        G.add_edges_from(graph.edges.tolist())
        if layout == "kamada_kawai":
            if verbose:
                logging.info("Applying the Kamada-Kawai network layout... "
                             "(may take several minutes)")
            pos = nx.kamada_kawai_layout(G)
        else:
            if verbose:
                logging.info("Applying the spring-embedded network layout... "
                             "(may take several minutes)")
            pos = nx.spring_layout(G, k=0.2, iterations=100, seed=seed)
        coords = np.array([pos[i] for i in range(graph.num_nodes)])
    elif layout == "spring_tpu":
        if verbose:
            logging.info("Applying the device spring-embedded network "
                         "layout...")
        coords = spring_layout_device(graph, k=0.2, iterations=100,
                                      seed=seed, device=device)
    else:
        raise ValueError(f"unknown layout: {layout!r}")
    graph.nodes["x"] = coords[:, 0].copy()
    graph.nodes["y"] = coords[:, 1].copy()
    return graph


def spring_layout_device(graph, k: float = 0.2, iterations: int = 100,
                         seed=None, method: str = "auto", device="cuda"):
    """The device spring layout of a :class:`NetworkRecord` as (N, 2)
    float32 coordinates in node order (JAX returns a dict by node), with
    networkx's method choice (``layout.py:55-89``): ``'auto'`` takes the
    force iteration below 500 nodes and the energy minimizer at 500 and
    above (for ``10 x iterations`` Adam steps); the force iteration is
    dense up to :data:`DENSE_LAYOUT_MAX_NODES` and tiled above."""
    n, edges = graph.num_nodes, graph.edges
    if method == "auto":
        method = "force" if n < 500 else "energy"
    if method == "energy":
        return spring_layout_energy_device(n, edges, k=k,
                                           iterations=10 * iterations,
                                           seed=seed, device=device)
    if n > DENSE_LAYOUT_MAX_NODES:
        return spring_layout_device_tiled(n, edges, k=k,
                                          iterations=iterations, seed=seed,
                                          device=device)
    return _spring_dense(n, edges, k=k, iterations=iterations, seed=seed,
                         device=device)


def _start(n, seed):
    """JAX's start: uniform [0, 1)^2 from ``default_rng(seed)``, float32,
    and the generator for the seed of the sampled repulsors."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32), rng


def _segments(index, n, device):
    """The plan of :func:`_segment_sum` over ``index`` (M,) into n rows:
    the stable order that groups the rows, and each row's group bounds."""
    index = np.asarray(index, np.int64)
    order = np.argsort(index, kind="stable")
    ends = np.cumsum(np.bincount(index, minlength=n))
    starts = ends - np.bincount(index, minlength=n)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (order, starts, ends))


def _segment_sum(values, segments):
    """Row i: the sum of the (M, k) ``values`` whose index is i, from
    differences of a float64 prefix sum, rounded once to the values' dtype.
    The scatter-add of JAX (``.at[idx].add``) written so that it is
    deterministic on the card, where ``index_add`` accumulates with atomics
    in no fixed order, and a seeded layout would change from run to run."""
    order, starts, ends = segments
    # scan along the contiguous axis: a scan down the (M, k) columns runs
    # one thread a column on the card, M steps long
    cs = torch.cumsum(values[order].double().t().contiguous(), dim=1)
    cs = torch.cat([cs.new_zeros((cs.shape[0], 1)), cs], dim=1)
    return (cs[:, ends] - cs[:, starts]).t().to(values.dtype)


def _move(pos, disp, t):
    """networkx's movement rule: every node moves exactly the temperature
    ``t`` (a 0-d tensor) along its net force (a 0.1 floor under tiny
    forces). A 0-d tensor over a tensor divides; a Python number over a
    tensor would multiply by the reciprocal, rounding twice."""
    length = torch.sqrt(torch.sum(disp * disp, dim=-1))
    length = torch.where(length < 0.01, torch.full_like(length, 0.1), length)
    return pos + disp * (t / length)[:, None]


def _temperatures(iterations, device):
    """The force iteration's cooling t0 - i dt, rounded to float32 as JAX
    rounds its weak scalar, uploaded once (a scalar made on the card every
    round would synchronise the host with it)."""
    t0 = 0.1
    dt = t0 / (iterations + 1)
    return torch.tensor([t0 - i * dt for i in range(iterations)],
                        dtype=torch.float32, device=device)


def _differences(pos, reps):
    """(dx, dy): the (N, M) coordinate differences of every node and every
    repulsor, as two planes (the (N, M, 2) form of JAX reduces over a
    trailing axis of 2, which the card does slowly)."""
    x, y = pos[:, 0].contiguous(), pos[:, 1].contiguous()
    rx, ry = (x, y) if reps is None else (x[reps], y[reps])
    return x[:, None] - rx[None, :], y[:, None] - ry[None, :]


@torch.no_grad()
def _spring_dense(n, edges, *, k, iterations, seed, device="cuda"):
    """Fruchterman-Reingold force iteration over the dense (N, N) forces,
    the temperature cooling linearly from 0.1 (``layout.py:92-124``)."""
    device = torch.device(device)
    pos0, _ = _start(n, seed)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    u = torch.as_tensor(edges[:, 0], device=device)
    v = torch.as_tensor(edges[:, 1], device=device)
    a[u, v] = 1.0
    a[v, u] = 1.0
    pos = torch.as_tensor(pos0, device=device)
    kk = torch.tensor(k * k, dtype=torch.float32, device=device)
    temps = _temperatures(iterations, device)
    for i in range(iterations):
        dx, dy = _differences(pos, None)
        dist = torch.clamp_min(torch.sqrt(dx * dx + dy * dy), 0.01)
        force = (kk / (dist * dist)) - a * dist / k
        disp = torch.stack([(dx * force).sum(dim=1),
                            (dy * force).sum(dim=1)], dim=1)
        pos = _move(pos, disp, temps[i])
    return pos.cpu().numpy()


@torch.no_grad()
def spring_layout_device_tiled(n, edges, *, k: float = 0.2,
                               iterations: int = 100, seed=None,
                               repulsors: int = 512, device="cuda"):
    """O(N M) force iteration for band-scale networks
    (``layout.py:127-183``): exact attraction over the edge list, and an
    unbiased estimate of the repulsion from ``repulsors`` nodes drawn each
    iteration, scaled by N / M. Same cooling and movement as the dense
    engine."""
    device = torch.device(device)
    pos0, rng = _start(n, seed)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 31 - 1)))
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    u = torch.as_tensor(edges[:, 0], device=device)
    v = torch.as_tensor(edges[:, 1], device=device)
    by_node = _segments(np.concatenate([edges[:, 0], edges[:, 1]]), n, device)
    pos = torch.as_tensor(pos0, device=device)
    temps = _temperatures(iterations, device)
    m = int(min(repulsors, n))
    push = n / m * k * k
    for i in range(iterations):
        idx = torch.randint(0, n, (m,), generator=gen, device=device)
        dx, dy = _differences(pos, idx)
        d2 = torch.clamp_min(dx * dx + dy * dy, 0.01 ** 2)
        disp = push * torch.stack([(dx / d2).sum(dim=1),
                                   (dy / d2).sum(dim=1)], dim=1)
        de = pos[u] - pos[v]
        dist_e = torch.sqrt(torch.clamp_min(torch.sum(de * de, dim=-1),
                                            0.01 ** 2))
        pull = de * (dist_e / k)[:, None]
        disp = disp + _segment_sum(torch.cat([-pull, pull]), by_node)
        pos = _move(pos, disp, temps[i])
    return pos.cpu().numpy()


@torch.no_grad()
def spring_layout_energy_device(n, edges, *, k: float | None = None,
                                iterations: int = 500, seed=None,
                                repulsors: int = 2048, gravity: float = 1.0,
                                weights=None, exact_max_nodes: int = 4096,
                                device="cuda"):
    """networkx's energy spring layout (``layout.py:186-283``): the
    gradient of the integrated Fruchterman-Reingold energy

        grad_i = 2 sum_j (A_ij d_ij / k - k^2 / d_ij^2) (x_i - x_j)
                 + gravity toward (0.5, 0.5) per connected component

    minimized with Adam under a cosine step decay; the repulsion is exact
    over all pairs up to ``exact_max_nodes`` and an unbiased estimate from
    ``repulsors`` sampled nodes above, the attraction exact over the edge
    list."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    device = torch.device(device)
    if k is None:
        k = float(np.sqrt(1.0 / max(1, n)))
    pos0, rng = _start(n, seed)
    seed1 = int(rng.integers(2 ** 31 - 1))
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    w = (np.ones(len(edges), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    u = torch.as_tensor(edges[:, 0], device=device)
    v = torch.as_tensor(edges[:, 1], device=device)
    we = torch.as_tensor(w, device=device)
    g = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    ncomp, labels = connected_components(g, directed=False)
    labels_dev = torch.as_tensor(labels, dtype=torch.int64, device=device)
    comps = _segments(labels, ncomp, device)
    by_node = _segments(np.concatenate([edges[:, 0], edges[:, 1]]), n, device)
    sizes = torch.as_tensor(np.bincount(labels, minlength=ncomp),
                            dtype=torch.float32, device=device)

    exact = n <= exact_max_nodes
    m = n if exact else int(min(repulsors, n))
    push = -2.0 * (n / m) * k * k
    # the exact path draws nothing (JAX splits a key it never uses)
    gen = None if exact else torch.Generator(device=device).manual_seed(seed1)

    def grad_fn(pos):
        idx = None if exact else torch.randint(0, n, (m,), generator=gen,
                                               device=device)
        dx, dy = _differences(pos, idx)
        d2 = torch.clamp_min(dx * dx + dy * dy, 1e-10)
        grad = push * torch.stack([(dx / d2).sum(dim=1),
                                   (dy / d2).sum(dim=1)], dim=1)
        de = pos[u] - pos[v]
        dist_e = torch.sqrt(torch.clamp_min(torch.sum(de * de, dim=-1),
                                            1e-10))
        pull = de * (2.0 * we * dist_e / k)[:, None]
        grad = grad + _segment_sum(torch.cat([pull, -pull]), by_node)
        centers = _segment_sum(pos, comps)
        delta0 = centers / sizes[:, None] - 0.5
        return grad + gravity * delta0[labels_dev]

    lr0 = 0.05
    b1, b2, eps = 0.9, 0.999, 1e-8
    pos = torch.as_tensor(pos0, device=device)
    mom = torch.zeros_like(pos)
    vel = torch.zeros_like(pos)
    # Adam's bias corrections 1 - b^t for every step, in float32 as JAX
    # computes them, uploaded once
    steps = torch.arange(1, iterations + 1, dtype=torch.float32,
                         device=device)
    corr1 = 1 - torch.tensor(b1, dtype=torch.float32, device=device) ** steps
    corr2 = 1 - torch.tensor(b2, dtype=torch.float32, device=device) ** steps
    for i in range(iterations):
        gr = grad_fn(pos)
        mom = b1 * mom + (1 - b1) * gr
        vel = b2 * vel + (1 - b2) * gr * gr
        mhat = mom / corr1[i]
        vhat = vel / corr2[i]
        lr = lr0 * 0.5 * (1 + math.cos(math.pi * i / iterations))
        pos = pos - lr * mhat / (torch.sqrt(vhat) + eps)
    return pos.cpu().numpy()


def calculate_edge_lengths(graph, verbose: bool = True):
    """Layout distance x edge weight into the record's ``length`` column
    (``layout.py:286-304``): ``hypot`` of the coordinate differences in the
    coordinates' dtype (float32 for the device layouts, as JAX computes it
    on ``np.float32`` scalars), then times the float64 weight."""
    if verbose:
        logging.info("Calculating edge lengths...")
    x = np.asarray(graph.nodes["x"])
    y = np.asarray(graph.nodes["y"])
    u, v = graph.edges[:, 0], graph.edges[:, 1]
    dist = np.hypot(x[u] - x[v], y[u] - y[v])
    graph.edge_data["length"] = (np.asarray(dist, np.float64)
                                 * graph.edge_data["weight"])
    return graph
