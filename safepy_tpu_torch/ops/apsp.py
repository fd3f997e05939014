"""All-pairs shortest paths as dense min-plus linear algebra, in torch.

Port of ``safepy_tpu/ops/apsp.py``. The graph is a dense (N, N) distance
matrix (inf off-edge, 0 diagonal, edge length on-edge); unreachable pairs stay
``+inf`` and the diagonal stays 0, so every node lies in its own neighborhood.

  * :func:`apsp` -- the public entry, with the JAX package's signature and
    defaults: the blocked Floyd-Warshall of :mod:`.apsp_cuda` (``"auto"``,
    ``"pallas_fw"``; the hand-written CUDA kernels for CUDA tensors, their
    plain torch versions for CPU tensors), repeated min-plus squaring
    (``"pallas_squaring"``), or the textbook one-k-per-step loop (``"jax"``),
    which is the small-size oracle. ``"fw"`` and ``"torch"`` are aliases of
    ``"pallas_fw"`` and ``"jax"``.
  * :func:`min_plus_product` -- one min-plus matrix product.
"""

from __future__ import annotations

import math

import torch

from safepy_tpu_torch.ops._device import on_device


def pad_distances(dist: torch.Tensor, block: int) -> torch.Tensor:
    """Pad an (N, N) distance matrix to a multiple of ``block``
    (``safepy_tpu/ops/apsp.py:31``).

    Padding nodes are unreachable (inf rows and columns) with 0
    self-distance. Returns ``dist`` itself when no padding is needed.
    """
    n = dist.shape[0]
    m = (-n) % block
    if m == 0:
        return dist
    out = torch.full((n + m, n + m), float("inf"), dtype=dist.dtype,
                     device=dist.device)
    out[:n, :n] = dist
    out.diagonal()[n:] = 0.0
    return out


def _apsp_torch(dist: torch.Tensor) -> torch.Tensor:
    """Textbook Floyd-Warshall, one k per step (``apsp.py:49``): the oracle."""
    d = dist.clone()
    for k in range(d.shape[0]):
        # col + row is materialised before the min: the step reads row k and
        # column k as they stood before it, like the jnp fori_loop
        torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    return d


def min_plus_relax(c: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """min(c, a (x) b) via a k-loop (``apsp.py:61``), O(m n) memory.

    The plain version behind every min-plus kernel of :mod:`.apsp_cuda`.
    Returns a new tensor; ``c`` is not modified.
    """
    acc = c.clone()
    for k in range(a.shape[1]):
        torch.minimum(acc, a[:, k:k + 1] + b[k:k + 1, :], out=acc)
    return acc


def _min_plus_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (x) b from an all-+inf accumulator (``_min_plus_jax`` :78), in the
    input dtype: the plain version of the min-plus product kernel."""
    init = torch.full((a.shape[0], b.shape[1]), float("inf"), dtype=a.dtype,
                      device=a.device)
    return min_plus_relax(init, a, b)


def min_plus_product(a: torch.Tensor, b: torch.Tensor, *,
                     method: str = "auto", block: int = 128) -> torch.Tensor:
    """(a (x) b)[i, j] = min_k a[i, k] + b[k, j] (``apsp.py:90``).

    method: ``"auto"`` or ``"pallas"`` (f32 through the min-plus product
    kernel: the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors), or ``"jax"`` / ``"torch"`` (the plain k-loop in the input
    dtype). ``block`` is the JAX tile size, kept for the signature: the CUDA
    kernel pads the ragged edges to its own 64-wide tiles itself.
    """
    a, b = on_device("min_plus_product", a, b)
    if method in ("auto", "pallas"):
        from safepy_tpu_torch.ops.apsp_cuda import minplus_product
        return minplus_product(a.to(torch.float32), b.to(torch.float32))
    if method in ("jax", "torch"):
        return _min_plus_torch(a, b)
    raise ValueError(f"unknown min_plus_product method: {method!r}")


def apsp(dist: torch.Tensor, *, method: str = "auto", block: int = 128,
         max_hops: int | None = None, symmetric: bool = False
         ) -> torch.Tensor:
    """All-pairs shortest-path distances of a dense initialized matrix
    (``apsp.py:100``).

    method: ``"auto"`` or ``"pallas_fw"`` (alias ``"fw"``: blocked
    Floyd-Warshall), ``"pallas_squaring"`` (``ceil(log2(max_hops))``
    min-plus squarings of the padded matrix; ``max_hops`` defaults to N,
    always safe), or ``"jax"`` (alias ``"torch"``: the textbook loop).
    ``symmetric``: the caller guarantees a symmetric ``dist`` (undirected
    graph); the blocked FW then relaxes only each round's upper triangle and
    mirrors it, bitwise equal to the classic round on such inputs. On a
    directed matrix it is wrong, which is why it is off by default.
    Returns (N, N) distances, inf where unreachable: f32, or the input's
    dtype for ``"jax"``.
    """
    dist, = on_device("apsp", dist)
    n = dist.shape[0]
    if method in ("jax", "torch"):
        return _apsp_torch(dist)
    if method in ("auto", "pallas_fw", "fw"):
        from safepy_tpu_torch.ops.apsp_cuda import apsp_blocked_fw
        return apsp_blocked_fw(dist, block=block, symmetric=symmetric)
    if method == "pallas_squaring":
        from safepy_tpu_torch.ops.apsp_cuda import minplus_product
        hops = int(max_hops) if max_hops is not None else n
        n_sq = max(1, math.ceil(math.log2(max(2, hops))))
        d = pad_distances(dist.to(torch.float32), block)
        for _ in range(n_sq):
            d = minplus_product(d, d)
        return d[:n, :n]
    raise ValueError(f"unknown apsp method: {method!r}")
