"""The permutation null sharded over a mesh.

Port of ``safepy_tpu/parallel/permutation_sharded.py``: the permutation
batch splits evenly over every axis of the mesh,
``ceil(P / ndev)`` permutations a rank, rounded up as the reference rounds
to its worker count (reference safe.py:503-504); each rank counts its own
slice and the counts are summed over the mesh with ``all_reduce(SUM)``.

JAX splits one key into a key per device (``jax.random.split``). Here each
rank draws from its own ``torch.Generator``, seeded with
:func:`rank_seed` of the seed the mesh shares (``mesh.shared_seed``) and
the rank's index in the flattened mesh; or it takes its rows of explicit
permutations ``perm_idx`` (total, V), rank r rows [r per_dev, (r + 1)
per_dev), so that tests can give it known indices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from safepy_tpu_torch.parallel.mesh import mesh_axis, shared_seed


def split_index(mesh) -> tuple[int, int]:
    """(ndev, this rank's index) over every axis of the mesh, the first
    axis the most significant (JAX's ``P(axes)`` layout of the key slices,
    ``:58``)."""
    ndev, index = 1, 0
    for a in mesh.mesh_dim_names:
        _, size, local = mesh_axis(mesh, a)
        ndev, index = ndev * size, index * size + local
    return ndev, index


def rank_seed(seed: int, index: int) -> int:
    """The null seed of split ``index``: a 64-bit word of numpy's
    ``SeedSequence(seed, spawn_key=(index,))``, independent of the others
    and reproducible on one device (the replay of a rank's stream)."""
    words = np.random.SeedSequence(int(seed), spawn_key=(int(index),)
                                   ).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def rank_generator(seed: int, mesh, device) -> torch.Generator:
    """This rank's null generator, from the mesh's shared ``seed``."""
    _, index = split_index(mesh)
    return torch.Generator(device=device).manual_seed(rank_seed(seed, index))


def rank_rows(perm_idx, mesh, per_dev: int):
    """This rank's rows of explicit permutations ``perm_idx`` (ndev
    per_dev, V)."""
    ndev, index = split_index(mesh)
    if len(perm_idx) != ndev * per_dev:
        raise ValueError(f"perm_idx has {len(perm_idx)} permutations; a mesh "
                         f"of {ndev} devices takes {per_dev} each "
                         f"({ndev * per_dev})")
    return perm_idx[index * per_dev:(index + 1) * per_dev]


def sum_over(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, in place (one ``all_reduce`` an
    axis: JAX's ``psum``)."""
    for a in mesh.mesh_dim_names:
        group, size, _ = mesh_axis(mesh, a)
        if size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def sharded_counts(nbr_valid, vals, mask, obs, *, mesh,
                   score_type: str, per_device: int, batch_size: int,
                   generator=None, perm_idx=None,
                   precision: str = "highest"):
    """This rank's ``per_device`` permutations counted and summed over the
    mesh (``_sharded_counts`` :20, ``pipeline._sharded_null``):
    ``generator`` is this rank's (:func:`rank_generator`), or ``perm_idx``
    holds every rank's rows (:func:`rank_rows`). Returns int32 (counts_neg,
    counts_pos), the same on every rank."""
    from safepy_tpu_torch.ops.permutation import scan_counts

    if perm_idx is not None:
        perm_idx = rank_rows(perm_idx, mesh, per_device)
    cn, cp = scan_counts(nbr_valid, vals, mask, obs, score_type=score_type,
                         num_permutations=per_device, batch_size=batch_size,
                         generator=generator, perm_idx=perm_idx,
                         precision=precision)
    return sum_over(cn, mesh), sum_over(cp, mesh)


def run_permutations_sharded(neighborhoods, node2attribute, valid_rows, obs,
                             seed=None, *, mesh, score_type: str = "sum",
                             num_permutations: int = 1000,
                             precision: str = "highest", perm_idx=None):
    """Sharded two-sided permutation counts (``:42``).

    Every rank passes the same operands (tensors on its device). ``seed``:
    the null's seed, the same on every rank (None: the mesh's first rank
    draws one and shares it); or ``perm_idx`` (total, V), explicit
    permutations of the valid rows. Returns (counts_neg, counts_pos,
    total) on every rank: ``total`` is ``num_permutations`` rounded up to
    a multiple of the device count; divide the counts by it.
    """
    from safepy_tpu_torch.ops.permutation import (default_batch_size,
                                                  prepare_valid)

    ndev, _ = split_index(mesh)
    per_dev = -(-int(num_permutations) // ndev)
    nbr_valid, vals, mask = prepare_valid(neighborhoods, node2attribute,
                                          valid_rows)
    generator = None
    if perm_idx is None:
        if seed is None:
            seed = shared_seed(int(np.random.default_rng().integers(
                2 ** 31 - 1)), mesh, None, vals.device)
        generator = rank_generator(seed, mesh, vals.device)
    cn, cp = sharded_counts(nbr_valid, vals, mask,
                            torch.as_tensor(obs).to(torch.float32),
                            mesh=mesh, score_type=score_type,
                            per_device=per_dev,
                            batch_size=default_batch_size(*vals.shape,
                                                          per_dev),
                            generator=generator, perm_idx=perm_idx,
                            precision=precision)
    return cn, cp, per_dev * ndev
