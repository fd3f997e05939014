"""Device meshes over ``torch.distributed``.

Port of ``safepy_tpu/parallel/mesh.py``. JAX builds a mesh from the devices
one controller sees; torch runs one process per device (SPMD), so a mesh here
is a :class:`torch.distributed.device_mesh.DeviceMesh` with named axes over
the default process group, which the caller initializes first: with
``torchrun``, or with ``torch.distributed.init_process_group`` and a
``file://`` or ``tcp://127.0.0.1:<port>`` rendezvous, its world size and this
process's rank. Each rank then works on one device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def make_mesh(axes: dict[str, int] | None = None,
              device_type: str | None = None):
    """A DeviceMesh over the ranks of the default process group
    (``mesh.py:10``).

    axes: ordered {axis_name: size}; the product must equal the world size.
    Default: every rank on a single 'perm' axis. device_type: "cuda" (the
    default; raises where torch sees no card) or "cpu" (gloo on the host),
    which the caller asks for by name, as ``SAFE(device="cpu")``.
    """
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA device "
                           "and none is available; pass device_type='cpu' "
                           "for a gloo mesh on the host")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group: call torch.distributed.init_process_group "
                           "(or run under torchrun) first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axes is None:
        axes = {"perm": world}
    sizes = tuple(int(s) for s in axes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh axes {axes} do not cover {world} ranks")
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(axes.keys()))


def mesh_names(mesh) -> tuple:
    """The mesh's axis names; () without a mesh."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def fw_sharding(mesh) -> str | None:
    """How ``mesh`` shards the dense Floyd-Warshall (``pipeline.py:43-84``,
    ``safe.py:488-531``): ``'2d'`` over ``row`` and ``col`` axes, else
    ``'data'`` over a ``data`` axis, else None (one device)."""
    names = mesh_names(mesh)
    if "row" in names and "col" in names:
        return "2d"
    return "data" if "data" in names else None


def mesh_axis(mesh, axis: str = "data"):
    """(process group, size, this rank's index) of a named mesh axis."""
    names = mesh_names(mesh)
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis: {names}")
    return (mesh.get_group(axis), mesh.size(names.index(axis)),
            mesh.get_local_rank(axis))


def shared_seed(seed: int, mesh, axis: str | None, device) -> int:
    """The first rank's ``seed`` of a mesh axis (``axis=None``: of the whole
    mesh), on every rank of it.

    The JAX facade draws a fresh null seed once, in its single controller
    (``safe.py:2055-2058``); under SPMD every rank draws its own, so the
    first rank's is broadcast (a tensor on ``device``, as NCCL needs); over
    the whole mesh, axis by axis."""
    axes = (tuple(mesh.mesh_dim_names) if axis is None else (axis,))
    t = torch.tensor([int(seed)], dtype=torch.int64, device=device)
    for a in axes:
        group, _, _ = mesh_axis(mesh, a)
        dist.broadcast(t, src=dist.get_process_group_ranks(group)[0],
                       group=group)
    return int(t.item())
