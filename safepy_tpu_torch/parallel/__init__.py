"""Multi-device execution over ``torch.distributed`` (SPMD, one process per
device).

Port of ``safepy_tpu/parallel``, so far:

  * :mod:`safepy_tpu_torch.parallel.mesh` -- named DeviceMeshes over the
    default process group;
  * :mod:`safepy_tpu_torch.parallel.band_sharded` -- the row-sharded
    band-storage Floyd-Warshall and its quantitative permutation pipeline.

Not ported yet (ROADMAP A10 remainder): the sharded dense engines
(``apsp_sharded``, ``apsp_sharded_2d``), ``permutation_sharded``,
``hypergeom_sharded`` and the band engine's euclidean and hypergeometric
pipelines.
"""

from safepy_tpu_torch.parallel.mesh import make_mesh, mesh_axis

__all__ = ["make_mesh", "mesh_axis"]
