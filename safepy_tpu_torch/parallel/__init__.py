"""Multi-device execution over ``torch.distributed`` (SPMD, one process per
device).

Port of ``safepy_tpu/parallel``:

  * :mod:`safepy_tpu_torch.parallel.mesh` -- named DeviceMeshes over the
    default process group;
  * :mod:`safepy_tpu_torch.parallel.apsp_sharded` -- the row-sharded dense
    Floyd-Warshall (pivot panels by ``all_reduce(MIN)``);
  * :mod:`safepy_tpu_torch.parallel.apsp_sharded_2d` -- the 2-D
    block-sharded dense Floyd-Warshall over a (``row``, ``col``) mesh;
  * :mod:`safepy_tpu_torch.parallel.permutation_sharded` -- the
    permutation batch split over the mesh, counts summed by
    ``all_reduce(SUM)``;
  * :mod:`safepy_tpu_torch.parallel.hypergeom_sharded` -- the attribute
    columns split over an ``attr`` axis for the census and survival tail;
  * :mod:`safepy_tpu_torch.parallel.band_sharded` -- the row-sharded
    band-storage Floyd-Warshall and its pipelines: the quantitative and
    euclidean permutation pipelines and band GO (the class table and the
    f64 tail loop), the indicator int8 or bit-packed.
"""

from safepy_tpu_torch.parallel.mesh import make_mesh, mesh_axis
from safepy_tpu_torch.parallel.permutation_sharded import (
    run_permutations_sharded)
from safepy_tpu_torch.parallel.apsp_sharded import apsp_sharded
from safepy_tpu_torch.parallel.apsp_sharded_2d import apsp_sharded_2d
from safepy_tpu_torch.parallel.hypergeom_sharded import (
    hypergeom_counts_sharded, hypergeom_enrichment_sharded)

__all__ = [
    "make_mesh",
    "mesh_axis",
    "run_permutations_sharded",
    "apsp_sharded",
    "apsp_sharded_2d",
    "hypergeom_counts_sharded",
    "hypergeom_enrichment_sharded",
]
