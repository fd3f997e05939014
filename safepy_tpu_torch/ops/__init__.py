"""Device core of the port: plain functions on torch tensors.

  * :mod:`.apsp` -- dense APSP entry point (the JAX package's methods and
    defaults), the min-plus product, padding, textbook oracle;
  * :mod:`.apsp_cuda` -- the Floyd-Warshall round on the hand-written CUDA
    min-plus kernels, each beside its plain torch version;
  * :mod:`.apsp_banded` -- the certified banded-window FW of the Example_1
    path, and the host band certificates;
  * :mod:`.apsp_bandstore` -- band storage: the O(N W) skewed band, its FW
    and the banded threshold, contractions and compaction;
  * :mod:`.neighborhoods` -- FW initialization, radius threshold, stats,
    the euclidean distance matrix;
  * :mod:`.score` -- neighborhood scores (sum, z-score);
  * :mod:`.permutation` -- the permutation null;
  * :mod:`.enrich_band` -- scores and the null over band storage;
  * :mod:`.hypergeom` -- the hypergeometric survival function (f64 tail
    loop), host and device finalization;
  * :mod:`.hypergeom_table` -- the class-table survival engine for binary
    annotations;
  * :mod:`.fdr` -- Benjamini-Hochberg correction, linear and in log space.

The package exports the op-level surface of ``safepy_tpu.ops`` (its
``__init__.py:20-39``). As there, ``ops.apsp`` is the function; import
the module's other names with ``from safepy_tpu_torch.ops.apsp import ...``.
Importing these modules builds no kernel.
"""

from safepy_tpu_torch.ops.apsp import apsp, min_plus_product
from safepy_tpu_torch.ops.neighborhoods import (
    euclidean_distance_matrix,
    neighborhoods_from_distances,
)
from safepy_tpu_torch.ops.score import compute_neighborhood_score
from safepy_tpu_torch.ops.permutation import run_permutations
from safepy_tpu_torch.ops.hypergeom import (hypergeom_neglog10_sf,
                                            hypergeom_sf)
from safepy_tpu_torch.ops.fdr import fdr_bh

__all__ = [
    "apsp",
    "min_plus_product",
    "euclidean_distance_matrix",
    "neighborhoods_from_distances",
    "compute_neighborhood_score",
    "run_permutations",
    "hypergeom_sf",
    "hypergeom_neglog10_sf",
    "fdr_bh",
]
