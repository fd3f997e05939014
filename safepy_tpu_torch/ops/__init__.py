"""Device core of the port: plain functions on torch tensors.

  * :mod:`.apsp` -- dense APSP entry point, padding, textbook oracle;
  * :mod:`.apsp_cuda` -- the Floyd-Warshall round on the hand-written CUDA
    min-plus kernels, each beside its plain torch version;
  * :mod:`.apsp_banded` -- the certified banded-window FW of the Example_1
    path, and the host band certificates;
  * :mod:`.apsp_bandstore` -- band storage: the O(N W) skewed band, its FW
    and the banded threshold, contractions and compaction;
  * :mod:`.neighborhoods` -- FW initialization, radius threshold, stats;
  * :mod:`.score` -- neighborhood scores (sum, z-score);
  * :mod:`.permutation` -- the permutation null;
  * :mod:`.enrich_band` -- scores and the null over band storage.

Importing these modules builds no kernel.
"""
