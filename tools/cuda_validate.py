"""End-to-end validation battery of the PyTorch/CUDA port.

Modelled on tools/tpu_validate.py, through ``safepy_tpu_torch`` on one
device (the card by default):

1. a synthetic geometric graph (500 nodes, 8 nearest neighbours) and its
   dense initialization;
2. ``ops.apsp`` (the blocked FW on the CUDA kernels) against scipy's
   Dijkstra;
3. ``ops.hypergeom_sf`` against ``scipy.stats.hypergeom.sf`` (1e-9);
4. the permutation null: counts_neg + counts_pos >= P wherever a score
   exists;
5. the facade from files: a .txt network (laid out on the device by
   ``spring_tpu``) and a tab-separated attribute table, read without
   pandas, through ``run_pipeline``;
6. the band-storage engine forced at this scale: neighborhoods equal to
   the dense engine's, scores within f32 noise.

Prints ``VERIFY OK`` on success and raises otherwise. Run from the repo
root: ``python3 tools/cuda_validate.py [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path
from scipy.spatial import cKDTree
from scipy.stats import hypergeom as sp_hypergeom

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from safepy_tpu_torch import SAFE, ops  # noqa: E402
from safepy_tpu_torch.ops import permutation  # noqa: E402
from safepy_tpu_torch.ops.neighborhoods import (  # noqa: E402
    dense_initial_distances)


def validate(device="cuda", n=500, num_permutations=1000) -> str:
    """Run the six steps on ``device``; return ``"VERIFY OK"``."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # 1. the graph
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=8)
    edges = np.array(sorted({(min(i, int(j)), max(i, int(j)))
                             for i in range(n) for j in nn[i, 1:]}))
    w = np.hypot(*(coords[edges[:, 0]] - coords[edges[:, 1]]).T)
    d0 = dense_initial_distances(n, edges, w)

    # 2. APSP against scipy
    a = coo_matrix((w, tuple(edges.T)), shape=(n, n))
    ref = shortest_path(a.maximum(a.T), method="D", directed=False)
    t0 = time.perf_counter()
    dist = ops.apsp(torch.as_tensor(d0, device=dev)).cpu().numpy()
    print("APSP wall (build included):",
          round(time.perf_counter() - t0, 2), "s", flush=True)
    finite = np.isfinite(ref)
    err = float(np.abs(dist[finite] - ref[finite]).max())
    print("APSP max err:", err, flush=True)
    assert err < 1e-5 and np.array_equal(np.isfinite(dist), finite)

    # 3. the hypergeometric survival against scipy
    M, K = 400, 37
    k = rng.integers(0, 30, (64, 16)).astype(np.float64)
    m = rng.integers(30, 200, (64, 1)).astype(np.float64)
    p = ops.hypergeom_sf(torch.as_tensor(k, device=dev), M,
                         torch.full((1, 16), float(K), device=dev),
                         torch.as_tensor(m, device=dev))
    perr = float(np.abs(p - sp_hypergeom.sf(k - 1, M, K, m)).max())
    print("hypergeom p-err:", perr, flush=True)
    assert perr < 1e-9

    # 4. the permutation null
    n2a = rng.normal(size=(n, 3))
    n2a[rng.random(n) < 0.3, 0] = np.nan
    nbr = torch.as_tensor((dist < 0.25).astype(np.float32), device=dev)
    n2a_dev = torch.as_tensor(n2a, dtype=torch.float32, device=dev)
    valid = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
    obs = ops.compute_neighborhood_score(nbr, n2a_dev, "sum")
    t0 = time.perf_counter()
    cn, cp = permutation.run_permutations(
        nbr, n2a_dev, torch.as_tensor(valid, device=dev), obs,
        generator=torch.Generator(device=dev).manual_seed(0),
        score_type="sum", num_permutations=num_permutations)
    sync()
    print(f"{num_permutations} perms wall:",
          round(time.perf_counter() - t0, 2), "s", flush=True)
    ok = ~torch.isnan(obs)
    assert bool(((cn + cp)[ok] >= num_permutations).all())
    print("perm counts sane", flush=True)

    # 5. the facade from a .txt network and an attribute table
    with tempfile.TemporaryDirectory() as tmp:
        netf = os.path.join(tmp, "net.txt")
        with open(netf, "w") as f:
            f.writelines(f"g{u}\tg{v}\t1.0\n" for u, v in edges)
        attrf = os.path.join(tmp, "attr.txt")
        q = rng.normal(size=n)
        with open(attrf, "w") as f:
            f.write("key\tq\n")
            f.writelines(f"g{i}\t{float(q[i])!r}\n" for i in range(n))

        def session(**settings):
            sf = SAFE(verbose=False, device=dev)
            sf.layout_algorithm = "spring_tpu"
            sf.random_seed = 11
            for name, value in settings.items():
                setattr(sf, name, value)
            sf.load_network(network_file=netf, node_key_attribute="key")
            sf.load_attributes(attribute_file=attrf)
            return sf

        sf = session()
        t0 = time.perf_counter()
        sf.run_pipeline(num_permutations=num_permutations // 2)
        print("facade e2e wall:", round(time.perf_counter() - t0, 2),
              "s; enriched:", int(sf.nes_binary.sum()), flush=True)
        assert sf.nes.shape == (n, 1) and np.isfinite(sf.nes).any()

        # 6. the band-storage engine against the dense one
        sf_band = session(apsp_mode="band")
        t0 = time.perf_counter()
        sf_band.run_pipeline(num_permutations=num_permutations // 2)
    band_err = float(np.nanmax(np.abs(sf_band.ns - sf.ns)))
    print("band engine wall:", round(time.perf_counter() - t0, 2),
          "s; ns err:", band_err, flush=True)
    assert sf_band.apsp_engine_used == "band-storage"
    assert np.array_equal(sf_band.neighborhoods, sf.neighborhoods)
    assert band_err <= 1e-4
    print("VERIFY OK", flush=True)
    return "VERIFY OK"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    validate(args.device)


if __name__ == "__main__":
    main()
