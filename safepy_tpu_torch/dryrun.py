"""A multi-rank dry run of the sharded pipelines on a tiny network.

Counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:56``): ``dryrun(n_ranks)`` spawns ``n_ranks`` gloo
ranks (SPMD over ``torch.distributed``, a ``file://`` rendezvous in a
temporary directory), on the CPU or all sharing one card, and each runs the
facade through JAX's six legs (``__graft_entry__.py:112-221``) on the same
64-node geometric network, built with numpy:

  1. the quantitative run on a (``row``, ``col``, ``perm``) mesh, or
     (``data``, ``perm``);
  2. the binary stages and the domain stage on (``data``, ``attr``);
  3. the bit-packed band, quantitative, without kept distances, on
     ``data``: its scores equal leg 1's within 1e-5;
  4. band GO on ``data`` (the sharded class table): its indicator equals
     leg 2's exactly;
  5. the bit-packed euclidean band on ``data``;
  6. band GO on ``data`` with the ``shortpath`` metric (the landmark band
     certificate).

Every leg raises on a failed check, which makes ``spawn`` raise;
``python -m safepy_tpu_torch.dryrun 2 [--device cpu]`` exits non-zero on
any failure. The ranks share card 0 unless the caller asks for the CPU.
Imports no jax, pandas or networkx.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_NODES, EDGE_RADIUS, SEED = 64, 0.18, 7


def _network(n=N_NODES, seed=0):
    """(record, coords, quant, binary): JAX's dry-run network as a
    :class:`~safepy_tpu_torch.io.NetworkRecord` (nodes g0..g63, an edge
    below distance 0.18, edge lengths the layout distances) and its two
    attribute matrices, drawn from the same generator in JAX's order."""
    from safepy_tpu_torch.io.graph_arrays import edge_lengths
    from safepy_tpu_torch.io.record import NetworkRecord

    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (n, 2))
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1) ** 0.5
    i, j = np.nonzero(np.triu(d2 < EDGE_RADIUS, k=1))
    edges = np.stack([i, j], axis=1)
    names = np.array([f"g{k}" for k in range(n)], dtype=object)
    record = NetworkRecord(
        n, edges, {"x": coords[:, 0].copy(), "y": coords[:, 1].copy(),
                   "label": names, "key": names.copy()},
        {"weight": np.ones(len(edges)),
         "length": edge_lengths(coords, edges)})
    quant = rng.normal(size=(n, 2))
    quant[rng.random((n, 2)) < 0.2] = np.nan
    left = coords[:, 0] < 0.5
    binary = np.zeros((n, 6))
    binary[left, :3] = rng.random((int(left.sum()), 3)) < 0.8
    binary[~left, 3:] = rng.random((int((~left).sum()), 3)) < 0.8
    return record, coords, quant, binary


def _session(record, vals, device, mesh, **settings):
    from safepy_tpu_torch import SAFE

    sf = SAFE(device=device, verbose=False)
    sf.random_seed = SEED
    for k, v in settings.items():
        setattr(sf, k, v)
    sf.mesh = mesh
    sf.load_network(network_file=record, node_key_attribute="key")
    sf.load_attributes(attribute_file=vals)
    return sf


def _legs(n_ranks: int, device: torch.device) -> dict:
    """The six legs on this rank; returns what the caller may compare."""
    from safepy_tpu_torch.parallel import make_mesh

    dtype = device.type
    record, _, quant, binary = _network()
    n = record.num_nodes
    perms = max(16, 2 * n_ranks)
    a = next(c for c in range(int(n_ranks ** 0.5), 0, -1)
             if n_ranks % c == 0)

    # 1. the quantitative run: 2-D FW over (row, col), or rows over data
    if a >= 2 and (n_ranks // a) % 2 == 0:
        axes = {"row": a, "col": 2, "perm": n_ranks // a // 2}
    else:
        axes = {"data": a, "perm": n_ranks // a}
    sf1 = _session(record, quant, device, make_mesh(axes, device_type=dtype))
    sf1.run_pipeline(num_permutations=perms)
    assert sf1.nes.shape == (n, 2)
    p_sum = sf1.pvalues_neg + sf1.pvalues_pos
    finite = ~np.isnan(p_sum)
    assert (p_sum[finite] >= 1.0 - 1e-9).all()

    # 2. the binary stages over (data, attr), then the domain stage
    sf2 = _session(record, binary, device, make_mesh(
        {"data": a, "attr": n_ranks // a}, device_type=dtype))
    sf2.define_neighborhoods()
    sf2.compute_pvalues()
    assert np.isfinite(sf2.nes).all() and sf2.nes_binary.shape == (n, 6)
    sf2.define_top_attributes(attribute_enrichment_min_size=2)
    if int(np.sum(sf2.attributes["top"])) >= 2:
        sf2.define_domains(attribute_distance_threshold=0.9)
        sf2.trim_domains(attribute_enrichment_min_size=2)
        assert sf2.domains is not None

    data = make_mesh({"data": n_ranks}, device_type=dtype)
    # 3. the bit-packed band, quantitative, no kept distances
    sf3 = _session(record, quant, device, data, apsp_mode="band",
                   keep_node_distances=False, band_indicator_bits=True)
    sf3.run_pipeline(num_permutations=perms)
    assert sf3.apsp_engine_used == "band-storage"
    assert sf3._neighborhoods_dev.data.dtype == torch.uint8
    assert sf3.nes.shape == (n, 2)
    np.testing.assert_allclose(sf3.ns, sf1.ns, rtol=1e-5, atol=1e-5)

    # 4. band GO: the sharded class table
    sf4 = _session(record, binary, device, data, apsp_mode="band")
    sf4.run_pipeline()
    assert sf4._hypergeom_engine_used == "table-band-sharded"
    assert np.isfinite(sf4.nes).all() and sf4.nes_binary.shape == (n, 6)
    np.testing.assert_array_equal(sf4.nes_binary, sf2.nes_binary)

    # 5. the bit-packed euclidean band
    sf5 = _session(record, quant, device, data, apsp_mode="band",
                   keep_node_distances=False, band_indicator_bits=True,
                   neighborhood_radius=0.18)
    sf5.run_pipeline(node_distance_metric="euclidean",
                     num_permutations=perms)
    assert sf5.apsp_engine_used == "band-storage"
    assert sf5._neighborhoods_dev.data.dtype == torch.uint8
    assert sf5.nes.shape == (n, 2)

    # 6. band GO over the hop-count metric (the landmark certificate)
    sf6 = _session(record, binary, device, data, apsp_mode="band",
                   neighborhood_radius=2)
    sf6.run_pipeline(node_distance_metric="shortpath")
    assert sf6.apsp_engine_used == "band-storage"
    assert sf6.nes_binary.shape == (n, 6)

    return dict(mesh1=np.array(list(axes)), ns1=sf1.ns, ns3=sf3.ns,
                ns5=sf5.ns, nes_binary2=sf2.nes_binary,
                nes_binary4=sf4.nes_binary, nes_binary6=sf6.nes_binary,
                engines=np.array([sf4._hypergeom_engine_used,
                                  sf6._hypergeom_engine_used]))


def _rank(rank: int, n_ranks: int, case_dir: str, device_type: str):
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    # gloo for both: every rank may share one card, which NCCL refuses
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(case_dir, "rendezvous"),
        rank=rank, world_size=n_ranks)
    try:
        out = _legs(n_ranks, device)
        np.savez(os.path.join(case_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def dryrun(n_ranks: int, device: str = "cuda") -> list[dict]:
    """Run the six legs on ``n_ranks`` gloo ranks, all on card 0, or on
    the CPU when ``device="cpu"``. Raises if any rank fails a leg; returns
    each rank's results (the legs' scores, indicators and engines)."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun(device='cuda') needs a CUDA device")
    with tempfile.TemporaryDirectory() as case_dir:
        mp.spawn(_rank, args=(int(n_ranks), case_dir, device),
                 nprocs=int(n_ranks), join=True)
        return [dict(np.load(os.path.join(case_dir, f"rank{r}.npz"),
                             allow_pickle=True))
                for r in range(int(n_ranks))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    dryrun(args.n_ranks, args.device)
    print(f"dryrun OK: {args.n_ranks} ranks, six legs, on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
