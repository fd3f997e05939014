"""The plain reference: against scipy and a brute-force null, and against
``safepy_tpu_torch`` on the CPU at tiny sizes, both configurations."""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import dijkstra

from portbench import generators as gen
from portbench.reference import enrichment as enr
from portbench.reference import shortpath_weighted_layout as nbr

CPU = torch.device("cpu")


def test_distances_within_equal_scipy_dijkstra():
    coords, edges, lengths, _ = gen.build_network(300, 9, None, 11)
    r = nbr.radius_of(torch.as_tensor(coords[:, 0]), 0.1)
    d = nbr.distances_within(300, torch.as_tensor(edges),
                             torch.as_tensor(lengths),
                             torch.arange(300), 1.5 * r)
    a = coo_matrix((lengths, tuple(edges.T)), shape=(300, 300))
    want = dijkstra(a.maximum(a.T), directed=False, limit=1.5 * r)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=0)
    assert (d.numpy() <= r).sum() == (want <= r).sum()


def test_block_null_equals_a_loop():
    rng = np.random.default_rng(3)
    n, p = 40, 30
    ind = torch.as_tensor(rng.random((n, n)) < 0.2)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.3] = np.nan
    valid = np.flatnonzero(np.isfinite(x))
    perm = np.stack([rng.permutation(len(valid)) for _ in range(p)])
    obs, absum, cn, cp = enr.block_null(ind, torch.as_tensor(x),
                                        torch.as_tensor(valid),
                                        torch.as_tensor(perm), chunk=7)
    x0 = np.nan_to_num(x)
    a = ind.numpy()
    np.testing.assert_allclose(obs.numpy(), a @ x0, rtol=1e-12)
    np.testing.assert_allclose(absum.numpy(), a @ np.abs(x0), rtol=1e-12)
    for i in range(n):
        null = [sum(x0[valid[perm[q, j]]] for j in range(len(valid))
                    if a[i, valid[j]]) for q in range(p)]
        want_o = sum(x0[j] for j in range(n) if a[i, j])
        assert cn[i] == sum(v <= want_o + 1e-12 for v in null)
        assert cp[i] == sum(v >= want_o - 1e-12 for v in null)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0000001, 1.5 + 3 * 2 ** -11])
    got = enr.to_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0, -3.0,
                         1.5 + 4 * 2 ** -11])
    assert torch.equal(got, want)


def test_nes_binary_rule():
    cn = torch.tensor([9600, 450, 100, 9400, 0])
    cp = torch.tensor([400, 9550, 9900, 600, 10000])
    got = enr.nes_binary(cn, cp, 10000)
    # |log10(cn / cp)| > -log10(0.05), p floored at 1 / P
    assert got.tolist() == [True, True, True, False, True]


def _tiny(cell, nodes, budget=None, mode="auto", perms=300):
    cell.config["network"]["nodes"] = nodes
    if cell.config["network"].get("edge_budget"):
        cell.config["network"]["edge_budget"] = budget or 7 * nodes
    cell.config["settings"]["apsp_mode"] = mode
    cell.traffic["num_permutations"] = perms
    return cell


@pytest.mark.parametrize("workload,nodes,mode,engine", [
    ("costanzo2016.quant10k", 400, "auto", "banded-window"),
    ("genome20k.quant10k", 900, "band", "band-storage")])
def test_reference_equals_the_port_on_the_cpu(root, bench, workload, nodes,
                                              mode, engine):
    from portbench import harness, spec

    cell = _tiny(spec.load_cell(root, workload, bench), nodes, mode=mode)
    inputs = harness.make_inputs(cell, 2 ** 37 + 5, CPU)
    sf = harness.make_session(cell, inputs, CPU)
    client = harness.Client(sf, inputs, cell.kind, CPU, count_launches=False)
    for i in range(3):
        client.analysis(i)
    assert sf.apsp_engine_used == engine and client.failed == 0
    j = cell.kind.Judge(inputs, CPU, block=128)
    agree = j.judge_neighborhoods(sf.neighborhoods_sparse())
    assert agree.all() and j.readings["nbhd_ulps"] == 0.0
    sample = client.sample()
    assert [k for k, _ in sample] == [0, 1, 2]
    for pool_index, outputs in sample:
        j.judge_analysis(pool_index, outputs)
    r = j.readings
    assert r["score_rel"] < 1e-6
    assert r["count_flips_ppm"] < 50 and r["count_max_diff"] <= 2
    assert r["nes_binary_bad"] == 0
