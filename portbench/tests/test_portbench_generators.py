"""The frozen generators equal the ones they were copied from."""

from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from portbench import generators as gen
from portbench import traffic


@pytest.mark.parametrize("n,k,budget,seed", [(500, 16, 3000, 5),
                                              (700, 9, None, 7),
                                              (300, 16, None, 2 ** 40 + 3)])
def test_build_network_equals_chip_smoke(n, k, budget, seed):
    want = cs.build_network(n=n, k=k, edge_budget=budget, seed=seed)
    got = gen.build_network(n, k, budget, seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_edge_lengths_equal_the_port_loader():
    from safepy_tpu_torch.io.graph_arrays import edge_lengths

    coords, edges, lengths, weights = gen.build_network(400, 9, None, 3)
    np.testing.assert_array_equal(lengths,
                                  edge_lengths(coords, edges, weights))


@pytest.mark.parametrize("share,fn", [(0.33, cs.build_attribute),
                                      (0.3, cs.build_band_attribute)])
def test_build_attribute_equals_chip_smoke(share, fn):
    np.testing.assert_array_equal(fn(900, seed=4),
                                  gen.build_attribute(900, share, 4))


def test_go_matrix_equals_chip_smoke():
    coords = gen.build_network(800, 9, None, 1)[0]
    sizes = gen.go_sizes_loguniform(40, 3, 300, cs.SEED_GO_A)
    rng = np.random.default_rng(cs.SEED_GO_A)
    want_sizes = np.rint(np.exp(rng.uniform(np.log(3), np.log(300), 40)))
    np.testing.assert_array_equal(sizes, want_sizes)
    np.testing.assert_array_equal(cs.build_go_matrix(coords, sizes, 21),
                                  gen.build_go_matrix(coords, sizes, 21))


def test_pool_shares_one_mask_and_repeats_from_its_seed():
    pool = gen.quantitative_pool(1000, 4, 0.33, 9)
    masks = [np.isnan(x[:, 0]) for x in pool]
    assert all(np.array_equal(masks[0], m) for m in masks)
    assert 0.28 < masks[0].mean() < 0.38
    assert not np.array_equal(pool[0], pool[1], equal_nan=True)
    again = gen.quantitative_pool(1000, 4, 0.33, 9)
    assert all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(pool, again))


def test_seeds_take_large_seeds_and_repeat():
    big = 2 ** 33 + 12345
    a = traffic.seeds(big, 4)
    assert a == traffic.seeds(big, 4)
    assert a != traffic.seeds(big + 1, 4)
    assert all(0 <= s < 2 ** 63 for s in a)


def test_permutations_are_permutations_and_repeat():
    import torch

    cpu = torch.device("cpu")
    p = traffic.permutations(50, 37, 2 ** 35, cpu, chunk=16)
    assert p.shape == (50, 37) and p.dtype == torch.int64
    assert torch.equal(p.sort(dim=1).values,
                       torch.arange(37).expand(50, -1))
    assert torch.equal(p, traffic.permutations(50, 37, 2 ** 35, cpu))


def test_pool_of_several_conditions_shares_the_mask():
    pool = gen.quantitative_pool(500, 3, 0.3, 5, attributes=4)
    assert all(x.shape == (500, 4) for x in pool)
    mask = np.isnan(pool[0])
    assert (mask == mask[:, :1]).all()          # a row is NaN in every column
    assert all(np.array_equal(np.isnan(x), mask) for x in pool)
    # the first column's mask is the one-condition pool's
    one = gen.quantitative_pool(500, 3, 0.3, 5)
    assert np.array_equal(np.isnan(one[0][:, 0]), mask[:, 0])


def test_mix_file_reaches_the_pool(root, bench):
    import torch

    from portbench import spec

    cell = spec.load_cell(root, "costanzo2016.quant10k", bench)
    cell.traffic["num_permutations"] = 20
    net = SimpleNamespace(coords=gen.build_network(300, 16, 2000, 1)[0])
    made = cell.kind.make(cell, net, 7, torch.device("cpu"))
    pool = made["pool"]
    assert len(pool) == cell.traffic["pool"]
    assert pool[0].shape == (300, cell.traffic["attributes"])
    assert np.array_equal(made["valid"],
                          np.flatnonzero(~np.isnan(pool[0][:, 0])))
    assert made["perm"].shape == (20, len(made["valid"]))
    assert traffic.nan_share(cell.traffic, "costanzo2016") == 0.33
    assert traffic.nan_share(cell.traffic, "another") == 0.3
