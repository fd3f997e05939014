"""The port's multi-rank dry run (safepy_tpu_torch/dryrun.py) on two gloo
ranks on the CPU: its six legs pass on every rank, and the cross-leg
equalities hold (the packed band's scores within 1e-5 of the dense mesh
run's, the sharded band GO indicator exactly the attribute-sharded
stages'). The port's counterpart of
tests/test_graft.py::test_dryrun_multichip_2."""

import numpy as np

from safepy_tpu_torch import dryrun


def test_dryrun_two_ranks():
    ranks = dryrun.dryrun(2, device="cpu")
    assert len(ranks) == 2
    for r in ranks:
        assert list(r["mesh1"]) == ["data", "perm"]
        np.testing.assert_allclose(r["ns3"], r["ns1"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["nes_binary4"], r["nes_binary2"])
        assert list(r["engines"]) == ["table-band-sharded"] * 2
        assert r["nes_binary6"].shape == (dryrun.N_NODES, 6)
        assert np.isfinite(r["ns5"]).any()
    for key in ("ns1", "ns3", "ns5", "nes_binary2", "nes_binary4",
                "nes_binary6"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
