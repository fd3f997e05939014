"""The comparison that decides ``correct``, in the parts every kind of
analysis shares: the limits of a cell (``limits/<workload>.json``), the
reference's neighborhoods and their number, and the verdict.

A kind (``kinds/<kind>.py``) names its numbers (``NUMBERS``) and reads all
but this one; every kind compares the neighborhoods:

- ``nbhd_ulps``: of the neighborhood cells where the program's indicator
  differs from the reference's, the largest distance of the reference's
  path length from the radius, in f32 ulps of the radius (0 when none
  differ). A sound f32 FW differs only at cells on the radius.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import spec

# a differing cell farther from the radius than this share of it reads as
# this far (its path is not followed further)
FAR = 0.5


def load_limits(root: Path, workload: str, numbers) -> dict:
    """The limits of a cell, ``limits/<workload>.json`` under the
    benchmark's folder, one for each of the kind's ``numbers``; a cell
    without them cannot be judged."""
    path = root / "portbench" / "limits" / f"{workload}.json"
    with open(path) as f:
        limits = json.load(f)["limits"]
    missing = [k for k in numbers if k not in limits]
    if missing:
        raise ValueError(f"{path} lacks limits for {missing}")
    return {k: limits[k] for k in numbers}


def f32_ulp(x: float) -> float:
    return float(np.spacing(np.float32(x)))


class Neighborhoods:
    """The reference's neighborhoods of a network on one device, under the
    configuration's metric (``reference/<node_distance_metric>.py``).
    ``lowered``: distances in bfloat16 (the control)."""

    def __init__(self, inputs, device, *, lowered: bool = False,
                 block: int = 512):
        self.net = inputs.network
        self.metric = spec.module(
            "reference", inputs.settings["node_distance_metric"])
        self.device = device
        self.lowered = lowered
        self.block = block
        self.n = len(self.net.coords)
        self.radius = self.metric.radius(self.net, inputs.settings)
        self._nbr = None

    def indicator(self, visit=None) -> torch.Tensor:
        """(n, n) bool indicator, computed on first call in row blocks; each
        block's (S, n) distances (+inf past 1 + FAR radii) go to
        ``visit(row0, distances)`` when given."""
        if self._nbr is None or visit is not None:
            r = (float(torch.tensor(self.radius).to(torch.bfloat16))
                 if self.lowered else self.radius)
            out = torch.zeros((self.n, self.n), dtype=torch.bool,
                              device=self.device)
            for r0 in range(0, self.n, self.block):
                src = torch.arange(r0, min(r0 + self.block, self.n),
                                   device=self.device)
                d = self.metric.distances(self.net, src,
                                          self.radius * (1 + FAR),
                                          lowered=self.lowered)
                out[r0:r0 + len(src)] = d <= r
                if visit is not None:
                    visit(r0, d)
            self._nbr = out
        return self._nbr


class Judge:
    """Holds a run's outputs against the reference and keeps the largest
    reading of each of ``numbers``. A kind's judge adds
    ``judge_analysis(pool_index, outputs)``."""

    def __init__(self, inputs, device, numbers, *, block: int = 512):
        self.nbr = Neighborhoods(inputs, device, block=block)
        self.inputs = inputs
        self.device = device
        self.ulp = f32_ulp(self.nbr.radius)
        self.readings = {k: 0.0 for k in numbers}
        self.rows_off = 0        # rows whose neighborhood differs
        self.checked = 0         # analyses compared
        self.agree = None

    def judge_neighborhoods(self, rows) -> np.ndarray:
        """Reads ``nbhd_ulps`` of an indicator, a scipy CSR or an (n, n)
        bool tensor; keeps and returns the (n,) bool mask of the rows that
        agree with the reference."""
        n, radius = self.nbr.n, self.nbr.radius
        agree = np.ones(n, dtype=bool)
        worst = [0.0]

        def visit(r0, d):
            s = d.shape[0]
            got = (rows[r0:r0 + s].to(d.device).bool()
                   if isinstance(rows, torch.Tensor)
                   else csr_to_dense(rows[r0:r0 + s], d.device))
            diff = got != (d <= radius)
            if diff.any():
                gap = torch.clamp((d[diff] - radius).abs(),
                                  max=FAR * radius)
                worst[0] = max(worst[0], float(gap.max()) / self.ulp)
                agree[r0:r0 + s] = ~diff.any(dim=1).cpu().numpy()

        self.nbr.indicator(visit=visit)
        self.readings["nbhd_ulps"] = max(self.readings["nbhd_ulps"],
                                         worst[0])
        self.rows_off = max(self.rows_off, int((~agree).sum()))
        self.agree = agree
        return agree


def csr_to_dense(m, device) -> torch.Tensor:
    """(n, n) bool tensor of a scipy CSR's nonzero pattern."""
    m = m.tocsr()
    m.eliminate_zeros()
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    out = torch.zeros(m.shape, dtype=torch.bool, device=device)
    out[torch.as_tensor(rows, device=device),
        torch.as_tensor(m.indices.astype(np.int64), device=device)] = True
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return all(readings[k] <= limits[k] for k in limits), checks
