"""The one generator of traffic: the run's seeds, the parameters of a
mix's data file (``traffic/<name>.json``) that every kind reads, and the
null's permutations on the device.

A mix file holds only parameters: ``kind`` (the kind of analysis,
``kinds/<kind>.py``, which reads the rest), ``pool`` (how many attribute
sets set-up makes; the window cycles through them), ``nan_share``
(``{"default": s, "<config>": s}``, the share of unannotated genes),
``settings`` (the session's settings for this mix), ``warmup`` (analyses
run in set-up), a ``why``, and what its kind names.
"""

from __future__ import annotations

import numpy as np
import torch


def seeds(seed: int, count: int) -> list[int]:
    """``count`` independent 63-bit seeds drawn from the run's ``--seed``
    (any non-negative integer)."""
    ss = np.random.SeedSequence(int(seed))
    words = ss.generate_state(2 * count, dtype=np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1])
            for i in range(count)]


def nan_share(traffic: dict, config_name: str) -> float:
    shares = traffic["nan_share"]
    return float(shares.get(config_name, shares["default"]))


def permutations(count: int, size: int, seed: int, device,
                 chunk: int = 1024) -> torch.Tensor:
    """(count, size) int64 on ``device``: each row a uniform random
    permutation of 0..size-1, drawn on the device from ``seed`` by sorting
    uniform keys, a chunk of rows at a time."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty((count, size), dtype=torch.int64, device=device)
    for r0 in range(0, count, chunk):
        rows = min(chunk, count - r0)
        keys = torch.rand((rows, size), generator=g, device=device)
        out[r0:r0 + rows] = keys.argsort(dim=1)
    return out
