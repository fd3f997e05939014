"""``binary``: one binary annotation matrix (GO-BP terms) an analysis under
the hypergeometric test.

The mix file gives ``pool`` (matrices made at set-up, which the window
cycles through), ``terms`` (columns of one matrix), ``term_sizes``
(``{"low": a, "high": b}``: sizes log-uniform on [a, b], rounded) and
``nan_share`` (``{"default": s, "<config>": s}``). The pool shares one NaN
mask, the genes that no term annotates; each matrix has its own sizes and
members, each term's drawn among the 2 x size annotated genes nearest a
random centre (``generators.go_sizes_loguniform``,
``generators.build_go_matrix``). ``run_pipeline`` takes no argument.

A kind module gives ``NUMBERS``, ``make``, ``run_kwargs``, ``keep``,
``Reference`` (with ``lowered`` the control) and ``Judge``. Its numbers,
besides ``nbhd_ulps`` (``compare``), each the largest reading over what was
compared, on the rows whose neighborhood is the reference's:

- ``nes_ulps``: the largest |NES - reference| in f32 ulps of the
  reference's value (its spacing at the f32 nearest it; 0 where both are
  0). The program stores log p in f32 and derives the NES from it in f32,
  so a sound run reads a few ulps: the two roundings, the one-ulp nudge
  that carries the f64 call, and the f64 table's own error. A term given
  another's K, a count or a size off by one, or a column left unset reads
  thousands or more; so does the control, whose log-factorials are f32.
- ``nes_binary_bad``: cells whose enrichment call is not the reference's
  f64 call (p below the threshold). The program decides the call in f64,
  so the limit is exact, 0: one flipped call reads 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import compare, generators, traffic
from portbench.reference import hypergeom as ref_hyper

NUMBERS = ("nbhd_ulps", "nes_ulps", "nes_binary_bad")
# columns compared at once on the device
CHUNK_COLS = 512
# the f32 spacing at 0, the smallest subnormal: an ulp is never less
_ULP_FLOOR = float(np.finfo(np.float32).smallest_subnormal)


def go_pool(coords: np.ndarray, count: int, terms: int, low: float,
            high: float, nan_share: float, seed: int) -> list[np.ndarray]:
    """``count`` (n, terms) 0/1 matrices with one shared NaN mask (a share
    ``nan_share`` of the genes): the mask first, then each matrix's sizes
    and members from their own seeds, drawn by ``build_go_matrix`` over the
    annotated genes."""
    n = len(coords)
    mask_seed, *seeds = traffic.seeds(seed, 1 + 2 * count)
    nan_rows = np.random.default_rng(mask_seed).random(n) < nan_share
    ann = np.flatnonzero(~nan_rows)
    pool = []
    for i in range(count):
        sizes = generators.go_sizes_loguniform(terms, low, high,
                                               seeds[2 * i])
        m = np.full((n, terms), np.nan)
        m[ann] = generators.build_go_matrix(coords[ann], sizes,
                                            seeds[2 * i + 1], nan_share=0.0)
        pool.append(m)
    return pool


def make(cell, network, seed: int, device) -> dict:
    """The pool of one run."""
    mix = cell.traffic
    sizes = mix["term_sizes"]
    return dict(pool=go_pool(
        network.coords, int(mix["pool"]), int(mix["terms"]),
        float(sizes["low"]), float(sizes["high"]),
        traffic.nan_share(mix, cell.config_name), seed))


def run_kwargs(inputs) -> dict:
    return {}


def keep(sf) -> dict:
    """What a user reads next of a GO analysis, on the host: the NES and
    the calls (kept as f32 and bool; the program's NES are f32 values)."""
    return dict(nes=np.asarray(sf.nes, np.float32),
                nes_binary=np.asarray(sf.nes_binary) != 0)


def _threshold(inputs) -> float:
    return float(inputs.settings.get("enrichment_threshold", 0.05))


class Reference:
    """The plain reference of one run: its neighborhoods and, per pool
    entry, the (n, A) log p-values (``reference/hypergeom.py``), kept on
    the device. ``lowered``: bfloat16 distances and the test in f32 (the
    control)."""

    def __init__(self, inputs, device, *, lowered: bool = False,
                 block: int = 512):
        self.inputs = inputs
        self.device = device
        self.lowered = lowered
        self.block = block
        self.nbr = compare.Neighborhoods(inputs, device, lowered=lowered,
                                         block=block)
        self._log_p = {}

    def neighborhoods(self) -> torch.Tensor:
        return self.nbr.indicator()

    def log_p(self, pool_index: int) -> torch.Tensor:
        """(n, A) log p-values of pool entry ``pool_index``."""
        if pool_index not in self._log_p:
            self._log_p[pool_index] = ref_hyper.log_sf_matrix(
                self.nbr.indicator(), self.inputs.pool[pool_index],
                block=self.block, lowered=self.lowered)
        return self._log_p[pool_index]

    def outputs(self, pool_index: int) -> dict:
        """One analysis's outputs as :func:`keep` keeps the program's: the
        reference in the program's place (the control, when lowered)."""
        log_p = self.log_p(pool_index)
        return dict(
            nes=ref_hyper.nes(log_p).to(torch.float32).cpu().numpy(),
            nes_binary=ref_hyper.enriched(
                log_p, _threshold(self.inputs)).cpu().numpy())


class Judge(compare.Judge):
    """Holds outputs against the f64 :class:`Reference`."""

    def __init__(self, inputs, device, *, block: int = 512):
        super().__init__(inputs, device, NUMBERS, block=block)
        self.ref = Reference(inputs, device, block=block)
        self.ref.nbr = self.nbr     # one indicator for both

    def judge_analysis(self, pool_index: int, out: dict):
        """Reads the numbers of one analysis's outputs (nes, nes_binary) on
        the rows whose neighborhood agrees, a chunk of columns at a
        time."""
        log_p = self.ref.log_p(pool_index)
        rows = torch.as_tensor(self.agree, device=self.device)
        nes_got = np.asarray(out["nes"]).reshape(log_p.shape)
        call_got = np.asarray(out["nes_binary"]).reshape(log_p.shape)
        thr = _threshold(self.inputs)
        worst, bad = 0.0, 0
        for c0 in range(0, log_p.shape[1], CHUNK_COLS):
            cols = slice(c0, c0 + CHUNK_COLS)
            ref = log_p[rows, cols]
            want = ref_hyper.nes(ref)
            got = torch.as_tensor(nes_got[:, cols],
                                  device=self.device)[rows].to(want.dtype)
            if got.numel():
                worst = max(worst, float(ulps(got, want).max()))
            call = torch.as_tensor(call_got[:, cols],
                                   device=self.device)[rows].bool()
            bad += int((call != ref_hyper.enriched(ref, thr)).sum())
        r = self.readings
        r["nes_ulps"] = max(r["nes_ulps"], worst)
        r["nes_binary_bad"] = max(r["nes_binary_bad"], float(bad))
        self.checked += 1


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in f32 ulps of ``want`` (the spacing above the f32
    nearest |want|, at least the smallest subnormal's), f64; +inf where
    ``got`` is not a number."""
    a = want.abs().to(torch.float32)
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).to(
        torch.float64).clamp_(min=_ULP_FLOOR)
    d = (got.to(torch.float64) - want.to(torch.float64)).abs() / ulp
    return torch.nan_to_num(d, nan=math.inf)
