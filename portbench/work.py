"""The work a blocked Floyd-Warshall needs, and the H100's published peaks.

One file, so that every roofline share of the benchmark reads the same work
whatever implements it. A *candidate* is one min-plus term ``d[i,k] + d[k,j]``
folded into ``min``: one f32 add and one f32 min.

Sources:
- Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at its 700 W
  power limit: 67 TFLOP/s f32 on the CUDA cores (an FMA counted as two
  operations, so 33.5 T lane operations/s) and 3.35 TB/s of HBM3. A
  candidate is two lane operations, so the candidate peak is 16.75 T/s.
- Work: the blocked FW of ``chip_smoke.relax_work`` (:544) applied round by
  round. A round with pivot block ``k`` closes the pivot tile (B^3
  candidates), relaxes the pivot panel against it (B x W x B) and relaxes
  the tiles of the round's window (B^3 each). Symmetric rounds (undirected
  graphs) need one panel and the window's upper in-band tiles; the lower
  ones are their transposes. Classic rounds need both panels and every
  in-band tile. Bytes: each in-band input tile read once and each in-band
  output tile written once per round, at 4 bytes an f32 entry.
"""

from __future__ import annotations

BLOCK = 128
F32 = 4
HBM_BYTES_PER_S = 3.35e12
FP32_LANE_OPS_PER_S = 33.5e12
CANDIDATES_PER_S = FP32_LANE_OPS_PER_S / 2   # 16.75 T/s


def window_tile_counts(tiles: int, band_tiles: int) -> tuple[int, int]:
    """(upper, all) tiles (i, j) of a ``tiles`` x ``tiles`` window with
    ``|i - j| <= band_tiles``; the diagonal counts among the upper ones."""
    upper = sum(min(i + band_tiles, tiles - 1) - i + 1 for i in range(tiles))
    return upper, 2 * upper - tiles


def round_work(window: int, band_tiles: int, *, symmetric: bool,
               block: int = BLOCK) -> tuple[int, int]:
    """(candidates, bytes) of one FW round over a ``window``-wide square
    window whose tiles within ``band_tiles`` of the diagonal are relaxed."""
    tiles = window // block
    upper, every = window_tile_counts(tiles, band_tiles)
    relaxed = upper if symmetric else every
    panels = 1 if symmetric else 2
    tile = block * block
    candidates = (block ** 3 + panels * block * window * block
                  + relaxed * tile * block)
    nbytes = (relaxed + every) * tile * F32
    return candidates, nbytes


def window_fw_work(n: int, window: int, *, symmetric: bool = True,
                   block: int = BLOCK) -> tuple[int, int]:
    """(candidates, bytes) of the banded-window FW over ``n`` nodes: one
    round per pivot block of the padded matrix, each over a ``window``-wide
    window whose band reaches ``(window - block) // 2 // block + 3`` tiles
    from the diagonal (the JAX package's ``apsp_banded.py:237``)."""
    rounds = -(-n // block)
    half = (window - block) // 2
    band_tiles = min(half // block + 3, window // block - 1)
    c, b = round_work(window, band_tiles, symmetric=symmetric, block=block)
    return rounds * c, rounds * b


def band_fw_work(n: int, bt: int, *, symmetric: bool = True,
                 block: int = BLOCK) -> tuple[int, int]:
    """(candidates, bytes) of the band-storage FW over ``n`` nodes with a
    band of ``bt`` block-tiles a side: one round per pivot block, each over
    the (2 bt + 1)-tile window around it, band ``bt``."""
    rounds = -(-n // block)
    window = (2 * bt + 1) * block
    c, b = round_work(window, bt, symmetric=symmetric, block=block)
    return rounds * c, rounds * b


def least_seconds(candidates: float, nbytes: float) -> tuple[float, str]:
    """(seconds, bound) the card needs at least: the larger of candidates
    over the candidate peak and bytes over the HBM peak."""
    ops_s = candidates / CANDIDATES_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (ops_s, "candidates") if ops_s >= bytes_s else (bytes_s, "bytes")
