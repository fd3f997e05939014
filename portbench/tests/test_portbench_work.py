"""The FW work count against hand-counted tiles, and the peaks."""

import pytest

from portbench import work

B = work.BLOCK


def brute_tiles(tiles, band):
    cells = [(i, j) for i in range(tiles) for j in range(tiles)
             if abs(i - j) <= band]
    return sum(1 for i, j in cells if j >= i), len(cells)


@pytest.mark.parametrize("tiles,band", [(2, 1), (4, 1), (8, 6), (25, 12),
                                        (17, 8), (5, 0)])
def test_tile_counts_by_hand(tiles, band):
    assert work.window_tile_counts(tiles, band) == brute_tiles(tiles, band)


def test_known_tile_lists():
    # Example_1's window (1,024 wide, band 6: 35 upper tiles) and the
    # 49,920-node band (bt 12: 247 upper, 469 in all), the kernel table's
    assert work.window_tile_counts(8, 6) == (35, 62)
    assert work.window_tile_counts(25, 12) == (247, 469)


def test_round_work_by_hand():
    # two tiles, band 1: close the pivot (B^3), one panel B x 256 x B, three
    # upper tiles (B^3 each); read 3 tiles, write 4
    c, b = work.round_work(256, 1, symmetric=True)
    assert c == B ** 3 + B * 256 * B + 3 * B ** 3 == 6 * B ** 3
    assert b == (3 + 4) * B * B * 4
    c, b = work.round_work(256, 1, symmetric=False)
    assert c == B ** 3 + 2 * B * 256 * B + 4 * B ** 3
    assert b == 8 * B * B * 4


def test_fw_totals():
    c, b = work.round_work(1024, 6, symmetric=True)
    assert work.window_fw_work(3971, 1024) == (32 * c, 32 * b)
    c, b = work.round_work(17 * B, 8, symmetric=True)
    assert work.band_fw_work(20480, 8) == (160 * c, 160 * b)


def test_peaks_and_least_time():
    assert work.CANDIDATES_PER_S == 16.75e12
    s, by = work.least_seconds(16.75e12, 1.0)
    assert s == pytest.approx(1.0) and by == "candidates"
    s, by = work.least_seconds(1.0, 3.35e12)
    assert s == pytest.approx(1.0) and by == "bytes"
