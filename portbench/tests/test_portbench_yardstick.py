"""The frozen byte counts against hand counts on a small factor, and the
percentile and spread."""
import numpy as np
import pytest

from portbench import yardstick


def test_gathered_bytes_by_hand():
    cols = np.array([0, 0, 5, 9, 17])           # 4 distinct entries
    assert yardstick.gathered_bytes(cols, 8) == 4 * 32   # a sector each
    assert yardstick.gathered_bytes(cols, 16) == 4 * 64
    # one lane: 8 entries a sector; entries 0, 5 share sector 0; 9 and 17
    # lie in sectors 1 and 2
    assert yardstick.gathered_bytes(cols, 1) == 3 * 32
    # two lanes: 4 entries a sector; 0 in 0, 5 in 1, 9 in 2, 17 in 4
    assert yardstick.gathered_bytes(cols, 2) == 4 * 32


def test_sweep_and_round_bytes_by_hand():
    # G of n = 4: column 0 holds rows 1, 3; column 1 holds row 2
    col_ptr = np.array([0, 2, 3, 3, 3])
    rows = np.array([1, 3, 2], np.int32)
    n, L = 4, 8
    per_sweep = 8 * 3 + 4 * n + 2 * 4 * n * L
    # the forward sweep gathers y at columns {0, 1}, the backward at rows
    # {1, 2, 3}: one 32-byte sector each at 8 lanes
    want = 2 * per_sweep + 2 * 32 + 3 * 32
    assert yardstick.sweep_bytes(n, col_ptr, rows, L) == want
    assert yardstick.round_bytes(n=4, m=5, nnz=3) == 12 * 5 + 8 * 3 + \
        4 * 4 + 4 * 5


def test_roofline_pct():
    assert yardstick.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert yardstick.roofline_pct(3.35e9, 0.0) is None


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == pytest.approx(95.05)
    assert yardstick.percentile([], 95) == 0.0
    assert yardstick.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert yardstick.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(
        (10.75 - 9.25) / 10.0)
