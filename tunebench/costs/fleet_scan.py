"""Work of one ``fleet_scan`` window (the lane-free tick scan), frozen: the
state in and out, the 11 coefficient rows, seven (T, N) grids or eight with
the fault multiplier in and the 7 ys rows out, all f32; ~40 operations a
tick and cluster."""
from __future__ import annotations

CONSTS_USED = 11
TICK_OPS = 40


def scan_cost(T: int, N: int, fmult: bool = True) -> tuple[int, int]:
    """(bytes, ops) of one window."""
    grids = 8 if fmult else 7
    words = 2 + CONSTS_USED + grids * T + 7 * T + 2
    return 4 * N * words, T * N * TICK_OPS
