"""Work of one ``fleet_tick`` window, frozen: the bytes it must move and the
operations it must compute at the shapes it is launched with, and the shape
rules that give those shapes from a cell's tick count.

Bytes: each input read once (the state's 2 rows, the 11 coefficient rows
the kernel reads, eight (T, N) grids or nine with the fault multiplier, two
(T, S, N) lane tiles) and each output written once (the state's 2 rows,
the 7 ys and 5 statistics rows of T ticks, the K-entry head), all f32.
Operations: the tick recurrence (~40 a tick and cluster), the lane formula
and sum (~6 a lane), the bitonic sort (S log S (log S + 1) / 4 compare-
exchanges) and the head merge ((K + S) / 2 log (K + S)), two min/max ops
an exchange.
"""
from __future__ import annotations

import math

#: coefficient rows the kernel reads
CONSTS_USED = 11
#: the padded tick ladder
SHAPE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                 1024)
#: latency lanes a tick at most
MAX_LAT_SAMPLES = 64
#: the card's published HBM3 bandwidth (NVIDIA H100 SXM data sheet)
HBM_BYTES_S = 3.35e12


def bucket(n: int) -> int:
    for b in SHAPE_BUCKETS:
        if n <= b:
            return b
    return -256 * (-n // 256)


def episode_ticks(window_s: float, batch_interval_s: float) -> int:
    """T of the fused loop's windows: the window's ticks plus the longest
    stabilisation preroll (180 s) and one, on the tick ladder."""
    return bucket(int(round(window_s / batch_interval_s)
                      + math.ceil(180.0 / batch_interval_s)) + 1)


def lanes(T: int) -> int:
    """Latency lanes a tick on the card: at most ~2k samples a window."""
    if T * MAX_LAT_SAMPLES <= 2048:
        return MAX_LAT_SAMPLES
    for s in (32, 16, 8):
        if T * s <= 2048:
            return s
    return 8


def head(S: int, T: int) -> int:
    """K: the streaming head, deep enough for the window p99's
    interpolation, with K + S a power of two."""
    p99_k = min(T * S, int(math.ceil(0.01 * (T * S - 1)))) + 2
    P = 1
    while P < S + p99_k:
        P *= 2
    return P - S


def window_cost(T: int, S: int, K: int, N: int, fmult: bool = True):
    """(bytes, ops) of one window."""
    grids = 9 if fmult else 8
    words = (2 + CONSTS_USED + grids * T + 2 * T * S) + (2 + 12 * T + K)
    lg = S.bit_length() - 1
    lp = (K + S).bit_length() - 1
    ce = S * lg * (lg + 1) // 4 + (K + S) // 2 * lp
    ops = T * N * (40 + 6 * S + 2 * ce + 12)
    return 4 * N * words, ops
