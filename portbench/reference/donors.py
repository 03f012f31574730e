"""Representative donor rects made from a seed, and their payloads.

A donor is a CAVLC P slice (one reference) of a 23x23-MB rect as a real
encoder codes moderate-QP dynamic UI content: about a quarter P_Skip,
the rest P_L0_16x16 with small MVs and sparse small-level residuals
(BASELINE.json's "dynamic-rect splice" representative class).  The
draws follow the program's `utils/fixtures.representative_donor_grid`
call for call, so a seed gives the grid that fixture gives; this copy is
frozen here with the benchmark.

Imports numpy and the reference only: the payload pool is made in
worker processes that never touch the card.
"""

from __future__ import annotations

import numpy as np

from . import cavlc_tables as T
from . import h264


def _rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng((seed, k))


def _random_block(rng, max_coeff: int, density: float) -> h264.Block:
    if rng.random() > density:
        return h264.EMPTY
    tc = int(rng.integers(1, max_coeff + 1))
    t1 = int(rng.integers(0, min(3, tc) + 1))
    levels = [int(rng.choice([-1, 1])) for _ in range(t1)]
    for i in range(tc - t1):
        lo = 2 if (i == 0 and t1 < 3) else 1
        mag = int(rng.integers(lo, lo + 40))
        levels.append(mag if rng.random() < 0.5 else -mag)
    total_zeros = int(rng.integers(0, max_coeff - tc + 1))
    runs, zeros_left = [], total_zeros
    for _ in range(tc - 1):
        if zeros_left <= 0:
            break
        run = int(rng.integers(0, min(zeros_left, 14) + 1))
        runs.append(run)
        zeros_left -= run
    return h264.encode_block(levels, total_zeros, runs, max_coeff)


def _representative_mb(rng) -> h264.InterMb:
    mvd = (int(rng.integers(-16, 17)), int(rng.integers(-16, 17)))
    cbp = int(rng.choice([0, 1, 2, 4, 8, 15, 16 + 15, 32 + 3]))
    if cbp == 0:
        return h264.InterMb(mvd)
    qp_delta = int(rng.integers(-2, 3))
    luma = [h264.EMPTY] * 16
    for i8 in range(4):
        if not cbp & (1 << i8):
            continue
        for i4 in range(4):
            if rng.random() < 0.5:
                continue
            tc = int(rng.integers(1, 5))
            t1 = min(tc, int(rng.integers(0, 4)))
            levels = [int(rng.choice([-1, 1])) for _ in range(t1)]
            for i in range(tc - t1):
                lo = 2 if (i == 0 and t1 < 3) else 1
                mag = int(rng.integers(lo, lo + 4))
                levels.append(mag if rng.random() < 0.5 else -mag)
            total_zeros = int(rng.integers(0, 16 - tc + 1))
            runs, zeros_left = [], total_zeros
            for _ in range(tc - 1):
                if zeros_left <= 0:
                    break
                run = int(rng.integers(0, min(zeros_left, 7) + 1))
                runs.append(run)
                zeros_left -= run
            luma[T.SCAN_TO_RASTER[i8 * 4 + i4]] = h264.encode_block(
                levels, total_zeros, runs, 16)
    cb = cr = h264.EMPTY
    if (cbp >> 4) & 3:
        cb = _random_block(rng, 4, 0.6)
        cr = _random_block(rng, 4, 0.6)
    return h264.InterMb(mvd, cbp, qp_delta, tuple(luma), cb, cr)


def representative_grid(rng, width: int, height: int) -> list:
    """Rows of InterMb or SKIP, drawn as the program's fixture draws."""
    return [[h264.SKIP if rng.random() < 0.25 else _representative_mb(rng)
             for _ in range(width)] for _ in range(height)]


def donor_grid(seed: int, k: int, width: int, height: int) -> list:
    """Donor k of a run with this seed."""
    return representative_grid(_rng(seed, k), width, height)


def payload(grid) -> bytes:
    """The donor's slice data with rbsp_trailing_bits, coded with one
    reference as its own frame: what a donor encoder hands the
    composer."""
    bits = h264.Bits()
    h264.p_slice_data(bits, grid, 1)
    return h264.rbsp(bits.value())


def make_payload(args) -> bytes:
    """payload(donor_grid(seed, k, width, height)); one picklable
    argument for a worker pool."""
    seed, k, width, height = args
    return payload(donor_grid(seed, k, width, height))
