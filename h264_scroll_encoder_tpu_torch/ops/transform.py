"""Inverse residual reconstruction + intra prediction (decode-side math).

Copy of h264_scroll_encoder_tpu/ops/transform.py (pure numpy), for the
port's pixel_oracle.

Coefficient placement (9.2.4), inverse zigzag (8.5.6), dequantization
(8.5.9/8.5.12.1), Intra16x16 luma DC (8.5.10), chroma DC (8.5.11), the
4x4 core transform (8.5.12.2), and the Intra_4x4 / Intra_16x16 / chroma
prediction modes (8.3.1-8.3.4).

The C reference contains no decoder at all (it shells to ffmpeg,
trans_resizer.c:2176-2186); this module completes the native pixel
oracle so streams carrying real residuals (dynamic-rect splices, padded
transcodes, donor CAVLC content) are validated at exact pixel level.
Every arithmetic path here is differentially tested against the system
libavcodec (tests/test_avref.py) — bit-exactness is required by the
H.264 integer-transform conformance rules, so agreement is meaningful.

Pure numpy; nothing here touches the hot path.
"""

from __future__ import annotations

import numpy as np

# Zigzag scan positions for a 4x4 block (8.5.6): scan index -> (row, col).
ZIGZAG_4x4 = ((0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3),
              (1, 2), (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3),
              (3, 2), (3, 3))

# normAdjust4x4 (Table 8-15 column triples): index by qp % 6, position
# class (0: both even, 1: both odd, 2: mixed).
_V = ((10, 16, 13), (11, 18, 14), (13, 20, 16),
      (14, 23, 18), (16, 25, 20), (18, 29, 23))

_LS4x4 = np.empty((6, 4, 4), np.int64)
for _m in range(6):
    for _i in range(4):
        for _j in range(4):
            cls = 0 if (_i % 2 == 0 and _j % 2 == 0) else \
                  1 if (_i % 2 == 1 and _j % 2 == 1) else 2
            _LS4x4[_m, _i, _j] = _V[_m][cls]

# QPc mapping (Table 8-15 of 8.4.4.5 / qPI -> QPc).
_QPC = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35,
                          36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39]


def chroma_qp(qp_y: int, chroma_qp_index_offset: int) -> int:
    return _QPC[int(np.clip(qp_y + chroma_qp_index_offset, 0, 51))]


def coeff_scan(block, max_coeff: int) -> np.ndarray:
    """ResidualBlock -> length-max_coeff coefficient vector in scan order
    (9.2.4: levels are decoded highest-frequency first; runs give the
    zero gaps toward lower frequencies)."""
    out = np.zeros(max_coeff, np.int64)
    tc = block.total_coeff
    if tc == 0:
        return out
    idx = tc + block.total_zeros - 1
    for k in range(tc):
        out[idx] = block.levels[k]
        if k == tc - 1:
            break
        run = block.runs[k] if k < len(block.runs) else 0
        idx -= 1 + run
    return out


def _unzigzag(coeffs: np.ndarray, start: int) -> np.ndarray:
    """Scan-order coefficients -> 4x4 matrix; `start` is the zigzag
    position of the first coefficient (1 for AC-only 15-coeff blocks)."""
    m = np.zeros((4, 4), np.int64)
    for k, v in enumerate(coeffs):
        r, c = ZIGZAG_4x4[start + k]
        m[r, c] = v
    return m


def _wrap16(x):
    """int16 storage semantics: H.264 guarantees conformant streams keep
    every coefficient and first-pass transform intermediate within 16
    bits (8.5 parsing invariants), so decoders store them as int16 and
    out-of-envelope synthetic streams wrap.  Emulating the wrap keeps
    this oracle bit-exact with libavcodec on any input; for conformant
    streams it is the identity."""
    return (np.asarray(x, np.int64) + 32768) % 65536 - 32768


def _dc_only(dc: int) -> np.ndarray:
    """DC-only block dispatch (idct_dc_add): the residual is computed in
    full precision ((dc + 32) >> 6, no 16-bit butterfly wrapping)."""
    return np.full((4, 4), (dc + 32) >> 6, np.int64)


def _sat16(x):
    """Saturating int16 store (packssdw) — how scaled DC values land in
    the coefficient buffer."""
    return np.clip(np.asarray(x, np.int64), -32768, 32767)


def _idct4x4(d: np.ndarray) -> np.ndarray:
    """8.5.12.2 core transform on dequantized d; returns the residual
    BEFORE clipping, i.e. (f + 32) >> 6.

    The first (horizontal) pass result and the final sums are stored at
    int16 (the coefficient-buffer width of the de-facto decode
    pipeline); rounding is folded into the DC before the first pass.
    This exact policy — pass order, wrap points, rounding position —
    was fit empirically against libavcodec over hot out-of-envelope
    blocks (conformant streams never wrap, so for them this is the
    exact 8.5.12.2 transform)."""
    d = d.copy()
    d[0, 0] = d[0, 0] + 32
    # Horizontal pass (rows), stored at int16.
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    f = _wrap16(np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1))
    # Vertical pass (columns) feeding the >> 6 output.
    g0 = f[0] + f[2]
    g1 = f[0] - f[2]
    g2 = (f[1] >> 1) - f[3]
    g3 = f[1] + (f[3] >> 1)
    h = _wrap16(np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3]))
    return h >> 6


def residual_4x4(coeffs16: np.ndarray, qp: int) -> np.ndarray:
    """Full 16-coefficient 4x4 block (inter / Intra_4x4): dequant
    (8.5.12.1) + core transform -> int 4x4 residual.

    Scale convention: W = c * LS << (qp/6) feeding a core transform that
    ends with (x + 32) >> 6 — the exact-integer pipeline libavcodec/JM
    implement (verified bit-exact against libavcodec across qp 0..51 in
    tests/test_avref.py)."""
    d = _wrap16(_unzigzag(coeffs16, 0) * _LS4x4[qp % 6] << (qp // 6))
    return _idct4x4(d)


def _residual_ac_with_dc(ac15: np.ndarray, dc: int, qp: int) -> np.ndarray:
    """AC coefficients (scan 1..15) scaled as in residual_4x4 with the
    separately-scaled (already int16-saturated) DC at position (0,0)."""
    d = _wrap16(_unzigzag(ac15, 1) * _LS4x4[qp % 6] << (qp // 6))
    d[0, 0] = dc
    return _idct4x4(d)


def luma16_residuals(dc_block, ac_blocks, qp: int) -> list:
    """Intra_16x16 luma: 4x4 Hadamard on the 16 DC coefficients (8.5.10)
    + per-block AC; returns 16 4x4 residual arrays in raster order."""
    dc_scan = coeff_scan(dc_block, 16) if dc_block is not None \
        else np.zeros(16, np.int64)
    c = _unzigzag(dc_scan, 0)
    # 4x4 Hadamard (8.5.10, eq 8-330), 16-bit-lane butterflies as in
    # _idct4x4 (z0/z1 sums then +-, each stage wrapping).
    z0 = _wrap16(c[0] + c[2]); z1 = _wrap16(c[0] - c[2])
    z2 = _wrap16(c[1] - c[3]); z3 = _wrap16(c[1] + c[3])
    tmp = _wrap16(np.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3]))
    z0 = _wrap16(tmp[:, 0] + tmp[:, 2]); z1 = _wrap16(tmp[:, 0] - tmp[:, 2])
    z2 = _wrap16(tmp[:, 1] - tmp[:, 3]); z3 = _wrap16(tmp[:, 1] + tmp[:, 3])
    f = _wrap16(np.stack([z0 + z3, z1 + z2, z1 - z2, z0 - z3], axis=1))
    ls = int(_LS4x4[qp % 6, 0, 0])
    # 8.5.10 in the same scale convention as residual_4x4 (the Hadamard
    # contributes an extra gain of 4 the -2 shift removes).
    if qp >= 12:
        dc = (f * ls) << (qp // 6 - 2)
    else:
        dc = (f * ls + (1 << (1 - qp // 6))) >> (2 - qp // 6)
    dc = _sat16(dc)      # stored to the int16 block via packssdw
    # Block dispatch follows the paired idct_add16intra pipeline: 4x4
    # blocks are handled in horizontal pairs — if EITHER block of a pair
    # carries AC coefficients, BOTH run the full (16-bit-wrapping)
    # transform with the DC substituted; an all-empty pair takes the
    # full-precision DC-only path.
    out = [None] * 16
    for a in range(0, 16, 2):
        pair_has_ac = (ac_blocks[a].total_coeff
                       or ac_blocks[a + 1].total_coeff)
        for raster in (a, a + 1):
            br, bc = raster // 4, raster % 4
            d = int(dc[br, bc])
            if pair_has_ac:
                ac = coeff_scan(ac_blocks[raster], 15) \
                    if ac_blocks[raster].total_coeff \
                    else np.zeros(15, np.int64)
                out[raster] = _residual_ac_with_dc(ac, d, qp)
            else:
                out[raster] = _dc_only(d)
    return out


def chroma_residuals(dc_block, ac_blocks, qpc: int) -> list:
    """One chroma plane: 2x2 DC Hadamard (8.5.11) + 4 AC blocks;
    returns 4 4x4 residual arrays in raster order (2x2 arrangement)."""
    dcs = coeff_scan(dc_block, 4) if dc_block is not None \
        else np.zeros(4, np.int64)
    c = np.array([[dcs[0], dcs[1]], [dcs[2], dcs[3]]], np.int64)
    f = np.array([[c[0, 0] + c[0, 1] + c[1, 0] + c[1, 1],
                   c[0, 0] - c[0, 1] + c[1, 0] - c[1, 1]],
                  [c[0, 0] + c[0, 1] - c[1, 0] - c[1, 1],
                   c[0, 0] - c[0, 1] - c[1, 0] + c[1, 1]]], np.int64)
    ls = int(_LS4x4[qpc % 6, 0, 0])
    # 8.5.11 in the residual_4x4 scale convention (2x2 Hadamard gain 2);
    # the chroma DC store wraps (plain int16 write, unlike the saturating
    # luma DC pack).
    dc = _wrap16(((f * ls) << (qpc // 6)) >> 1)
    out = [None] * 4
    for blk in range(4):
        br, bc = blk // 2, blk % 2
        d = int(dc[br, bc])
        if ac_blocks and ac_blocks[blk].total_coeff:
            out[blk] = _residual_ac_with_dc(
                coeff_scan(ac_blocks[blk], 15), d, qpc)
        else:
            out[blk] = _dc_only(d)
    return out


# ---------------------------------------------------------------------------
# Intra prediction (8.3).  Neighbor convention: `left` is the N-sample
# column left of the block (top to bottom), `top` the N-sample row above,
# `topleft` the corner sample, `topright` the N samples above-right.
# Availability flags follow the spec; conformant streams only use modes
# whose required neighbors exist.
# ---------------------------------------------------------------------------

def pred4x4(mode: int, left, top, topleft, topright,
            avail_l: bool, avail_t: bool, avail_tl: bool,
            avail_tr: bool) -> np.ndarray:
    """8.3.1.2: Intra_4x4 prediction -> uint8 4x4."""
    p = np.zeros((4, 4), np.int64)
    lt = int(topleft) if avail_tl else 0
    l = np.asarray(left, np.int64) if avail_l else np.zeros(4, np.int64)
    t = np.asarray(top, np.int64) if avail_t else np.zeros(4, np.int64)
    if avail_tr:
        tr = np.asarray(topright, np.int64)
    elif avail_t:
        tr = np.full(4, t[3], np.int64)      # 8.3.1.2: substitution
        avail_tr = True
    else:
        tr = np.zeros(4, np.int64)

    if mode == 0:                            # Vertical
        p[:] = t
    elif mode == 1:                          # Horizontal
        p[:] = l[:, None]
    elif mode == 2:                          # DC (availability-adaptive)
        if avail_l and avail_t:
            p[:] = (l.sum() + t.sum() + 4) >> 3
        elif avail_l:
            p[:] = (l.sum() + 2) >> 2
        elif avail_t:
            p[:] = (t.sum() + 2) >> 2
        else:
            p[:] = 128
    elif mode == 3:                          # Diagonal down-left
        q = np.concatenate([t, tr])
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (q[6] + 3 * q[7] + 2) >> 2
                else:
                    i = x + y
                    p[y, x] = (q[i] + 2 * q[i + 1] + q[i + 2] + 2) >> 2
    elif mode == 4:                          # Diagonal down-right
        for y in range(4):
            for x in range(4):
                if x > y:
                    i = x - y
                    a = t[i - 2] if i >= 2 else lt
                    p[y, x] = (a + 2 * t[i - 1] + t[i] + 2) >> 2
                elif x < y:
                    i = y - x
                    a = l[i - 2] if i >= 2 else lt
                    p[y, x] = (a + 2 * l[i - 1] + l[i] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * lt + l[0] + 2) >> 2
    elif mode == 5:                          # Vertical-right
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    p[y, x] = ((t[i - 1] if i >= 1 else lt)
                               + t[i] + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    a = t[i - 2] if i >= 2 else lt
                    b = t[i - 1] if i >= 1 else lt
                    p[y, x] = (a + 2 * b + t[i] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * lt + t[0] + 2) >> 2
                else:
                    i = y - 2 * x
                    p[y, x] = (l[i - 1] + 2 * l[i - 2]
                               + (l[i - 3] if i >= 3 else lt) + 2) >> 2
    elif mode == 6:                          # Horizontal-down
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    p[y, x] = ((l[i - 1] if i >= 1 else lt) + l[i] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    a = l[i - 2] if i >= 2 else lt
                    b = l[i - 1] if i >= 1 else lt
                    p[y, x] = (a + 2 * b + l[i] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * lt + l[0] + 2) >> 2
                else:
                    i = x - 2 * y
                    p[y, x] = (t[i - 1] + 2 * t[i - 2]
                               + (t[i - 3] if i >= 3 else lt) + 2) >> 2
    elif mode == 7:                          # Vertical-left
        q = np.concatenate([t, tr])
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (q[i] + q[i + 1] + 1) >> 1
                else:
                    p[y, x] = (q[i] + 2 * q[i + 1] + q[i + 2] + 2) >> 2
    elif mode == 8:                          # Horizontal-up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z <= 4 and z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 5:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    else:
        raise ValueError(f"intra4x4 mode {mode}")
    return p


def pred16x16(mode: int, left, top, topleft,
              avail_l: bool, avail_t: bool) -> np.ndarray:
    """8.3.3: Intra_16x16 prediction -> int 16x16."""
    p = np.zeros((16, 16), np.int64)
    l = np.asarray(left, np.int64) if avail_l else np.zeros(16, np.int64)
    t = np.asarray(top, np.int64) if avail_t else np.zeros(16, np.int64)
    if mode == 0:
        p[:] = t
    elif mode == 1:
        p[:] = l[:, None]
    elif mode == 2:
        if avail_l and avail_t:
            p[:] = (l.sum() + t.sum() + 16) >> 5
        elif avail_l:
            p[:] = (l.sum() + 8) >> 4
        elif avail_t:
            p[:] = (t.sum() + 8) >> 4
        else:
            p[:] = 128
    elif mode == 3:                          # Plane (8.3.3.4)
        lt = int(topleft)
        h = sum((x + 1) * (int(t[8 + x]) - int(t[6 - x])) for x in range(7))
        h += 8 * (int(t[15]) - lt)
        v = sum((y + 1) * (int(l[8 + y]) - int(l[6 - y])) for y in range(7))
        v += 8 * (int(l[15]) - lt)
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        yy, xx = np.mgrid[:16, :16]
        p = np.clip((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5, 0, 255)
    else:
        raise ValueError(f"intra16 mode {mode}")
    return p


def pred_chroma(mode: int, left, top, topleft,
                avail_l: bool, avail_t: bool) -> np.ndarray:
    """8.3.4: chroma prediction (8x8, 4:2:0) -> int 8x8."""
    p = np.zeros((8, 8), np.int64)
    l = np.asarray(left, np.int64) if avail_l else np.zeros(8, np.int64)
    t = np.asarray(top, np.int64) if avail_t else np.zeros(8, np.int64)
    if mode == 0:                            # DC, per-4x4 quadrant rules
        for by in (0, 1):
            for bx in (0, 1):
                ls = l[by * 4:(by + 1) * 4]
                ts = t[bx * 4:(bx + 1) * 4]
                if (bx, by) == (0, 0) or (bx, by) == (1, 1):
                    if avail_l and avail_t:
                        v = (ls.sum() + ts.sum() + 4) >> 3
                    elif avail_l:
                        v = (ls.sum() + 2) >> 2
                    elif avail_t:
                        v = (ts.sum() + 2) >> 2
                    else:
                        v = 128
                elif (bx, by) == (1, 0):     # prefer top
                    if avail_t:
                        v = (ts.sum() + 2) >> 2
                    elif avail_l:
                        v = (ls.sum() + 2) >> 2
                    else:
                        v = 128
                else:                        # (0, 1): prefer left
                    if avail_l:
                        v = (ls.sum() + 2) >> 2
                    elif avail_t:
                        v = (ts.sum() + 2) >> 2
                    else:
                        v = 128
                p[by * 4:(by + 1) * 4, bx * 4:(bx + 1) * 4] = v
    elif mode == 1:
        p[:] = l[:, None]
    elif mode == 2:
        p[:] = t
    elif mode == 3:                          # Plane (8.3.4.4)
        lt = int(topleft)
        h = sum((x + 1) * (int(t[4 + x]) - int(t[2 - x])) for x in range(3))
        h += 4 * (int(t[7]) - lt)
        v = sum((y + 1) * (int(l[4 + y]) - int(l[2 - y])) for y in range(3))
        v += 4 * (int(l[7]) - lt)
        a = 16 * (int(l[7]) + int(t[7]))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        yy, xx = np.mgrid[:8, :8]
        p = np.clip((a + b * (xx - 3) + c * (yy - 3) + 16) >> 5, 0, 255)
    else:
        raise ValueError(f"chroma mode {mode}")
    return p


def decode_i4x4_modes(pred_mode_bits: str, left_modes, top_modes) -> list:
    """8.3.1.1: derive the 16 Intra_4x4 prediction modes of one MB from
    the prev/rem grammar bits and neighbor modes.

    left_modes / top_modes: per-4x4 modes of the left/top neighbor MB's
    relevant edge (length 4, raster order), or None when the neighbor is
    unavailable; a non-Intra_4x4 neighbor MB contributes DC (2) — pass
    [2]*4.  Returns 16 modes in raster order."""
    modes = [0] * 16
    pos = 0
    bits = pred_mode_bits
    # Decode in the 4x4 Z scan order used by the grammar.
    from .cavlc_tables import SCAN_TO_RASTER
    for scan in range(16):
        raster = SCAN_TO_RASTER[scan]
        row, col = divmod(raster, 4)
        if col > 0:
            a = modes[raster - 1]
        elif left_modes is not None:
            a = left_modes[row]
        else:
            a = -1
        if row > 0:
            b = modes[raster - 4]
        elif top_modes is not None:
            b = top_modes[col]
        else:
            b = -1
        pred = 2 if (a < 0 or b < 0) else min(a, b)
        prev = bits[pos] == "1"
        pos += 1
        if prev:
            modes[raster] = pred
        else:
            rem = int(bits[pos: pos + 3], 2)
            pos += 3
            modes[raster] = rem if rem < pred else rem + 1
    return modes
