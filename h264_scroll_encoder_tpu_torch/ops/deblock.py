"""In-loop deblocking filter (H.264 8.7) for the native pixel decoder.

Copy of h264_scroll_encoder_tpu/ops/deblock.py (pure numpy), for the
port's pixel_oracle.

Every stream this framework *emits* disables the loop filter, but donor
streams from real encoders (x264) enable it — completing the filter
makes pixel_oracle a full baseline decoder with no external library.
Boundary-strength derivation (8.7.2.1), alpha/beta/tC0 tables
(Tables 8-16/8-17), the bS<4 and bS=4 luma filters (8.7.2.3/8.7.2.4)
and the chroma filters, validated bit-exactly against libavcodec
(tests/test_avref.py).

Reference behavior note: the C reference never decodes at all (ffmpeg
does it, trans_resizer.c:2176-2186); this module replaces that
capability natively.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Table 8-16: alpha / beta thresholds by index 0..51.
_ALPHA = [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22,
                     25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
                     101, 113, 127, 144, 162, 182, 203, 226, 255, 255]
_BETA = [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
                    15, 16, 16, 17, 17, 18, 18]
# Table 8-17: tC0 by (bS-1, index 0..51).
_TC0 = (
    [0] * 16 + [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
                2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0] * 16 + [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13,
                15, 17],
    [0] * 16 + [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
                4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                23, 25],
)


@dataclasses.dataclass
class MBMeta:
    """Per-macroblock deblocking inputs, collected during decode."""
    qp: np.ndarray          # i32 [mbh, mbw]  luma QP (I_PCM -> 0 is NOT
                            # applied here; spec 8.7 uses QPy of the MB)
    qpc: np.ndarray         # i32 [mbh, mbw]  chroma QP
    intra: np.ndarray       # bool [mbh, mbw]
    nnz: np.ndarray         # i32 [mbh*4, mbw*4] per-4x4 "has coeffs"
    ref_id: np.ndarray      # i32 [mbh*4, mbw*4] ref picture token (-1 intra)
    mvx: np.ndarray         # i32 [mbh*4, mbw*4] qpel
    mvy: np.ndarray         # i32 [mbh*4, mbw*4]
    # Per-MB slice parameters (slices are MB-row bands here).
    disable: np.ndarray     # i32 [mbh, mbw]  disable_deblocking_filter_idc
    alpha_off: np.ndarray   # i32 [mbh, mbw]  slice_alpha_c0_offset_div2*2
    beta_off: np.ndarray    # i32 [mbh, mbw]
    slice_id: np.ndarray    # i32 [mbh, mbw]


def _bs_edge(meta: MBMeta, by: int, bx: int, py: int, px: int,
             mb_edge: bool) -> int:
    """Boundary strength for the 4x4 edge between block p (py,px) and
    block q (by,bx) in 4x4-grid coordinates (8.7.2.1)."""
    q_mb = (by // 4, bx // 4)
    p_mb = (py // 4, px // 4)
    if meta.intra[q_mb] or meta.intra[p_mb]:
        return 4 if mb_edge else 3
    if meta.nnz[by, bx] or meta.nnz[py, px]:
        return 2
    if meta.ref_id[by, bx] != meta.ref_id[py, px]:
        return 1
    if (abs(int(meta.mvx[by, bx]) - int(meta.mvx[py, px])) >= 4
            or abs(int(meta.mvy[by, bx]) - int(meta.mvy[py, px])) >= 4):
        return 1
    return 0


def _filter_luma_line(s: np.ndarray, bs: int, alpha: int, beta: int,
                      tc0: int) -> None:
    """Filter one 8-sample line s = [p3 p2 p1 p0 q0 q1 q2 q3] in place."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (int(v) for v in s)
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return
    if bs < 4:
        ap = abs(p2 - p0) < beta
        aq = abs(q2 - q0) < beta
        tc = tc0 + int(ap) + int(aq)
        delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
        s[3] = np.clip(p0 + delta, 0, 255)
        s[4] = np.clip(q0 - delta, 0, 255)
        if ap:
            s[2] = p1 + int(np.clip(
                (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0))
        if aq:
            s[5] = q1 + int(np.clip(
                (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0))
    else:
        strong = abs(p0 - q0) < (alpha >> 2) + 2
        if strong and abs(p2 - p0) < beta:
            s[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
            s[2] = (p2 + p1 + p0 + q0 + 2) >> 2
            s[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
        else:
            s[3] = (2 * p1 + p0 + q1 + 2) >> 2
        if strong and abs(q2 - q0) < beta:
            s[4] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
            s[5] = (q2 + q1 + q0 + p0 + 2) >> 2
            s[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
        else:
            s[4] = (2 * q1 + q0 + p1 + 2) >> 2


def _filter_chroma_line(s: np.ndarray, bs: int, alpha: int, beta: int,
                        tc0: int) -> None:
    """Filter one 4-sample chroma line s = [p1 p0 q0 q1] in place."""
    p1, p0, q0, q1 = (int(v) for v in s)
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return
    if bs < 4:
        tc = tc0 + 1
        delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
        s[1] = np.clip(p0 + delta, 0, 255)
        s[2] = np.clip(q0 - delta, 0, 255)
    else:
        s[1] = (2 * p1 + p0 + q1 + 2) >> 2
        s[2] = (2 * q1 + q0 + p1 + 2) >> 2


def _edge_params(meta: MBMeta, r: int, c: int, pr: int, pc: int,
                 chroma: bool):
    """(qp_avg-based alpha, beta, tc0_row) for the edge between MB (r,c)
    and MB (pr,pc)."""
    if chroma:
        qp_av = (int(meta.qpc[r, c]) + int(meta.qpc[pr, pc]) + 1) >> 1
    else:
        qp_av = (int(meta.qp[r, c]) + int(meta.qp[pr, pc]) + 1) >> 1
    ia = int(np.clip(qp_av + int(meta.alpha_off[r, c]), 0, 51))
    ib = int(np.clip(qp_av + int(meta.beta_off[r, c]), 0, 51))
    return _ALPHA[ia], _BETA[ib], ia


def filter_frame(pic, meta: MBMeta) -> None:
    """Apply the loop filter in place over a reconstructed frame.

    Per-MB raster order, vertical edges left-to-right then horizontal
    edges top-to-bottom (8.7), honoring per-slice disable idc (1 = off,
    2 = skip slice-boundary edges) and alpha/beta offsets."""
    mbh, mbw = meta.qp.shape
    for r in range(mbh):
        for c in range(mbw):
            dis = int(meta.disable[r, c])
            if dis == 1:
                continue
            # --- vertical edges (filter across columns) ---
            for e in range(4):
                if e == 0:
                    if c == 0:
                        continue
                    if dis == 2 and meta.slice_id[r, c] != \
                            meta.slice_id[r, c - 1]:
                        continue
                    pr, pc = r, c - 1
                else:
                    pr, pc = r, c
                alpha, beta, ia = _edge_params(meta, r, c, pr, pc, False)
                ca, cb, cia = _edge_params(meta, r, c, pr, pc, True)
                x = c * 16 + e * 4
                for sub in range(4):           # 4x4 block rows on the edge
                    by = r * 4 + sub
                    bx = c * 4 + e
                    bs = _bs_edge(meta, by, bx, by, bx - 1, e == 0)
                    if bs == 0:
                        continue
                    tc0 = _TC0[bs - 1][ia] if bs < 4 else 0
                    for row in range(by * 4, by * 4 + 4):
                        _filter_luma_line(pic.y[row, x - 4: x + 4], bs,
                                          alpha, beta, tc0)
                    if e in (0, 2):            # chroma edges at x=0, 8
                        ctc0 = _TC0[bs - 1][cia] if bs < 4 else 0
                        cx = x // 2
                        for row in range(by * 2, by * 2 + 2):
                            _filter_chroma_line(
                                pic.cb[row, cx - 2: cx + 2], bs, ca, cb,
                                ctc0)
                            _filter_chroma_line(
                                pic.cr[row, cx - 2: cx + 2], bs, ca, cb,
                                ctc0)
            # --- horizontal edges (filter across rows) ---
            for e in range(4):
                if e == 0:
                    if r == 0:
                        continue
                    if dis == 2 and meta.slice_id[r, c] != \
                            meta.slice_id[r - 1, c]:
                        continue
                    pr, pc = r - 1, c
                else:
                    pr, pc = r, c
                alpha, beta, ia = _edge_params(meta, r, c, pr, pc, False)
                ca, cb, cia = _edge_params(meta, r, c, pr, pc, True)
                y = r * 16 + e * 4
                for sub in range(4):
                    by = r * 4 + e
                    bx = c * 4 + sub
                    bs = _bs_edge(meta, by, bx, by - 1, bx, e == 0)
                    if bs == 0:
                        continue
                    tc0 = _TC0[bs - 1][ia] if bs < 4 else 0
                    for col in range(bx * 4, bx * 4 + 4):
                        _filter_luma_line(pic.y[y - 4: y + 4, col], bs,
                                          alpha, beta, tc0)
                    if e in (0, 2):
                        ctc0 = _TC0[bs - 1][cia] if bs < 4 else 0
                        cy = y // 2
                        for col in range(bx * 2, bx * 2 + 2):
                            _filter_chroma_line(
                                pic.cb[cy - 2: cy + 2, col], bs, ca, cb,
                                ctc0)
                            _filter_chroma_line(
                                pic.cr[cy - 2: cy + 2, col], bs, ca, cb,
                                ctc0)
