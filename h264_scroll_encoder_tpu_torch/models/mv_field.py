"""Decoder-side motion-vector field reconstruction (H.264 8.4.1.3).

Copied unchanged from h264_scroll_encoder_tpu/models/mv_field.py (it has
no framework dependency), so the port runs where jax is absent.

Given a parsed P-slice macroblock grid (models/mb_transcode), reconstruct
every 4x4 luma block's (refIdx, mvx, mvy) exactly as a conformant decoder
would: median prediction with the 16x8/8x16 directional special cases,
above-right availability via decode order, P_Skip derivation (8.4.1.1),
and intra macroblocks acting as unavailable-for-match, zero-MV neighbors.

Two uses:
  1. Verification oracle: our P_Skip-enabled scroll streams are checked by
     decoding their MV field and comparing against the intended composition
     (the reference shipped with P_Skip disabled precisely because it had
     no way to check this — h264_encoder.c:564-566).
  2. Splice MVD resolution: hint macroblocks carry a *desired* MV; this
     pass rewrites their mvd so the decoded MV equals the desired one in
     the spliced frame's prediction context (docs/MASTER_DESIGN.md §6.1).
"""

from __future__ import annotations

import numpy as np

from ..ops.cavlc import CAVLCError
from . import mb_transcode as mbt

INTRA_REF = -2          # refIdx marker for intra blocks (never matches)
UNAVAIL = -9            # availability marker


def _median3(a, b, c):
    return max(min(a, b), min(max(a, b), c))


class MVField:
    """4x4-granular (ref, mvx, mvy) field with decode-order availability."""

    def __init__(self, mb_width: int, mb_height: int):
        self.w4 = mb_width * 4
        self.h4 = mb_height * 4
        self.ref = np.full((self.h4, self.w4), UNAVAIL, np.int32)
        self.mvx = np.zeros((self.h4, self.w4), np.int32)
        self.mvy = np.zeros((self.h4, self.w4), np.int32)
        self.filled = np.zeros((self.h4, self.w4), bool)

    def _cell(self, bx: int, by: int):
        """(ref, mvx, mvy, available) honoring bounds + decode order."""
        if bx < 0 or by < 0 or bx >= self.w4 or by >= self.h4:
            return 0, 0, 0, False
        if not self.filled[by, bx]:
            return 0, 0, 0, False
        return (int(self.ref[by, bx]), int(self.mvx[by, bx]),
                int(self.mvy[by, bx]), True)

    def neighbors(self, bx: int, by: int, w4: int):
        """A (left), B (above), C (above-right w/ D fallback) for a
        partition whose top-left 4x4 cell is (bx, by), width w4 cells."""
        a = self._cell(bx - 1, by)
        b = self._cell(bx, by - 1)
        c = self._cell(bx + w4, by - 1)
        if not c[3]:
            c = self._cell(bx - 1, by - 1)
        return a, b, c

    def predict(self, bx: int, by: int, w4: int, ref_idx: int,
                a=None, b=None, c=None):
        """8.4.1.3.1 median prediction for a partition."""
        if a is None:
            a, b, c = self.neighbors(bx, by, w4)
        (ra, xa, ya, av_a), (rb, xb, yb, av_b), (rc, xc, yc, av_c) = a, b, c
        m_a = av_a and ra == ref_idx
        m_b = av_b and rb == ref_idx
        m_c = av_c and rc == ref_idx
        n_avail = av_a + av_b + av_c
        n_match = m_a + m_b + m_c
        if n_avail == 0:
            return 0, 0
        # Only A available (e.g. first row): use A regardless of match
        # (8.4.1.3.1: when B, C not available and A is, pred = mvA).
        if av_a and not av_b and not av_c:
            return xa, ya
        if n_match == 1:
            if m_a:
                return xa, ya
            if m_b:
                return xb, yb
            return xc, yc
        px = _median3(xa if av_a else 0, xb if av_b else 0, xc if av_c else 0)
        py = _median3(ya if av_a else 0, yb if av_b else 0, yc if av_c else 0)
        return px, py

    def fill(self, bx: int, by: int, w4: int, h4: int, ref: int,
             mvx: int, mvy: int):
        self.ref[by:by + h4, bx:bx + w4] = ref
        self.mvx[by:by + h4, bx:bx + w4] = mvx
        self.mvy[by:by + h4, bx:bx + w4] = mvy
        self.filled[by:by + h4, bx:bx + w4] = True

    def skip_mv(self, bx: int, by: int):
        """P_Skip MV derivation (8.4.1.1)."""
        a = self._cell(bx - 1, by)
        b = self._cell(bx, by - 1)
        (ra, xa, ya, av_a), (rb, xb, yb, av_b) = a, b
        if not av_a or not av_b:
            return 0, 0
        if ra == 0 and xa == 0 and ya == 0:
            return 0, 0
        if rb == 0 and xb == 0 and yb == 0:
            return 0, 0
        return self.predict(bx, by, 4, 0)


# Sub-partition geometry: (w4, h4) per sub_mb_type and the number of
# sub-partitions (H.264 Table 7-18).
_SUB_GEOM = {0: (2, 2), 1: (2, 1), 2: (1, 2), 3: (1, 1)}


def decode_p_slice_mv_field(grid: list, mb_width: int,
                            mb_height: int, *, field: MVField | None = None,
                            origin: tuple = (0, 0),
                            post_row=None) -> MVField:
    """Walk the MB grid in raster order reconstructing the MV field, and
    resolving hint macroblocks' mvd in place (see resolve note below).

    Macroblocks may carry `hint_mv=(x_qpel, y_qpel)` (set by
    splice_p_frame); for those the mvd is *assigned* as desired-minus-pred
    instead of being read, and the field records the desired MV.

    `field`/`origin` let a caller decode the grid inside a larger,
    partially pre-filled field (e.g. a donor rect whose left/top border
    cells carry the composite frame's neighboring MB values — see
    splice_device.donor_edge_motion); origin is the (mb_x, mb_y) of
    grid[0][0] within that field.  `post_row(mb_y)` runs after each MB
    row — ring callers use it to fill border cells that only become
    available in decode order AFTER the row (e.g. the composite MB right
    of the rect: it decodes before the NEXT donor row, so it may serve
    as that row's above-right neighbor, but it must NOT be visible to
    same-row sub-partition prediction).
    """
    if field is None:
        field = MVField(mb_width, mb_height)
    ox, oy = origin
    for mb_y in range(mb_height):
        if post_row is not None and mb_y > 0:
            post_row(mb_y - 1)
        for mb_x in range(mb_width):
            mb = grid[mb_y][mb_x]
            bx, by = (mb_x + ox) * 4, (mb_y + oy) * 4
            if mb is mbt.SKIP:
                mvx, mvy = field.skip_mv(bx, by)
                field.fill(bx, by, 4, 4, 0, mvx, mvy)
                continue
            if mb.kind != "inter":
                field.fill(bx, by, 4, 4, INTRA_REF, 0, 0)
                continue

            hint = getattr(mb, "hint_mv", None)
            # hint_mv forms: a single (x, y) (P_16x16 hint MBs), or a
            # tuple of per-partition (x, y) targets in mvds order (donor
            # MV retargeting: assign mvd = target - composite pred for
            # every partition of any mb_type).
            targets = None
            if hint is not None and hint and isinstance(hint[0], tuple):
                targets = hint
            new_mvds = []
            decoded = []

            def mv_of(part_i, px, py):
                if targets is not None:
                    tx, ty = targets[part_i]
                    new_mvds.append((tx - px, ty - py))
                    return tx, ty
                mvx = px + mb.mvds[part_i][0]
                mvy = py + mb.mvds[part_i][1]
                return mvx, mvy

            if mb.mb_type == 0:
                ref = mb.ref_idx[0] if mb.ref_idx else 0
                px, py = field.predict(bx, by, 4, ref)
                if hint is not None and targets is None:
                    mvx, mvy = hint
                    new_mvds.append((mvx - px, mvy - py))
                else:
                    mvx, mvy = mv_of(0, px, py)
                decoded.append((mvx, mvy))
                field.fill(bx, by, 4, 4, ref, mvx, mvy)
            elif mb.mb_type == 1:      # P_L0_L0_16x8 (two 16x8 partitions)
                for part in range(2):
                    pby = by + part * 2
                    ref = mb.ref_idx[part] if mb.ref_idx else 0
                    a, b, c = field.neighbors(bx, pby, 4)
                    # Directional rule (8.4.1.3): part 0 -> B, part 1 -> A
                    # when that neighbor's refIdx matches.
                    if part == 0 and b[3] and b[0] == ref:
                        px, py = b[1], b[2]
                    elif part == 1 and a[3] and a[0] == ref:
                        px, py = a[1], a[2]
                    else:
                        px, py = field.predict(bx, pby, 4, ref, a, b, c)
                    mvx, mvy = mv_of(part, px, py)
                    decoded.append((mvx, mvy))
                    field.fill(bx, pby, 4, 2, ref, mvx, mvy)
            elif mb.mb_type == 2:      # P_L0_L0_8x16 (two 8x16 partitions)
                for part in range(2):
                    pbx = bx + part * 2
                    ref = mb.ref_idx[part] if mb.ref_idx else 0
                    a, b, c = field.neighbors(pbx, by, 2)
                    # part 0 -> A, part 1 -> C when refIdx matches.
                    if part == 0 and a[3] and a[0] == ref:
                        px, py = a[1], a[2]
                    elif part == 1 and c[3] and c[0] == ref:
                        px, py = c[1], c[2]
                    else:
                        px, py = field.predict(pbx, by, 2, ref, a, b, c)
                    mvx, mvy = mv_of(part, px, py)
                    decoded.append((mvx, mvy))
                    field.fill(pbx, by, 2, 4, ref, mvx, mvy)
            elif mb.mb_type in (3, 4):  # P_8x8 / P_8x8ref0
                mv_i = 0
                for sub in range(4):
                    sbx = bx + (sub % 2) * 2
                    sby = by + (sub // 2) * 2
                    if mb.mb_type == 4 or not mb.ref_idx:
                        ref = 0
                    else:
                        ref = mb.ref_idx[sub]
                    smt = mb.sub_mb_types[sub]
                    w4, h4 = _SUB_GEOM[smt]
                    n_w, n_h = 2 // w4, 2 // h4
                    for j in range(n_h):
                        for i in range(n_w):
                            pbx, pby = sbx + i * w4, sby + j * h4
                            px, py = field.predict(pbx, pby, w4, ref)
                            mvx, mvy = mv_of(mv_i, px, py)
                            decoded.append((mvx, mvy))
                            field.fill(pbx, pby, w4, h4, ref, mvx, mvy)
                            mv_i += 1
            else:
                raise CAVLCError(f"bad inter mb_type {mb.mb_type}")

            mb.decoded_mvs = tuple(decoded)
            if hint is not None:
                mb.mvds = tuple(new_mvds)
                mb.hint_mv = None
    return field


def mb_level_mv(field: MVField, mb_x: int, mb_y: int):
    """Top-left 4x4 cell of an MB (sufficient for 16x16-only streams)."""
    return (int(field.ref[mb_y * 4, mb_x * 4]),
            int(field.mvx[mb_y * 4, mb_x * 4]),
            int(field.mvy[mb_y * 4, mb_x * 4]))
