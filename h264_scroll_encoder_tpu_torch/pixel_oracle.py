"""Pixel-level reconstruction oracle — the independent decode check.

Copy of h264_scroll_encoder_tpu/pixel_oracle.py (pure numpy) over the
port's own host modules (models/mb_transcode, models/mv_field,
ops/transform, ops/deblock, ops/bitio, syntax/parse).

The reference's pass/fail oracle is a real third-party decoder
(trans_resizer.c:2176-2186 shells to ffmpeg; scroll-encoder
scripts/test_encoder.sh:82-91 decodes and extracts frames for
inspection).  No decoder exists in this environment, so this module
implements the missing piece natively: a decoder *model* for the H.264
subset every composed stream lives in —

  - I_PCM intra frames (atlases decode to exact pixels),
  - inter prediction (P_L0 16x16/16x8/8x16/8x8 partitions and P_Skip)
    with edge-clamped motion compensation: full-pel luma (composed MVs
    are integer-pel) and 1/8-pel bilinear chroma (H.264 8.4.2.2.2),
  - full CAVLC residual reconstruction (ops/transform.py): inverse
    quant/transform for inter and intra MBs, Intra_4x4 / Intra_16x16 /
    chroma prediction — so spliced and transcoded streams carrying real
    donor residuals decode to exact pixels too (differentially tested
    against the system libavcodec in tests/test_avref.py),
  - exact reference-picture management: IDR long-term flag, MMCO 4/6/0
    marking, explicit ref-list modification (8.2.4.3), sliding window,
  - the in-loop deblocking filter (ops/deblock.py) for streams that
    enable it (x264 donors; every stream this framework emits disables
    the filter).

Unlike verify.py (grammar re-parse + MV-field decode), the output here is
*pixels*, compared by tests against intended compositions computed
directly from raw atlas content — so a systematic misunderstanding of
motion-compensation semantics (exactly the class of defect behind the
reference's KNOWN_ISSUES 16 px seam) fails pixel equality instead of
passing every structural check.

The slice-header/ref-list parse below is written against the spec,
independent of syntax/slice_headers.py (the emitter) — shared ancestry is
limited to the bit reader and the MB grammar parser.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models import mb_transcode as mbt
from .models import mv_field
from .ops import deblock
from .ops import transform as xf
from .ops.bitio import BitReader
from .ops.cavlc_tables import SCAN_TO_RASTER
from .syntax import parse


class UnsupportedStream(Exception):
    """Stream uses syntax outside the residual-free composition subset."""


@dataclasses.dataclass
class Picture:
    """One decoded picture (YUV420, uint8 planes)."""
    y: np.ndarray                 # (H, W)
    cb: np.ndarray                # (H/2, W/2)
    cr: np.ndarray                # (H/2, W/2)
    frame_num: int = 0
    long_term_idx: int | None = None
    is_ref: bool = False

    @classmethod
    def blank(cls, width: int, height: int) -> "Picture":
        return cls(np.zeros((height, width), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8))

    def copy(self) -> "Picture":
        return Picture(self.y.copy(), self.cb.copy(), self.cr.copy(),
                       self.frame_num, self.long_term_idx, self.is_ref)


# ---------------------------------------------------------------------------
# Slice header (independent parse capturing ref-list mod + MMCO verbatim).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SliceHeader:
    first_mb: int
    slice_type: int               # mod 5: 0=P, 2=I
    frame_num: int
    num_ref_idx_l0: int
    reorder_ops: list             # [(idc, value), ...]
    mmco_ops: list                # [(op, v1, v2), ...]
    long_term_reference_flag: int
    adaptive_marking: bool
    slice_qp_delta: int
    disable_deblock_idc: int      # 0 filter, 1 off, 2 skip slice edges
    alpha_off: int                # slice_alpha_c0_offset_div2 * 2
    beta_off: int                 # slice_beta_offset_div2 * 2
    data_bit: int                 # bit position of the first macroblock


def _parse_slice_header(rbsp: bytes, *, is_idr: bool, nal_ref_idc: int,
                        log2_max_frame_num: int,
                        num_ref_default: int) -> _SliceHeader:
    br = BitReader(rbsp)
    first_mb = br.read_ue()
    slice_type = br.read_ue() % 5
    br.read_ue()                                  # pps_id
    frame_num = br.read_bits(log2_max_frame_num)
    if is_idr:
        br.read_ue()                              # idr_pic_id
    # pic_order_cnt_type 2: no POC syntax (all composed streams).

    num_ref = num_ref_default
    reorder_ops = []
    if slice_type == 0:
        if br.read_bit():                         # num_ref_idx override
            num_ref = br.read_ue() + 1
        if br.read_bit():                         # ref_pic_list_mod l0
            while True:
                idc = br.read_ue()
                if idc == 3:
                    break
                reorder_ops.append((idc, br.read_ue()))

    lt_flag = 0
    adaptive = False
    mmco_ops = []
    if is_idr:
        br.read_bit()                             # no_output_of_prior_pics
        lt_flag = br.read_bit()
    elif nal_ref_idc != 0:
        adaptive = bool(br.read_bit())
        if adaptive:
            while True:
                op = br.read_ue()
                if op == 0:
                    break
                v1 = br.read_ue() if op in (1, 2, 3, 4, 6) else 0
                v2 = br.read_ue() if op == 3 else 0
                mmco_ops.append((op, v1, v2))

    slice_qp_delta = br.read_se()
    disable_deblock = br.read_ue()
    alpha_off = beta_off = 0
    if disable_deblock != 1:
        alpha_off = br.read_se() * 2
        beta_off = br.read_se() * 2
    return _SliceHeader(first_mb, slice_type, frame_num, num_ref,
                        reorder_ops, mmco_ops, lt_flag, adaptive,
                        slice_qp_delta, disable_deblock,
                        alpha_off, beta_off, br.bit_position)


# ---------------------------------------------------------------------------
# Reference list construction (8.2.4).
# ---------------------------------------------------------------------------

def _initial_list(short_term: list, long_term: dict, cur_frame_num: int,
                  max_frame_num: int) -> list:
    def pic_num(p: Picture) -> int:
        return (p.frame_num if p.frame_num <= cur_frame_num
                else p.frame_num - max_frame_num)

    st = sorted(short_term, key=pic_num, reverse=True)
    lt = [long_term[k] for k in sorted(long_term)]
    return st + lt


def _reorder_list(lst: list, ops: list, num_active: int, cur_frame_num: int,
                  max_frame_num: int, short_term: list,
                  long_term: dict) -> list:
    """8.2.4.3 explicit reference-list modification."""
    lst = list(lst)
    # Pad conceptually: the process may reference entries beyond
    # num_active during reordering; keep the full list and truncate last.
    ref_idx = 0
    pic_num_pred = cur_frame_num

    def pic_num_of(p: Picture) -> int:
        return (p.frame_num if p.frame_num <= cur_frame_num
                else p.frame_num - max_frame_num)

    for idc, val in ops:
        if idc in (0, 1):
            if idc == 0:
                no_wrap = pic_num_pred - (val + 1)
                if no_wrap < 0:
                    no_wrap += max_frame_num
            else:
                no_wrap = pic_num_pred + (val + 1)
                if no_wrap >= max_frame_num:
                    no_wrap -= max_frame_num
            pic_num_pred = no_wrap
            target = (no_wrap - max_frame_num
                      if no_wrap > cur_frame_num else no_wrap)
            match = next((p for p in short_term
                          if pic_num_of(p) == target), None)
        elif idc == 2:
            match = long_term.get(val)
        else:
            raise UnsupportedStream(f"reordering_of_pic_nums_idc {idc}")
        if match is None:
            raise UnsupportedStream(
                f"ref-list modification names a missing picture "
                f"(idc {idc}, value {val})")
        lst.insert(ref_idx, match)
        # Remove the later duplicate of the same picture.
        for j in range(ref_idx + 1, len(lst)):
            if lst[j] is match:
                del lst[j]
                break
        ref_idx += 1
    return lst[:num_active]


# ---------------------------------------------------------------------------
# Motion compensation (8.4.2.2) — vectorized over the slice band.
# ---------------------------------------------------------------------------

def _mc_band(field: mv_field.MVField, ref_list: list, band_y0_mb: int,
             out: Picture) -> None:
    """Paint inter-predicted pixels of one slice band into `out`.

    `field` covers the band only (rows 0..band_h); band_y0_mb is the
    band's first MB row in the frame.  Luma must be full-pel (composed
    streams are integer-pel by construction); chroma uses the spec's
    1/8-pel bilinear filter.
    """
    h4, w4 = field.ref.shape
    y0 = band_y0_mb * 16
    H, W = out.y.shape

    # Expand the 4x4-cell field to per-pixel maps.
    ref_px = np.repeat(np.repeat(field.ref, 4, 0), 4, 1)
    mvx_px = np.repeat(np.repeat(field.mvx, 4, 0), 4, 1)
    mvy_px = np.repeat(np.repeat(field.mvy, 4, 0), 4, 1)
    rows = np.arange(h4 * 4)[:, None] + y0
    cols = np.arange(w4 * 4)[None, :]

    # Integer-pel cells (every composed stream): vectorized copy.
    frac = (mvx_px % 4 != 0) | (mvy_px % 4 != 0)
    src_y = np.clip(rows + mvy_px // 4, 0, H - 1)
    src_x = np.clip(cols + mvx_px // 4, 0, W - 1)
    for ridx, ref_pic in enumerate(ref_list):
        m = (ref_px == ridx) & ~frac
        if not m.any():
            continue
        band = out.y[y0:y0 + h4 * 4]
        band[m] = ref_pic.y[src_y[m], src_x[m]]

    # Fractional cells (donor CAVLC content): 6-tap quarter-pel per
    # 4x4 cell (8.4.2.2.1).
    frac_cells = (field.ref >= 0) & ((field.mvx % 4 != 0)
                                     | (field.mvy % 4 != 0))
    for cy, cx in zip(*np.nonzero(frac_cells)):
        ref_pic = ref_list[field.ref[cy, cx]]
        blk = _luma_qpel_cell(ref_pic.y, y0 + cy * 4, cx * 4,
                              int(field.mvx[cy, cx]),
                              int(field.mvy[cy, cx]))
        out.y[y0 + cy * 4: y0 + cy * 4 + 4, cx * 4: cx * 4 + 4] = blk

    # Chroma: one value per 2x2 luma block; mv in 1/8 chroma-pel units is
    # numerically the luma qpel value (4:2:0, 8.4.1.4).
    ref_c = field.ref[::1, ::1]
    h2, w2 = h4 * 2, w4 * 2
    refc_px = np.repeat(np.repeat(ref_c, 2, 0), 2, 1)
    mvxc = np.repeat(np.repeat(field.mvx, 2, 0), 2, 1)
    mvyc = np.repeat(np.repeat(field.mvy, 2, 0), 2, 1)
    crows = np.arange(h2)[:, None] + band_y0_mb * 8
    ccols = np.arange(w2)[None, :]
    Hc, Wc = out.cb.shape

    x_int = ccols + (mvxc >> 3)
    y_int = crows + (mvyc >> 3)
    xf = mvxc & 7
    yf = mvyc & 7
    x0 = np.clip(x_int, 0, Wc - 1)
    x1 = np.clip(x_int + 1, 0, Wc - 1)
    yy0 = np.clip(y_int, 0, Hc - 1)
    yy1 = np.clip(y_int + 1, 0, Hc - 1)

    for ridx, ref_pic in enumerate(ref_list):
        m = refc_px == ridx
        if not m.any():
            continue
        for plane_out, plane_ref in ((out.cb, ref_pic.cb),
                                     (out.cr, ref_pic.cr)):
            a = plane_ref[yy0[m], x0[m]].astype(np.int32)
            b = plane_ref[yy0[m], x1[m]].astype(np.int32)
            c = plane_ref[yy1[m], x0[m]].astype(np.int32)
            d = plane_ref[yy1[m], x1[m]].astype(np.int32)
            fx, fy = xf[m], yf[m]
            val = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
                   + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
            band = plane_out[band_y0_mb * 8: band_y0_mb * 8 + h2]
            band[m] = val.astype(np.uint8)


def _luma_qpel_cell(ref: np.ndarray, py: int, px: int,
                    mvx: int, mvy: int) -> np.ndarray:
    """One 4x4 luma cell at quarter-pel MV (8.4.2.2.1): 6-tap half-pel
    filters + quarter averaging, edge-clamped."""
    H, W = ref.shape
    ix, fx = mvx >> 2, mvx & 3
    iy, fy = mvy >> 2, mvy & 3
    rows = np.clip(np.arange(py + iy - 2, py + iy + 7), 0, H - 1)
    cols = np.clip(np.arange(px + ix - 2, px + ix + 7), 0, W - 1)
    R = ref[np.ix_(rows, cols)].astype(np.int64)          # 9x9

    def tap(v, axis):
        sl = [slice(None)] * v.ndim
        out = None
        for k, w in enumerate((1, -5, 20, 20, -5, 1)):
            sl[axis] = slice(k, v.shape[axis] - 5 + k)
            term = w * v[tuple(sl)]
            out = term if out is None else out + term
        return out

    b1 = tap(R, 1)                                        # (9, 4+)
    h1 = tap(R, 0)                                        # (4+, 9)
    j1 = tap(b1, 0)                                       # center taps
    b = np.clip((b1 + 16) >> 5, 0, 255)
    h = np.clip((h1 + 16) >> 5, 0, 255)
    j = np.clip((j1 + 512) >> 10, 0, 255)

    yy = np.arange(4)[:, None]
    xx = np.arange(4)[None, :]
    G = R[2 + yy, 2 + xx]
    Hn = R[2 + yy, 3 + xx]
    Mn = R[3 + yy, 2 + xx]
    bb = b[2 + yy, 0 + xx]          # half right of G
    ss = b[3 + yy, 0 + xx]          # half right of the row below
    hh = h[0 + yy, 2 + xx]          # half below G
    mm = h[0 + yy, 3 + xx]          # half below the right column
    jj = j[0 + yy, 0 + xx]

    if fy == 0:
        if fx == 0:
            v = G
        elif fx == 2:
            v = bb
        elif fx == 1:
            v = (G + bb + 1) >> 1
        else:
            v = (Hn + bb + 1) >> 1
    elif fx == 0:
        if fy == 2:
            v = hh
        elif fy == 1:
            v = (G + hh + 1) >> 1
        else:
            v = (Mn + hh + 1) >> 1
    elif fx == 2 and fy == 2:
        v = jj
    elif fy == 2:                   # (1,2) / (3,2)
        v = (hh + jj + 1) >> 1 if fx == 1 else (mm + jj + 1) >> 1
    elif fx == 2:                   # (2,1) / (2,3)
        v = (bb + jj + 1) >> 1 if fy == 1 else (ss + jj + 1) >> 1
    else:                           # diagonal quarters
        a = bb if fy == 1 else ss
        c = hh if fx == 1 else mm
        v = (a + c + 1) >> 1
    return np.clip(v, 0, 255).astype(np.uint8)


def _paint_ipcm(mb, mb_x: int, mb_y: int, out: Picture) -> None:
    s = np.frombuffer(mb.ipcm_samples, np.uint8)
    out.y[mb_y * 16:(mb_y + 1) * 16, mb_x * 16:(mb_x + 1) * 16] = \
        s[:256].reshape(16, 16)
    out.cb[mb_y * 8:(mb_y + 1) * 8, mb_x * 8:(mb_x + 1) * 8] = \
        s[256:320].reshape(8, 8)
    out.cr[mb_y * 8:(mb_y + 1) * 8, mb_x * 8:(mb_x + 1) * 8] = \
        s[320:384].reshape(8, 8)


# ---------------------------------------------------------------------------
# Residual / intra reconstruction (raster walk over one slice band).
# ---------------------------------------------------------------------------

class _BandReconstructor:
    """Raster-order reconstruction of residuals and intra macroblocks.

    Inter prediction (painted beforehand by _mc_band) depends only on
    reference pictures, but intra prediction reads the current frame's
    reconstructed neighbor samples — including inter neighbors' final
    prediction+residual pixels — so the walk adds inter residuals and
    reconstructs intra MBs in a single raster pass (7.4.5 QP chaining
    rides the same walk)."""

    def __init__(self, chroma_qp_index_offset: int):
        self.cqo = chroma_qp_index_offset

    def run(self, grid, row0: int, slice_qp: int, pic: Picture):
        mbw = len(grid[0])
        rows = len(grid)
        qp = slice_qp % 52
        # Deblocking inputs collected along the walk.
        qp_grid = np.zeros((rows, mbw), np.int32)
        intra = np.zeros((rows, mbw), bool)
        nnz = np.zeros((rows * 4, mbw * 4), np.int32)
        # Per-MB Intra_4x4 mode memory for 8.3.1.1 prediction: a list of
        # 16 modes, or "coded" for any other coded/skipped MB (which
        # contributes DC=2), or None when outside the slice.
        modes = [[None] * mbw for _ in grid]
        for r, row in enumerate(grid):
            for c, mb in enumerate(row):
                if mb is mbt.SKIP:
                    modes[r][c] = "coded"
                    qp_grid[r, c] = qp
                    continue
                if mb.qp_delta is not None:
                    qp = (qp + mb.qp_delta + 52) % 52
                qp_grid[r, c] = qp
                if mb.kind != "inter":
                    intra[r, c] = True
                if mb.kind == "ipcm":
                    _paint_ipcm(mb, c, row0 + r, pic)
                    modes[r][c] = "coded"
                    qp_grid[r, c] = 0      # I_PCM: QPy = 0 for filtering
                    nnz[r * 4:r * 4 + 4, c * 4:c * 4 + 4] = 16
                    continue
                dc_marker = (16 if mb.kind == "i16x16" and mb.luma_dc
                             is not None and mb.luma_dc.total_coeff
                             else 0)
                for raster in range(16):
                    nnz[r * 4 + raster // 4, c * 4 + raster % 4] = \
                        mb.luma[raster].total_coeff + dc_marker
                if mb.kind == "inter":
                    if mb.cbp:
                        self._add_inter_residual(mb, c, row0 + r, qp, pic)
                    modes[r][c] = "coded"
                elif mb.kind == "i16x16":
                    self._recon_i16(mb, r, c, row0, qp, pic)
                    modes[r][c] = "coded"
                elif mb.kind == "i4x4":
                    modes[r][c] = self._recon_i4x4(mb, r, c, row0, qp,
                                                   pic, modes, mbw)
                else:
                    raise UnsupportedStream(f"mb kind {mb.kind}")
        return qp_grid, intra, nnz

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _add_clip(plane, y0, x0, res):
        reg = plane[y0:y0 + 4, x0:x0 + 4].astype(np.int64) + res
        plane[y0:y0 + 4, x0:x0 + 4] = np.clip(reg, 0, 255).astype(np.uint8)

    def _add_inter_residual(self, mb, mbx, mby, qp, pic):
        y0, x0 = mby * 16, mbx * 16
        for raster in range(16):
            blk = mb.luma[raster]
            if blk.total_coeff == 0:
                continue
            res = xf.residual_4x4(xf.coeff_scan(blk, 16), qp)
            self._add_clip(pic.y, y0 + raster // 4 * 4,
                           x0 + raster % 4 * 4, res)
        self._add_chroma_residual(mb, mbx, mby, qp, pic)

    def _add_chroma_residual(self, mb, mbx, mby, qp, pic):
        cbp_chroma = (mb.cbp >> 4) & 3
        if not cbp_chroma:
            return
        qpc = xf.chroma_qp(qp, self.cqo)
        cy0, cx0 = mby * 8, mbx * 8
        for plane, dcb, acb in ((pic.cb, mb.cb_dc, mb.chroma_ac[0]),
                                (pic.cr, mb.cr_dc, mb.chroma_ac[1])):
            resids = xf.chroma_residuals(
                dcb, acb if cbp_chroma == 2 else None, qpc)
            for blk_i, res in enumerate(resids):
                self._add_clip(plane, cy0 + blk_i // 2 * 4,
                               cx0 + blk_i % 2 * 4, res)

    def _recon_chroma_intra(self, mb, r, c, row0, qp, pic):
        avail_l, avail_t = c > 0, r > 0
        cy0, cx0 = (row0 + r) * 8, c * 8
        qpc = xf.chroma_qp(qp, self.cqo)
        cbp_chroma = (mb.cbp >> 4) & 3
        for plane, dcb, acb in ((pic.cb, mb.cb_dc, mb.chroma_ac[0]),
                                (pic.cr, mb.cr_dc, mb.chroma_ac[1])):
            left = plane[cy0:cy0 + 8, cx0 - 1] if avail_l else None
            top = plane[cy0 - 1, cx0:cx0 + 8] if avail_t else None
            tl = plane[cy0 - 1, cx0 - 1] if (avail_l and avail_t) else 0
            out = xf.pred_chroma(mb.chroma_pred, left, top, tl,
                                 avail_l, avail_t)
            if cbp_chroma:
                resids = xf.chroma_residuals(
                    dcb, acb if cbp_chroma == 2 else None, qpc)
                for blk_i, res in enumerate(resids):
                    by, bx = blk_i // 2 * 4, blk_i % 2 * 4
                    out[by:by + 4, bx:bx + 4] += res
            plane[cy0:cy0 + 8, cx0:cx0 + 8] = \
                np.clip(out, 0, 255).astype(np.uint8)

    def _recon_i16(self, mb, r, c, row0, qp, pic):
        avail_l, avail_t = c > 0, r > 0
        y0, x0 = (row0 + r) * 16, c * 16
        left = pic.y[y0:y0 + 16, x0 - 1] if avail_l else None
        top = pic.y[y0 - 1, x0:x0 + 16] if avail_t else None
        tl = pic.y[y0 - 1, x0 - 1] if (avail_l and avail_t) else 0
        out = xf.pred16x16(mb.i16_idx % 4, left, top, tl,
                           avail_l, avail_t).copy()
        res16 = xf.luma16_residuals(mb.luma_dc, mb.luma, qp)
        for raster in range(16):
            by, bx = raster // 4 * 4, raster % 4 * 4
            out[by:by + 4, bx:bx + 4] += res16[raster]
        pic.y[y0:y0 + 16, x0:x0 + 16] = np.clip(out, 0, 255).astype(np.uint8)
        self._recon_chroma_intra(mb, r, c, row0, qp, pic)

    def _recon_i4x4(self, mb, r, c, row0, qp, pic, modes_mem, mbw):
        left_mem = modes_mem[r][c - 1] if c > 0 else None
        top_mem = modes_mem[r - 1][c] if r > 0 else None
        lm = None if left_mem is None else (
            [2] * 4 if left_mem == "coded"
            else [left_mem[i * 4 + 3] for i in range(4)])
        tm = None if top_mem is None else (
            [2] * 4 if top_mem == "coded"
            else [top_mem[12 + i] for i in range(4)])
        modes = xf.decode_i4x4_modes(mb.pred_mode_bits, lm, tm)

        pos_of = {raster: z for z, raster in enumerate(SCAN_TO_RASTER)}
        y0, x0 = (row0 + r) * 16, c * 16
        for z in range(16):
            raster = SCAN_TO_RASTER[z]
            brow, bcol = raster // 4, raster % 4
            py, px = y0 + brow * 4, x0 + bcol * 4
            al = bcol > 0 or c > 0
            at = brow > 0 or r > 0
            atl = (bcol > 0 or c > 0) and (brow > 0 or r > 0)
            if brow == 0:
                atr = (r > 0) if bcol < 3 else (r > 0 and c < mbw - 1)
            else:
                atr = bcol < 3 and pos_of[raster - 3] < z
            left = pic.y[py:py + 4, px - 1] if al else None
            top = pic.y[py - 1, px:px + 4] if at else None
            tl = pic.y[py - 1, px - 1] if atl else 0
            tr = pic.y[py - 1, px + 4:px + 8] if atr else None
            out = xf.pred4x4(modes[raster], left, top, tl, tr,
                             al, at, atl, atr)
            blk = mb.luma[raster]
            if blk.total_coeff:
                out = out + xf.residual_4x4(xf.coeff_scan(blk, 16), qp)
            pic.y[py:py + 4, px:px + 4] = \
                np.clip(out, 0, 255).astype(np.uint8)
        self._recon_chroma_intra(mb, r, c, row0, qp, pic)
        return modes


# ---------------------------------------------------------------------------
# The decoder model.
# ---------------------------------------------------------------------------

class DecoderModel:
    """Stream-level decode: DPB + per-frame reconstruction."""

    def __init__(self):
        self.sps = None
        self.pps = None
        self.short_term: list = []
        self.long_term: dict = {}
        self.max_num_ref_frames = 16
        self.output: list = []
        self._pending: list = []      # slices of the current frame

    # -- public API ----------------------------------------------------------

    def decode(self, data: bytes) -> list:
        """Decode an Annex-B stream -> list of Picture in decode order."""
        for unit in parse.iter_nal_units(data):
            t = unit.nal_unit_type
            if t == 7:
                self.sps = parse.parse_sps(unit.rbsp)
            elif t == 8:
                self.pps = parse.parse_pps(unit.rbsp)
            elif t in (1, 5):
                self._slice(unit, is_idr=(t == 5))
            elif t in (6, 9):
                continue
            else:
                raise UnsupportedStream(f"NAL type {t}")
        self._flush()
        return self.output

    # -- frame assembly ------------------------------------------------------

    def _slice(self, unit, *, is_idr: bool) -> None:
        if self.sps is None or self.pps is None:
            raise UnsupportedStream("slice before SPS/PPS")
        hdr = _parse_slice_header(
            unit.rbsp, is_idr=is_idr, nal_ref_idc=unit.nal_ref_idc,
            log2_max_frame_num=self.sps.log2_max_frame_num,
            num_ref_default=(
                self.pps.num_ref_idx_l0_default_active_minus1 + 1))
        if hdr.first_mb == 0:
            self._flush()
        self._pending.append((unit, hdr, is_idr))

    def _flush(self) -> None:
        if not self._pending:
            return
        slices, self._pending = self._pending, []
        mbw = self.sps.width // 16
        mbh = self.sps.height // 16
        _, hdr0, is_idr = slices[0]

        if is_idr:
            # 8.2.5.1: IDR clears the DPB before decoding.
            self.short_term = []
            self.long_term = {}

        pic = Picture.blank(self.sps.width, self.sps.height)
        pic.frame_num = hdr0.frame_num

        meta = deblock.MBMeta(
            qp=np.zeros((mbh, mbw), np.int32),
            qpc=np.zeros((mbh, mbw), np.int32),
            intra=np.zeros((mbh, mbw), bool),
            nnz=np.zeros((mbh * 4, mbw * 4), np.int32),
            ref_id=np.full((mbh * 4, mbw * 4), -1, np.int32),
            mvx=np.zeros((mbh * 4, mbw * 4), np.int32),
            mvy=np.zeros((mbh * 4, mbw * 4), np.int32),
            disable=np.ones((mbh, mbw), np.int32),
            alpha_off=np.zeros((mbh, mbw), np.int32),
            beta_off=np.zeros((mbh, mbw), np.int32),
            slice_id=np.zeros((mbh, mbw), np.int32),
        )
        ref_tokens: dict = {}

        starts = [h.first_mb for _, h, _ in slices]
        ends = starts[1:] + [mbw * mbh]
        for sid, ((unit, hdr, _), start, end) in enumerate(
                zip(slices, starts, ends)):
            if start % mbw or (end - start) % mbw or end <= start:
                raise UnsupportedStream("slice bands must be MB-row aligned")
            self._decode_slice(unit, hdr, start // mbw,
                               (end - start) // mbw, mbw, pic,
                               meta, sid, ref_tokens)

        if (meta.disable != 1).any():
            deblock.filter_frame(pic, meta)

        self._mark(pic, slices[0])
        self.output.append(pic)

    # -- slice decode ---------------------------------------------------------

    def _decode_slice(self, unit, hdr: _SliceHeader, row0: int, rows: int,
                      mbw: int, pic: Picture, meta, sid: int,
                      ref_tokens: dict) -> None:
        br = BitReader(unit.rbsp)
        br.skip_bits(hdr.data_bit)
        slice_qp = (26 + self.pps.pic_init_qp_minus26 + hdr.slice_qp_delta)

        field = ref_list = None
        if hdr.slice_type == 2:
            grid = mbt.parse_i_slice_mbs(br, mbw, rows)
        elif hdr.slice_type == 0:
            max_fn = 1 << self.sps.log2_max_frame_num
            ref_list = _initial_list(self.short_term, self.long_term,
                                     hdr.frame_num, max_fn)
            if hdr.reorder_ops:
                ref_list = _reorder_list(ref_list, hdr.reorder_ops,
                                         hdr.num_ref_idx_l0, hdr.frame_num,
                                         max_fn, self.short_term,
                                         self.long_term)
            else:
                ref_list = ref_list[:hdr.num_ref_idx_l0]
            if len(ref_list) < hdr.num_ref_idx_l0:
                raise UnsupportedStream(
                    f"active refs {hdr.num_ref_idx_l0} > DPB refs "
                    f"{len(ref_list)}")
            grid = mbt.parse_p_slice_mbs(br, mbw, rows, hdr.num_ref_idx_l0)
            field = mv_field.decode_p_slice_mv_field(grid, mbw, rows)
            _mc_band(field, ref_list, row0, pic)
        else:
            raise UnsupportedStream(f"slice_type {hdr.slice_type}")

        qp_grid, intra, nnz = _BandReconstructor(
            self.pps.chroma_qp_index_offset).run(grid, row0, slice_qp, pic)

        # Deblocking metadata for this band.
        rs = slice(row0, row0 + rows)
        bs4 = slice(row0 * 4, (row0 + rows) * 4)
        meta.qp[rs] = qp_grid
        meta.qpc[rs] = np.vectorize(
            lambda q: xf.chroma_qp(q, self.pps.chroma_qp_index_offset)
        )(qp_grid)
        meta.intra[rs] = intra
        meta.nnz[bs4] = nnz
        meta.disable[rs] = hdr.disable_deblock_idc
        meta.alpha_off[rs] = hdr.alpha_off
        meta.beta_off[rs] = hdr.beta_off
        meta.slice_id[rs] = sid
        if field is not None:
            tok = np.full(len(ref_list), -1, np.int32)
            for i, rp in enumerate(ref_list):
                tok[i] = ref_tokens.setdefault(id(rp), len(ref_tokens))
            inter = field.ref >= 0
            # Row-slice views: fancy assignment lands in the frame arrays.
            meta.ref_id[bs4][inter] = tok[field.ref[inter]]
            meta.mvx[bs4][inter] = field.mvx[inter]
            meta.mvy[bs4][inter] = field.mvy[inter]

    # -- reference marking (8.2.5) --------------------------------------------

    def _mark(self, pic: Picture, first_slice) -> None:
        unit, hdr, is_idr = first_slice
        if unit.nal_ref_idc == 0:
            return
        stored = pic.copy()
        stored.is_ref = True
        if is_idr:
            if hdr.long_term_reference_flag:
                stored.long_term_idx = 0
                self.long_term = {0: stored}
            else:
                self.short_term = [stored]
            return
        if hdr.adaptive_marking:
            for op, v1, v2 in hdr.mmco_ops:
                if op == 4:      # max_long_term_frame_idx_plus1
                    self.long_term = {k: v for k, v in self.long_term.items()
                                      if k <= v1 - 1}
                elif op == 6:    # mark current as long-term v1
                    stored.long_term_idx = v1
                    self.long_term[v1] = stored
                elif op == 1:    # unmark short-term
                    max_fn = 1 << self.sps.log2_max_frame_num
                    target = hdr.frame_num - (v1 + 1)
                    if target < 0:
                        target += max_fn
                    self.short_term = [
                        p for p in self.short_term
                        if p.frame_num % max_fn != target % max_fn]
                elif op == 5:    # clear all
                    self.short_term = []
                    self.long_term = {}
                else:
                    raise UnsupportedStream(f"MMCO op {op}")
            if stored.long_term_idx is None:
                self._sliding_window(stored)
        else:
            self._sliding_window(stored)

    def _sliding_window(self, stored: Picture) -> None:
        self.short_term.append(stored)
        while (len(self.short_term) + len(self.long_term)
               > self.max_num_ref_frames and self.short_term):
            self.short_term.pop(0)


def decode_stream_pixels(data: bytes) -> list:
    """Convenience: Annex-B bytes -> [Picture, ...] in decode order."""
    return DecoderModel().decode(data)


# ---------------------------------------------------------------------------
# Intended-composition helpers (what the pixels *should* be).
# ---------------------------------------------------------------------------

def scroll_canvas(atlas_a: Picture, atlas_b: Picture) -> Picture:
    """The virtual 2H-tall scroll surface: atlas A stacked above B."""
    return Picture(np.vstack([atlas_a.y, atlas_b.y]),
                   np.vstack([atlas_a.cb, atlas_b.cb]),
                   np.vstack([atlas_a.cr, atlas_b.cr]))


def intended_scroll_luma(canvas: Picture, offset_px: int,
                         height: int) -> np.ndarray:
    """Ideal scrolled frame luma: the canvas window at offset."""
    return canvas.y[offset_px: offset_px + height]


def luma_mismatch_rows(decoded: Picture, intended_y: np.ndarray):
    """Row indices where any luma pixel differs from the intended frame."""
    diff = decoded.y.astype(np.int32) != intended_y.astype(np.int32)
    return np.nonzero(diff.any(axis=1))[0]


def seam_band(height: int, offset_px: int,
              boundary_policy: str = "floor") -> tuple:
    """Predicted seam mismatch band [start_row, end_row) for one scroll
    hop: MB-granular region split vs per-pixel content motion
    (KNOWN_ISSUES.md:5-13; docs/KNOWN_ISSUES_ANALYSIS.md).

    floor:   rows [16*((H-d)//16), H-d)          — width (H-d) % 16 <= 15
    nearest: the band straddles H-d by at most 8 rows either side.
    """
    split = height - offset_px
    if boundary_policy == "floor":
        start = 16 * (split // 16)
        return start, split
    if boundary_policy == "partitioned":
        return seam_band_partitioned(height, offset_px)
    start = 16 * ((split + 8) // 16)
    return (split, start) if start >= split else (start, split)


def seam_band_partitioned(height: int, offset_px: int) -> tuple:
    """'partitioned' policy band: the seam rounds to the nearest 8 px
    (16x8 partitions), so the band straddles H-d by at most 4 rows."""
    split = height - offset_px
    snapped = 8 * ((split + 4) // 8)
    return (split, snapped) if snapped >= split else (snapped, split)
