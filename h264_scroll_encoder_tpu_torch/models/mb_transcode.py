"""Macroblock-level CAVLC slice parsing and re-emission (host reference).

Copied unchanged from h264_scroll_encoder_tpu/models/mb_transcode.py (it
has no framework dependency), so the port runs where jax is absent.

This is the donor-ingest / bitstream-surgery layer: parse every macroblock
of a CAVLC I- or P-slice into a structured record, then re-emit at new
macroblock addresses with *recomputed* nC contexts and restitched
mb_skip_run grammar.  Behavioral parity targets in the reference:

  - process_i_slice     (experiments/trans-resizer/trans_resizer.c:1063-1357)
  - process_p_slice     (:1486-1782)
  - copy_i4x4_residual / copy_i16x16_residual / copy_inter_residual
                        (:887-1058, :1362-1452)

Unlike the reference (which copies residual bits verbatim and therefore
can only append padding that never changes an existing block's nC), the
emitter re-encodes each block's coeff_token under the nC of the *output*
geometry — the repair that arbitrary-position dynamic-rect splicing needs
(docs/MASTER_DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses

from ..ops import cavlc
from ..ops.bitio import BitReader, BitWriter
from ..ops.cavlc import MBCoeffContext, ResidualBlock
from ..ops.cavlc_tables import (CBP_INTER, CBP_INTER_INV, CBP_INTRA,
                                CBP_INTRA_INV, SCAN_TO_RASTER)

# Sub-macroblock MV counts per sub_mb_type (trans_resizer.c:1471).
SUB_MB_MVS = (1, 2, 2, 4)


@dataclasses.dataclass
class Macroblock:
    """One parsed macroblock, re-emittable at any address."""
    kind: str                     # 'inter' | 'i4x4' | 'i16x16' | 'ipcm'
    mb_type: int                  # type code within its slice taxonomy
    # inter fields
    sub_mb_types: tuple = ()
    ref_idx: tuple = ()
    mvds: tuple = ()              # ((x, y), ...)
    # intra fields
    pred_mode_bits: str = ""      # raw intra-4x4 pred-mode bits (verbatim)
    chroma_pred: int = 0
    # common
    cbp: int = 0
    qp_delta: int | None = None
    ipcm_samples: bytes = b""
    i16_idx: int = -1             # I_16x16 geometry index (0..23)
    hint_mv: tuple | None = None  # desired (mvx,mvy) qpel; resolved by
                                  # mv_field.decode_p_slice_mv_field
    # residual: luma DC (I_16x16), 16 luma 4x4 (raster order), chroma
    luma_dc: ResidualBlock | None = None
    luma: tuple = dataclasses.field(
        default_factory=lambda: (cavlc.EMPTY_BLOCK,) * 16)
    cb_dc: ResidualBlock | None = None
    cr_dc: ResidualBlock | None = None
    chroma_ac: tuple = dataclasses.field(
        default_factory=lambda: ((cavlc.EMPTY_BLOCK,) * 4,) * 2)

    def coeff_context(self, bug_compat: bool = False) -> MBCoeffContext:
        if self.kind == "ipcm":
            return ipcm_context(bug_compat)
        ctx = MBCoeffContext()
        if self.luma:
            ctx.luma_tc = [b.total_coeff for b in self.luma]
        if self.chroma_ac:
            ctx.chroma_tc = [[b.total_coeff for b in plane]
                             for plane in self.chroma_ac]
        return ctx


SKIP = None  # placeholder in MB grids for P_Skip macroblocks


def ipcm_context(bug_compat: bool = False) -> MBCoeffContext:
    """The nC context an I_PCM macroblock presents to its neighbors.

    H.264 9.2.1 (and a real decoder, e.g. libavcodec): an available
    I_PCM neighbor contributes nN = 16.  The reference instead zeroes
    the context (trans_resizer.c:1241-1243, contradicting its own README
    note "I_PCM neighbors contribute nC=16") — reference defect #5: a
    coded MB beside an I_PCM MB then picks the wrong coeff_token table
    and any conformant decoder desyncs.  The defect is latent in the
    reference's own use (x264 donors never emit I_PCM, and its padding
    columns never sit left of coded MBs), but any synthetic stream
    interleaving I_PCM with coded MBs trips it.  bug_compat=True
    reproduces the zeroed rule for byte parity with the C binary."""
    if bug_compat:
        return MBCoeffContext()
    return MBCoeffContext(luma_tc=[16] * 16,
                          chroma_tc=[[16] * 4, [16] * 4])


def _intra16_geometry(idx: int) -> tuple:
    """I_16x16 type index -> (cbp_luma, cbp_chroma)."""
    return (15 if idx // 12 else 0), (idx // 4) % 3


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

class _CtxTracker:
    """Rolling left/top MBCoeffContext over a fixed-width MB grid."""

    def __init__(self, mb_width: int):
        self.mb_width = mb_width
        self.top = [None] * mb_width     # previous row's contexts
        self.cur = [None] * mb_width
        self.left = None

    def neighbors(self, col: int):
        left = self.left if col > 0 else None
        top = self.top[col]
        return left, top

    def push(self, col: int, ctx: MBCoeffContext):
        self.cur[col] = ctx
        self.left = ctx

    def end_row(self):
        self.top = self.cur
        self.cur = [None] * self.mb_width
        self.left = None


def _parse_residual_luma_inter(br, cbp_luma, ctx, left, top):
    """16 luma 4x4 blocks in scan order, maxNumCoeff 16."""
    blocks = [cavlc.EMPTY_BLOCK] * 16
    for i8x8 in range(4):
        if cbp_luma & (1 << i8x8):
            for i4x4 in range(4):
                raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                nC = cavlc.luma_nC(raster, ctx, left, top)
                blk = cavlc.read_residual_block(br, nC, 16)
                blocks[raster] = blk
                ctx.luma_tc[raster] = blk.total_coeff
    return tuple(blocks)


def _parse_residual_chroma(br, cbp_chroma, ctx, left, top):
    cb_dc = cr_dc = None
    chroma_ac = ((cavlc.EMPTY_BLOCK,) * 4, (cavlc.EMPTY_BLOCK,) * 4)
    if cbp_chroma > 0:
        cb_dc = cavlc.read_residual_block(br, -1, 4)
        cr_dc = cavlc.read_residual_block(br, -1, 4)
        if cbp_chroma == 2:
            planes = []
            for c in range(2):
                blks = []
                for i in range(4):
                    nC = cavlc.chroma_nC(c, i, ctx, left, top)
                    blk = cavlc.read_residual_block(br, nC, 15)
                    blks.append(blk)
                    ctx.chroma_tc[c][i] = blk.total_coeff
                planes.append(tuple(blks))
            chroma_ac = tuple(planes)
    return cb_dc, cr_dc, chroma_ac


def _parse_i4x4_mb(br, mb_type_i: int, tracker, col, *, in_p_slice):
    left, top = tracker.neighbors(col)
    ctx = MBCoeffContext()
    bits = []
    for _ in range(16):
        prev = br.read_bit()
        bits.append(str(prev))
        if not prev:
            bits.append(format(br.read_bits(3), "03b"))
    pred_mode_bits = "".join(bits)
    chroma_pred = br.read_ue()
    if chroma_pred > 3:
        raise cavlc.CAVLCError(f"invalid chroma_pred {chroma_pred}")
    cbp_code = br.read_ue()
    cbp = CBP_INTRA[cbp_code] if cbp_code < 48 else 0
    qp_delta = None
    luma = (cavlc.EMPTY_BLOCK,) * 16
    cb_dc = cr_dc = None
    chroma_ac = ((cavlc.EMPTY_BLOCK,) * 4, (cavlc.EMPTY_BLOCK,) * 4)
    if cbp > 0:
        qp_delta = br.read_se()
        luma = _parse_residual_luma_inter(br, cbp & 0xF, ctx, left, top)
        cb_dc, cr_dc, chroma_ac = _parse_residual_chroma(
            br, (cbp >> 4) & 0x3, ctx, left, top)
    mb = Macroblock(kind="i4x4", mb_type=5 if in_p_slice else 0,
                    pred_mode_bits=pred_mode_bits, chroma_pred=chroma_pred,
                    cbp=cbp, qp_delta=qp_delta, luma=luma, cb_dc=cb_dc,
                    cr_dc=cr_dc, chroma_ac=chroma_ac)
    tracker.push(col, ctx)
    return mb


def _parse_i16x16_mb(br, mb_type: int, idx: int, tracker, col):
    left, top = tracker.neighbors(col)
    ctx = MBCoeffContext()
    cbp_luma, cbp_chroma = _intra16_geometry(idx)
    chroma_pred = br.read_ue()
    if chroma_pred > 3:
        raise cavlc.CAVLCError(f"invalid chroma_pred {chroma_pred}")
    qp_delta = br.read_se()

    dc_nC = cavlc.luma_nC(0, ctx, left, top)
    luma_dc = cavlc.read_residual_block(br, dc_nC, 16)

    luma = [cavlc.EMPTY_BLOCK] * 16
    for i8x8 in range(4):
        for i4x4 in range(4):
            raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
            if cbp_luma & (1 << i8x8):
                nC = cavlc.luma_nC(raster, ctx, left, top)
                blk = cavlc.read_residual_block(br, nC, 15)
                luma[raster] = blk
                ctx.luma_tc[raster] = blk.total_coeff
    cb_dc, cr_dc, chroma_ac = _parse_residual_chroma(
        br, cbp_chroma, ctx, left, top)
    mb = Macroblock(kind="i16x16", mb_type=mb_type, chroma_pred=chroma_pred,
                    cbp=(cbp_chroma << 4) | cbp_luma, qp_delta=qp_delta,
                    luma_dc=luma_dc, luma=tuple(luma), cb_dc=cb_dc,
                    cr_dc=cr_dc, chroma_ac=chroma_ac, i16_idx=idx)
    tracker.push(col, ctx)
    return mb


def _parse_ipcm_mb(br, mb_type: int, tracker, col, *, bug_compat=False):
    br.align()
    samples = br.read_bytes_aligned(384)
    tracker.push(col, ipcm_context(bug_compat))
    return Macroblock(kind="ipcm", mb_type=mb_type, ipcm_samples=samples)


def _parse_inter_mb(br, mb_type: int, num_ref_idx_l0: int, tracker, col):
    left, top = tracker.neighbors(col)
    ctx = MBCoeffContext()

    if mb_type == 0:
        num_partitions = 1
    elif mb_type <= 2:
        num_partitions = 2
    else:
        num_partitions = 4

    sub_mb_types = ()
    if mb_type >= 3:
        sub_mb_types = tuple(br.read_ue() for _ in range(4))
        if any(smt > 3 for smt in sub_mb_types):
            # P-slice sub_mb_type is 0..3 (Table 7-17); mirror the native
            # parser's rejection (native/cavlc_decode.cpp parse_inter).
            raise cavlc.CAVLCError(f"invalid P sub_mb_type {sub_mb_types}")

    ref_idx = ()
    if num_ref_idx_l0 > 1 and mb_type != 4:
        n_refs = 4 if mb_type == 3 else num_partitions
        max_ref = num_ref_idx_l0 - 1
        if max_ref == 1:
            # te(1): single *inverted* bit (H.264 9.1.1) — store semantic.
            ref_idx = tuple(1 - br.read_bit() for _ in range(n_refs))
        else:
            ref_idx = tuple(br.read_ue() for _ in range(n_refs))

    mvds = []
    if mb_type < 3:
        for _ in range(num_partitions):
            mvds.append((br.read_se(), br.read_se()))
    else:
        for smt in sub_mb_types:
            n = SUB_MB_MVS[smt]
            for _ in range(n):
                mvds.append((br.read_se(), br.read_se()))

    cbp_code = br.read_ue()
    cbp = CBP_INTER[cbp_code] if cbp_code < 48 else 0
    qp_delta = None
    luma = (cavlc.EMPTY_BLOCK,) * 16
    cb_dc = cr_dc = None
    chroma_ac = ((cavlc.EMPTY_BLOCK,) * 4, (cavlc.EMPTY_BLOCK,) * 4)
    if cbp > 0:
        qp_delta = br.read_se()
        luma = _parse_residual_luma_inter(br, cbp & 0xF, ctx, left, top)
        cb_dc, cr_dc, chroma_ac = _parse_residual_chroma(
            br, (cbp >> 4) & 0x3, ctx, left, top)

    mb = Macroblock(kind="inter", mb_type=mb_type,
                    sub_mb_types=sub_mb_types, ref_idx=ref_idx,
                    mvds=tuple(mvds), cbp=cbp, qp_delta=qp_delta,
                    luma=luma, cb_dc=cb_dc, cr_dc=cr_dc, chroma_ac=chroma_ac)
    tracker.push(col, ctx)
    return mb


def parse_i_slice_mbs(br: BitReader, mb_width: int, mb_height: int, *,
                      bug_compat: bool = False) -> list:
    """-> row-major grid of Macroblocks."""
    tracker = _CtxTracker(mb_width)
    grid = []
    for _row in range(mb_height):
        row_mbs = []
        for col in range(mb_width):
            mb_type = br.read_ue()
            if mb_type == 0:
                mb = _parse_i4x4_mb(br, mb_type, tracker, col,
                                    in_p_slice=False)
            elif 1 <= mb_type <= 24:
                mb = _parse_i16x16_mb(br, mb_type, mb_type - 1, tracker, col)
            elif mb_type == 25:
                mb = _parse_ipcm_mb(br, mb_type, tracker, col,
                                    bug_compat=bug_compat)
            else:
                raise cavlc.CAVLCError(f"unknown I mb_type {mb_type}")
            row_mbs.append(mb)
        tracker.end_row()
        grid.append(row_mbs)
    return grid


def parse_p_slice_mbs(br: BitReader, mb_width: int, mb_height: int,
                      num_ref_idx_l0: int, *,
                      bug_compat: bool = False) -> list:
    """-> row-major grid; P_Skip macroblocks appear as SKIP (None)."""
    tracker = _CtxTracker(mb_width)
    grid = [[SKIP] * mb_width for _ in range(mb_height)]
    total = mb_width * mb_height
    count = 0
    while count < total:
        skip_run = br.read_ue()
        for _ in range(skip_run):
            if count >= total:
                raise cavlc.CAVLCError("skip_run past end of slice")
            row, col = divmod(count, mb_width)
            if col == 0 and count:
                tracker.end_row()
            tracker.push(col, MBCoeffContext())
            count += 1
        if count >= total:
            break
        row, col = divmod(count, mb_width)
        if col == 0 and count:
            tracker.end_row()
        mb_type = br.read_ue()
        if mb_type <= 4:
            mb = _parse_inter_mb(br, mb_type, num_ref_idx_l0, tracker, col)
        elif mb_type == 5:
            mb = _parse_i4x4_mb(br, mb_type, tracker, col, in_p_slice=True)
        elif 6 <= mb_type <= 29:
            mb = _parse_i16x16_mb(br, mb_type, mb_type - 6, tracker, col)
        elif mb_type == 30:
            mb = _parse_ipcm_mb(br, mb_type, tracker, col,
                                bug_compat=bug_compat)
        else:
            raise cavlc.CAVLCError(f"unknown P mb_type {mb_type}")
        grid[row][col] = mb
        count += 1
    return grid


# ---------------------------------------------------------------------------
# Emission (with nC recompute for the output geometry)
# ---------------------------------------------------------------------------

def _emit_residual_luma_inter(bw, mb, ctx, left, top):
    cbp_luma = mb.cbp & 0xF
    for i8x8 in range(4):
        if cbp_luma & (1 << i8x8):
            for i4x4 in range(4):
                raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                nC = cavlc.luma_nC(raster, ctx, left, top)
                blk = mb.luma[raster]
                cavlc.write_residual_block(bw, blk, nC)
                ctx.luma_tc[raster] = blk.total_coeff


def _emit_residual_chroma(bw, mb, ctx, left, top):
    cbp_chroma = (mb.cbp >> 4) & 0x3
    if cbp_chroma > 0:
        cavlc.write_residual_block(bw, mb.cb_dc, -1)
        cavlc.write_residual_block(bw, mb.cr_dc, -1)
        if cbp_chroma == 2:
            for c in range(2):
                for i in range(4):
                    nC = cavlc.chroma_nC(c, i, ctx, left, top)
                    blk = mb.chroma_ac[c][i]
                    cavlc.write_residual_block(bw, blk, nC)
                    ctx.chroma_tc[c][i] = blk.total_coeff


def emit_mb(bw: BitWriter, mb: Macroblock, tracker: _CtxTracker, col: int,
            num_ref_idx_l0: int, *, bug_compat: bool = False) -> None:
    """Emit one coded macroblock (mb_type onward) at output column `col`."""
    left, top = tracker.neighbors(col)
    ctx = MBCoeffContext()
    bw.write_ue(mb.mb_type)

    if mb.kind == "ipcm":
        bw.align_zero()
        bw.write_bytes_aligned(mb.ipcm_samples)
        tracker.push(col, ipcm_context(bug_compat))
        return

    if mb.kind == "inter":
        if mb.mb_type >= 3:
            for smt in mb.sub_mb_types:
                bw.write_ue(smt)
        if num_ref_idx_l0 > 1 and mb.mb_type != 4 and mb.ref_idx:
            max_ref = num_ref_idx_l0 - 1
            for r in mb.ref_idx:
                if max_ref == 1:
                    bw.write_bit(1 - (r & 1))  # te(1) inverted bit
                else:
                    bw.write_ue(r)
        for mvd_x, mvd_y in mb.mvds:
            bw.write_se(mvd_x)
            bw.write_se(mvd_y)
        bw.write_ue(CBP_INTER_INV[mb.cbp])
        if mb.cbp > 0:
            bw.write_se(mb.qp_delta)
            _emit_residual_luma_inter(bw, mb, ctx, left, top)
            _emit_residual_chroma(bw, mb, ctx, left, top)
        tracker.push(col, ctx)
        return

    if mb.kind == "i4x4":
        for b in mb.pred_mode_bits:
            bw.write_bit(int(b))
        bw.write_ue(mb.chroma_pred)
        bw.write_ue(CBP_INTRA_INV[mb.cbp])
        if mb.cbp > 0:
            bw.write_se(mb.qp_delta)
            _emit_residual_luma_inter(bw, mb, ctx, left, top)
            _emit_residual_chroma(bw, mb, ctx, left, top)
        tracker.push(col, ctx)
        return

    if mb.kind == "i16x16":
        cbp_luma, _cbp_chroma = _intra16_geometry(mb.i16_idx)
        bw.write_ue(mb.chroma_pred)
        bw.write_se(mb.qp_delta)
        dc_nC = cavlc.luma_nC(0, ctx, left, top)
        cavlc.write_residual_block(bw, mb.luma_dc, dc_nC)
        for i8x8 in range(4):
            for i4x4 in range(4):
                raster = SCAN_TO_RASTER[i8x8 * 4 + i4x4]
                if cbp_luma & (1 << i8x8):
                    nC = cavlc.luma_nC(raster, ctx, left, top)
                    blk = mb.luma[raster]
                    cavlc.write_residual_block(bw, blk, nC)
                    ctx.luma_tc[raster] = blk.total_coeff
        _emit_residual_chroma(bw, mb, ctx, left, top)
        tracker.push(col, ctx)
        return

    raise cavlc.CAVLCError(f"cannot emit MB kind {mb.kind}")


def retype_for_p(mb: Macroblock) -> Macroblock:
    """Map an I-slice macroblock's type code into the P-slice taxonomy
    (I_4x4: 0->5, I_16x16: 1+idx -> 6+idx, I_PCM: 25->30) so donor I-frame
    content can be spliced into a P-slice as intra-in-P."""
    if mb.kind == "i4x4":
        return dataclasses.replace(mb, mb_type=5)
    if mb.kind == "i16x16":
        return dataclasses.replace(mb, mb_type=6 + mb.i16_idx)
    if mb.kind == "ipcm":
        return dataclasses.replace(mb, mb_type=30)
    return mb


def retype_for_i(mb: Macroblock) -> Macroblock:
    """Inverse of retype_for_p for intra kinds (inter MBs cannot live in
    an I slice)."""
    if mb.kind == "i4x4":
        return dataclasses.replace(mb, mb_type=0)
    if mb.kind == "i16x16":
        return dataclasses.replace(mb, mb_type=1 + mb.i16_idx)
    if mb.kind == "ipcm":
        return dataclasses.replace(mb, mb_type=25)
    raise cavlc.CAVLCError(f"{mb.kind} MB cannot be placed in an I slice")


def emit_i_slice_mbs(bw: BitWriter, grid: list,
                     num_ref_idx_l0: int = 1, *,
                     bug_compat: bool = False) -> None:
    mb_width = len(grid[0])
    tracker = _CtxTracker(mb_width)
    for row_mbs in grid:
        for col, mb in enumerate(row_mbs):
            if mb is SKIP:
                raise cavlc.CAVLCError("I slice cannot contain skips")
            emit_mb(bw, mb, tracker, col, num_ref_idx_l0,
                    bug_compat=bug_compat)
        tracker.end_row()


def emit_p_slice_mbs(bw: BitWriter, grid: list, num_ref_idx_l0: int,
                     *, duplicate_final_skip: bool = False,
                     bug_compat: bool = False) -> None:
    """Emit with correct mb_skip_run grammar: pending skips accumulate and
    are written immediately before each coded MB / at slice end
    (trans_resizer.c:1473-1485).

    duplicate_final_skip reproduces a reference defect: when the input
    slice ends in a skip run, trans_resizer writes the final pending count
    twice (inner write :1541-1544 never resets pending before the outer
    write :1774-1778), leaving a spurious ue(v) between the last MB and
    rbsp_trailing_bits.  Decoders ignore it; kept only for byte-parity
    differential testing."""
    mb_width = len(grid[0])
    tracker = _CtxTracker(mb_width)
    pending = 0
    for row_mbs in grid:
        for col, mb in enumerate(row_mbs):
            if mb is SKIP:
                pending += 1
                tracker.push(col, MBCoeffContext())
            else:
                bw.write_ue(pending)
                pending = 0
                emit_mb(bw, mb, tracker, col, num_ref_idx_l0,
                        bug_compat=bug_compat)
        tracker.end_row()
    if pending > 0:
        bw.write_ue(pending)
        if duplicate_final_skip:
            bw.write_ue(pending)
