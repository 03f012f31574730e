"""Bitstream surgery, host path: padding transcode and dynamic-rect splice.

Port of h264_scroll_encoder_tpu/models/splice.py (it has no framework
dependency):

1. `transcode_pad_stream` — the trans-resizer equivalent
   (experiments/trans-resizer/trans_resizer.c:1787-2156): re-emit a CAVLC
   stream at a wider geometry by appending padding macroblocks at the end
   of each row, with regenerated SPS/PPS and transcoded slice headers, on
   the native CAVLC engine or the Python one (`engine`, no fallback).

2. `splice_p_frame` — the dynamic-rect splice the reference *specifies*
   (docs/MASTER_DESIGN.md §6 stitch algorithm) but never implemented in
   its main tree: compose a P-frame where motion-only regions are
   MV/P_Skip macroblocks referencing the long-term atlases and a donor
   encoder's pre-encoded macroblocks are embedded at an arbitrary
   MB-aligned rectangle, with nC-context repair (coeff_token re-encoded
   under the output-geometry nC) and skip-run stitching — plus the hint
   types, the slice-header parse/transcode and the I_PCM padding helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ComposerConfig
from ..ops.bitio import BitReader, BitWriter
from . import mb_transcode as mbt


# ---------------------------------------------------------------------------
# I_PCM padding macroblocks (trans_resizer.c:213-270).
# ---------------------------------------------------------------------------

def ipcm_grid_from_picture(pic, mb_x0: int, mb_y0: int,
                           w_mb: int, h_mb: int) -> list:
    """I_PCM macroblock grid carrying a picture rect's exact pixels.

    The position-independent way to seed a dynamic region with intra
    content: spliced I-macroblocks from a donor IDR would mispredict
    (intra prediction reads neighbor SAMPLES whose availability differs
    mid-frame — the trans-resizer README's fundamental limitation), but
    I_PCM bytes decode exactly anywhere.  `pic` is any object with
    y/cb/cr planes (pixel_oracle.Picture, avref decode output)."""
    grid = []
    for r in range(h_mb):
        row = []
        for c in range(w_mb):
            y0, x0 = (mb_y0 + r) * 16, (mb_x0 + c) * 16
            samples = np.concatenate([
                np.asarray(pic.y[y0:y0 + 16, x0:x0 + 16],
                           np.uint8).reshape(-1),
                np.asarray(pic.cb[y0 // 2:y0 // 2 + 8,
                                  x0 // 2:x0 // 2 + 8],
                           np.uint8).reshape(-1),
                np.asarray(pic.cr[y0 // 2:y0 // 2 + 8,
                                  x0 // 2:x0 // 2 + 8],
                           np.uint8).reshape(-1),
            ]).tobytes()
            row.append(mbt.Macroblock(kind="ipcm", mb_type=30,
                                      ipcm_samples=samples))
        grid.append(row)
    return grid


def ipcm_padding_mb(edge_y: int = 16, first_padding: bool = False
                    ) -> mbt.Macroblock:
    """Black I_PCM padding MB; the first one after original content gets
    edge-compatible samples (bottom row + left columns approach `edge_y`)
    so the next row's intra prediction sees plausible top-right samples."""
    y = np.full((16, 16), 16, np.uint8)
    if first_padding:
        y[15, :] = edge_y
        y[:, 0] = edge_y
        for col in range(1, 4):
            y[:15, col] = (16 * col + edge_y * (4 - col)) // 4
        y[15, :] = edge_y  # bottom row wins over the gradient
    samples = np.concatenate([
        y.reshape(-1),
        np.full(64, 128, np.uint8),
        np.full(64, 128, np.uint8),
    ]).tobytes()
    return mbt.Macroblock(kind="ipcm", mb_type=25, ipcm_samples=samples)


# ---------------------------------------------------------------------------
# Slice header transcode (trans_resizer.c:1985-2114).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SliceHeaderInfo:
    first_mb: int
    slice_type_raw: int
    pps_id: int
    frame_num: int
    idr_pic_id: int
    num_ref_idx_l0: int
    num_ref_idx_override: int
    qp_delta: int
    disable_deblock: int
    alpha_offset: int
    beta_offset: int
    is_idr: bool
    nal_ref_idc: int

    @property
    def slice_type(self) -> int:
        return self.slice_type_raw % 5

    @property
    def is_i(self) -> bool:
        return self.slice_type == 2

    @property
    def is_p(self) -> bool:
        return self.slice_type == 0


def parse_slice_header(br: BitReader, *, is_idr: bool, nal_ref_idc: int,
                       log2_max_frame_num: int,
                       pps_num_ref_idx_l0_default: int) -> SliceHeaderInfo:
    first_mb = br.read_ue()
    slice_type_raw = br.read_ue()
    pps_id = br.read_ue()
    frame_num = br.read_bits(log2_max_frame_num)
    idr_pic_id = br.read_ue() if is_idr else 0
    # poc type 2: no POC fields.

    slice_type = slice_type_raw % 5
    num_ref_idx_l0 = pps_num_ref_idx_l0_default
    override = 0
    if slice_type == 0:  # P
        override = br.read_bit()
        if override:
            num_ref_idx_l0 = br.read_ue() + 1
        if br.read_bit():  # ref_pic_list_modification_flag_l0
            while True:
                idc = br.read_ue()
                if idc == 3:
                    break
                br.read_ue()  # abs_diff_pic_num_minus1 / long_term_pic_num

    if is_idr:
        br.read_bit()  # no_output_of_prior_pics_flag
        br.read_bit()  # long_term_reference_flag
    elif nal_ref_idc != 0:
        if br.read_bit():  # adaptive_ref_pic_marking_mode_flag
            while True:
                op = br.read_ue()
                if op == 0:
                    break
                if op in (1, 3):
                    br.read_ue()
                if op == 2:
                    br.read_ue()
                if op in (3, 6):
                    br.read_ue()
                if op == 4:
                    br.read_ue()

    qp_delta = br.read_se()
    disable_deblock = br.read_ue()
    alpha = beta = 0
    if disable_deblock != 1:
        alpha = br.read_se()
        beta = br.read_se()
    return SliceHeaderInfo(first_mb, slice_type_raw, pps_id, frame_num,
                           idr_pic_id, num_ref_idx_l0, override, qp_delta,
                           disable_deblock, alpha, beta, is_idr, nal_ref_idc)


def write_transcoded_slice_header(bw: BitWriter, h: SliceHeaderInfo,
                                  log2_max_frame_num: int = 4) -> None:
    """Rewrite the header for the padded geometry: ref-list modification
    dropped, dec_ref_pic_marking reduced to sliding-window
    (trans_resizer.c:2077-2114)."""
    bw.write_ue(h.first_mb)
    bw.write_ue(h.slice_type_raw)
    bw.write_ue(h.pps_id)
    bw.write_bits(h.frame_num, log2_max_frame_num)
    if h.is_idr:
        bw.write_ue(h.idr_pic_id)
    if h.is_p:
        bw.write_bit(h.num_ref_idx_override)
        if h.num_ref_idx_override:
            bw.write_ue(h.num_ref_idx_l0 - 1)
        bw.write_bit(0)  # ref_pic_list_modification_flag_l0 = 0
    if h.is_idr:
        bw.write_bit(0)  # no_output_of_prior_pics_flag
        bw.write_bit(0)  # long_term_reference_flag
    elif h.nal_ref_idc != 0:
        bw.write_bit(0)  # sliding window
    bw.write_se(h.qp_delta)
    bw.write_ue(h.disable_deblock)
    if h.disable_deblock != 1:
        bw.write_se(h.alpha_offset)
        bw.write_se(h.beta_offset)


# ---------------------------------------------------------------------------
# Padding transcode (trans-resizer equivalent, geometry generalized).
# ---------------------------------------------------------------------------

def transcode_pad_stream(data: bytes, out_width: int, out_height: int, *,
                         edge_y: int = 235, level_idc: int = 30,
                         bug_compat: bool = False,
                         engine: str = "native") -> bytes:
    """Widen a CAVLC stream by appending padding MBs at each row's end.

    Behaviour parity with the reference trans_resizer at its hardwired
    320x320 -> 720x320 geometry; any MB-aligned out size is accepted (out
    rows must equal the input's; out columns >= the input's).

    bug_compat=True reproduces the reference's duplicated final skip run
    (see mb_transcode.emit_p_slice_mbs) for byte-level differential
    testing; the default emits the corrected stream.

    engine: "native" (the C++ engine parses and re-emits each slice, built
    on first use; raises if it cannot be built) or "python"
    (models/mb_transcode).  Both give the same bytes."""
    from .. import native_bridge
    from ..syntax import parse
    from ..syntax.nal import AnnexBWriter
    from ..syntax.params import generate_pps, generate_sps
    from .splice_device import _check_engine

    _check_engine(engine)
    sps = pps = None
    for unit in parse.iter_nal_units(data):
        if unit.nal_unit_type == 7 and sps is None:
            sps = parse.parse_sps(unit.rbsp)
        elif unit.nal_unit_type == 8 and pps is None:
            pps = parse.parse_pps(unit.rbsp)
    if sps is None or pps is None:
        raise ValueError("input stream missing SPS/PPS")

    in_mbw, in_mbh = sps.width // 16, sps.height // 16
    out_mbw, out_mbh = out_width // 16, out_height // 16
    if out_mbh != in_mbh or out_mbw < in_mbw:
        raise ValueError("padding transcode only widens rows")
    pad = out_mbw - in_mbw

    out = AnnexBWriter()
    num_ref_default = pps.num_ref_idx_l0_default_active_minus1 + 1
    out.write_nal_unit(
        generate_sps(out_width, out_height, level_idc=level_idc,
                     max_num_ref_frames=num_ref_default,
                     log2_max_frame_num=4),
        3, 7)
    out.write_nal_unit(
        generate_pps(
            num_ref_idx_l0_default_active_minus1=(
                pps.num_ref_idx_l0_default_active_minus1),
            pic_init_qp_minus26=pps.pic_init_qp_minus26,
            chroma_qp_index_offset=pps.chroma_qp_index_offset),
        3, 8)

    for unit in parse.iter_nal_units(data):
        if unit.nal_unit_type not in (1, 5):
            continue
        br = BitReader(unit.rbsp)
        hdr = parse_slice_header(
            br, is_idr=(unit.nal_unit_type == 5),
            nal_ref_idc=unit.nal_ref_idc,
            log2_max_frame_num=sps.log2_max_frame_num,
            pps_num_ref_idx_l0_default=num_ref_default)
        bw = BitWriter()
        write_transcoded_slice_header(bw, hdr)
        if not hdr.is_i and not hdr.is_p:
            raise ValueError(f"unsupported slice type {hdr.slice_type}")

        if engine == "native":
            recs, _ = native_bridge.parse_slice_raw(
                unit.rbsp, br.bit_position, in_mbw, in_mbh, hdr.is_p,
                hdr.num_ref_idx_l0, bug_compat=bug_compat)
            out_recs, aux, last_skip = native_bridge.pad_grid_raw(
                recs, in_mbw, in_mbh, out_mbw, hdr.is_p, edge_y=edge_y)
            phase = bw.bit_position % 8
            payload, nbits = native_bridge.emit_slice_raw(
                out_recs, out_mbw, in_mbh, hdr.is_p, hdr.num_ref_idx_l0,
                unit.rbsp, aux, duplicate_final_skip=bug_compat and last_skip,
                start_phase=phase, bug_compat=bug_compat)
            # Bit-splice the payload after the (unaligned) header.
            hdr_bits = np.unpackbits(
                np.frombuffer(bw.getvalue(), np.uint8))[: bw.bit_position]
            pay_bits = np.unpackbits(
                np.frombuffer(payload, np.uint8))[phase:nbits]
            merged = np.concatenate([hdr_bits, pay_bits])
            whole = merged.size // 8 * 8
            bw = BitWriter()
            bw.write_bytes_aligned(np.packbits(merged[:whole]).tobytes())
            for b in merged[whole:]:
                bw.write_bit(int(b))
        elif hdr.is_i:
            grid = mbt.parse_i_slice_mbs(br, in_mbw, in_mbh,
                                         bug_compat=bug_compat)
            out_grid = [row + [ipcm_padding_mb(edge_y, first_padding=(p == 0))
                               for p in range(pad)]
                        for row in grid]
            mbt.emit_i_slice_mbs(bw, out_grid, bug_compat=bug_compat)
        else:
            grid = mbt.parse_p_slice_mbs(br, in_mbw, in_mbh,
                                         hdr.num_ref_idx_l0,
                                         bug_compat=bug_compat)
            out_grid = [row + [mbt.SKIP] * pad for row in grid]
            dup = bug_compat and grid[-1][-1] is mbt.SKIP
            mbt.emit_p_slice_mbs(bw, out_grid, hdr.num_ref_idx_l0,
                                 duplicate_final_skip=dup,
                                 bug_compat=bug_compat)

        bw.write_trailing_bits()
        out.write_nal_unit(bw.getvalue(), unit.nal_ref_idc,
                           unit.nal_unit_type)
    return out.getvalue()


# ---------------------------------------------------------------------------
# Dynamic-rect splice (MASTER_DESIGN §6 — new capability).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MotionRegion:
    """A motion-only rectangle (MB units) referencing an atlas.

    mv is in pixels; emitted as P_L0_16x16 with ref_idx into the slice's
    reference list (0 = atlas A, 1 = atlas B, 2+ = waypoints).
    """
    mb_x0: int
    mb_y0: int
    mb_x1: int     # exclusive
    mb_y1: int
    ref_idx: int = 0
    mv_x: int = 0
    mv_y: int = 0

    @classmethod
    def from_pixel_rect(cls, x: int, y: int, w: int, h: int, *,
                        ref_idx: int = 0, mv_x: int = 0, mv_y: int = 0
                        ) -> "MotionRegion":
        """Pixel rect -> covering MB-aligned region (floor origin, ceil
        extent — MASTER_DESIGN §7.1 alignment applied to motion hints)."""
        return cls(x // 16, y // 16, -(-(x + w) // 16), -(-(y + h) // 16),
                   ref_idx=ref_idx, mv_x=mv_x, mv_y=mv_y)


@dataclasses.dataclass
class FrameHints:
    """Per-frame UI hints (MASTER_DESIGN §5): motion regions + the dynamic
    rectangle where donor macroblocks are embedded.  The dynamic rect
    overrides motion regions underneath (§10 occlusion)."""
    motion_regions: tuple = ()
    dynamic_mb_x: int = 0
    dynamic_mb_y: int = 0

    @classmethod
    def with_dynamic_pixel_rect(cls, x: int, y: int, w: int, h: int, *,
                                margin: int = 16,
                                frame_width: int, frame_height: int,
                                motion_regions: tuple = ()):
        """MASTER_DESIGN §7.1 ergonomics: pixel rect + margin -> hints
        whose dynamic origin is the floor-aligned expanded rect, plus the
        rect's MB size — (FrameHints, (rect_mb_w, rect_mb_h)).

        The expanded rect is clamped to the frame; the donor the caller
        supplies must match the returned MB size (the dynamic encoder
        encodes exactly the aligned region, docs/MASTER_DESIGN.md:52-57).
        """
        x0, y0, x1, y1 = align_dynamic_rect(x, y, w, h, margin)
        x1 = min(x1, frame_width // 16 * 16)
        y1 = min(y1, frame_height // 16 * 16)
        hints = cls(motion_regions=motion_regions,
                    dynamic_mb_x=x0 // 16, dynamic_mb_y=y0 // 16)
        return hints, ((x1 - x0) // 16, (y1 - y0) // 16)

    def validate(self, cfg, num_refs: int,
                 dynamic_rect_mb: tuple | None = None) -> None:
        """Flag not-servable hints (MASTER_DESIGN §10 fallback rule).

        Raises HintsNotServable when a hint is missing/inconsistent:
        regions out of frame or empty, ref_idx outside the active list,
        motion beyond the 496 px hardware MV budget, or a dynamic rect
        exceeding the 392x392 dynamic-encoder input bound
        (docs/MASTER_DESIGN.md:52-57,213-220).  Callers route flagged
        frames to a full conventional encode — deliberately out of scope
        here, exactly as it is unimplemented in the reference.
        """
        from ..config import MV_LIMIT_PX

        H, W = cfg.mb_height, cfg.mb_width
        for i, reg in enumerate(self.motion_regions):
            if not (0 <= reg.mb_x0 < reg.mb_x1 <= W
                    and 0 <= reg.mb_y0 < reg.mb_y1 <= H):
                raise HintsNotServable(
                    f"motion region {i} empty or out of frame: "
                    f"({reg.mb_x0},{reg.mb_y0})..({reg.mb_x1},{reg.mb_y1})"
                    f" vs {W}x{H} MBs")
            if not 0 <= reg.ref_idx < num_refs:
                raise HintsNotServable(
                    f"motion region {i} ref_idx {reg.ref_idx} outside the "
                    f"active reference list (size {num_refs})")
            if abs(reg.mv_x) > MV_LIMIT_PX or abs(reg.mv_y) > MV_LIMIT_PX:
                raise HintsNotServable(
                    f"motion region {i} MV ({reg.mv_x},{reg.mv_y}) px "
                    f"exceeds the {MV_LIMIT_PX} px hardware budget")
        if dynamic_rect_mb is not None:
            rw, rh = dynamic_rect_mb
            if rw * 16 > 392 or rh * 16 > 392:
                raise HintsNotServable(
                    f"dynamic rect {rw * 16}x{rh * 16} px exceeds the "
                    "392x392 dynamic-encoder bound "
                    "(docs/MASTER_DESIGN.md:52-57)")
            if not (0 <= self.dynamic_mb_x
                    and self.dynamic_mb_x + rw <= W
                    and 0 <= self.dynamic_mb_y
                    and self.dynamic_mb_y + rh <= H):
                raise HintsNotServable(
                    f"dynamic rect at MB ({self.dynamic_mb_x},"
                    f"{self.dynamic_mb_y}) size {rw}x{rh} exceeds the "
                    f"{W}x{H} MB frame")


class HintsNotServable(ValueError):
    """A frame whose hints are missing/inconsistent: the MASTER_DESIGN
    §10 rule is to fall back to a full conventional encode — this
    framework flags the condition (the reference leaves the fallback
    unimplemented too, docs/MASTER_DESIGN.md:220)."""


def align_dynamic_rect(x: int, y: int, w: int, h: int,
                       margin: int = 16) -> tuple:
    """MASTER_DESIGN §7.1: expand by margin, align to 16-px boundaries.
    Returns (x0, y0, x1, y1) in pixels."""
    x0 = (x - margin) // 16 * 16
    y0 = (y - margin) // 16 * 16
    x1 = -(-(x + w + margin) // 16) * 16
    y1 = -(-(y + h + margin) // 16) * 16
    return max(0, x0), max(0, y0), x1, y1


def _map_donor_refs(mb: mbt.Macroblock, ref_map: tuple,
                    num_ref_idx_l0: int) -> mbt.Macroblock:
    """Re-target a donor inter MB's reference indices into the composite
    slice's reference list.

    Donor streams are encoded with their own (usually single-entry) list;
    in the composite, `ref_map[donor_ref]` names the slot (e.g. a
    dedicated long-term atlas holding the previous dynamic region).  A
    donor that wrote no ref bits (1-ref stream, or P_8x8ref0) implies
    donor ref 0 everywhere; P_8x8ref0 must be rewritten to P_8x8 when the
    mapped ref is nonzero since ref0 is hardwired in its grammar."""
    if mb.kind != "inter":
        return mb
    if mb.mb_type == 4 and ref_map[0] != 0:
        return dataclasses.replace(mb, mb_type=3,
                                   ref_idx=(ref_map[0],) * 4)
    if num_ref_idx_l0 <= 1:
        return dataclasses.replace(mb, ref_idx=())
    n_parts = 1 if mb.mb_type == 0 else (2 if mb.mb_type <= 2 else 4)
    if mb.mb_type == 4:
        return mb
    if not mb.ref_idx:
        refs = (ref_map[0],) * n_parts
    else:
        refs = tuple(ref_map[r] for r in mb.ref_idx)
    return dataclasses.replace(mb, ref_idx=refs)


def splice_p_frame(cfg: ComposerConfig, hints: FrameHints,
                   donor_grid: list | None,
                   num_ref_idx_l0: int,
                   donor_ref_map: tuple = (0,),
                   donor_mv_targets: dict | None = None) -> list:
    """Compose the MB grid for a spliced P-frame (no bit emission yet).

    Background MBs become P_Skip; motion regions become P_L0_16x16 with
    the hinted (ref, mv); donor macroblocks land at the dynamic rect
    (intra donor MBs are retyped for the P-slice taxonomy).  The emitter
    (mb_transcode.emit_p_slice_mbs) then handles nC repair and skip runs.

    NOTE: P_Skip background requires the skip-derived MV (0,0 w/ ref 0)
    to show the right content — i.e. a static background referencing
    atlas slot 0, the MASTER_DESIGN "static chrome" case.  Scroll-style
    backgrounds use models/scroll.py instead.
    """
    mbw, mbh = cfg.mb_width, cfg.mb_height
    grid = [[mbt.SKIP] * mbw for _ in range(mbh)]

    for region in hints.motion_regions:
        if not 0 <= region.ref_idx < num_ref_idx_l0:
            # te(v) coding would silently wrap an out-of-range index.
            raise ValueError(
                f"motion region ref_idx {region.ref_idx} outside the "
                f"active reference list (size {num_ref_idx_l0})")
        for y in range(region.mb_y0, min(region.mb_y1, mbh)):
            for x in range(region.mb_x0, min(region.mb_x1, mbw)):
                grid[y][x] = mbt.Macroblock(
                    kind="inter", mb_type=0,
                    ref_idx=(region.ref_idx,) if num_ref_idx_l0 > 1 else (),
                    mvds=((0, 0),), cbp=0,
                    hint_mv=(region.mv_x * 4, region.mv_y * 4))

    if donor_grid is not None:
        dy, dx = hints.dynamic_mb_y, hints.dynamic_mb_x
        for r, row in enumerate(donor_grid):
            for c, mb in enumerate(row):
                if dy + r >= mbh or dx + c >= mbw:
                    raise ValueError("dynamic rect exceeds frame")
                tgt = (donor_mv_targets or {}).get((r, c))
                if mb is mbt.SKIP:
                    if tgt is not None:
                        # MV retargeting: a donor skip means "copy at the
                        # DONOR-context skip MV"; the composite skip
                        # derivation can differ (richer neighbor
                        # availability at the rect edge), so pin the MV
                        # explicitly.
                        grid[dy + r][dx + c] = mbt.Macroblock(
                            kind="inter", mb_type=0,
                            ref_idx=(donor_ref_map[0],)
                            if num_ref_idx_l0 > 1 else (),
                            mvds=((0, 0),), cbp=0, hint_mv=tgt[0])
                    elif donor_ref_map[0] == 0:
                        grid[dy + r][dx + c] = mbt.SKIP
                    else:
                        # P_Skip is hardwired to composite ref 0; a donor
                        # skip means "ref donor-prev, MV 0", so re-target
                        # it explicitly when the map moves donor ref 0.
                        grid[dy + r][dx + c] = mbt.Macroblock(
                            kind="inter", mb_type=0,
                            ref_idx=(donor_ref_map[0],)
                            if num_ref_idx_l0 > 1 else (),
                            mvds=((0, 0),), cbp=0, hint_mv=(0, 0))
                elif mb.kind in ("i4x4", "i16x16", "ipcm"):
                    grid[dy + r][dx + c] = mbt.retype_for_p(mb)
                else:
                    mapped = _map_donor_refs(mb, donor_ref_map,
                                             num_ref_idx_l0)
                    if tgt is not None:
                        mapped = dataclasses.replace(mapped, hint_mv=tgt)
                    grid[dy + r][dx + c] = mapped
    return grid


def donor_mv_targets_from_grid(donor_grid: list) -> dict:
    """Per-MB decoded-MV targets of a donor grid in its OWN prediction
    context (frame-edge availability), for splice_p_frame's MV
    retargeting: the composite re-encodes every donor mvd as
    target - composite_prediction, so decoded motion is preserved
    exactly even though the rect's neighbor availability differs from
    the donor frame's."""
    from . import mv_field

    R, C = len(donor_grid), len(donor_grid[0])
    field = mv_field.decode_p_slice_mv_field(donor_grid, C, R)
    targets = {}
    for r, row in enumerate(donor_grid):
        for c, mb in enumerate(row):
            if mb is mbt.SKIP:
                targets[(r, c)] = ((int(field.mvx[r * 4, c * 4]),
                                    int(field.mvy[r * 4, c * 4])),)
            elif mb.kind == "inter":
                targets[(r, c)] = mb.decoded_mvs
    return targets


def finalize_spliced_frame(cfg: ComposerConfig, grid: list,
                           num_ref_idx_l0: int,
                           hdr_writer) -> bytes:
    """Resolve hint mvds against the real decode-order prediction context
    (models/mv_field), optionally convert newly-unskippable MBs, then emit
    the slice payload.

    Hint MBs whose desired MV is reachable as P_Skip stay explicit here —
    callers wanting maximal compression pre-mark them SKIP; the MV-field
    pass verifies skip-derived MVs match desired content either way.
    Donor MBs keep their original mvds (self-consistent inside the rect;
    the margin ring absorbs boundary prediction drift, MASTER_DESIGN
    §7.1)."""
    from .mv_field import decode_p_slice_mv_field

    decode_p_slice_mv_field(grid, cfg.mb_width, cfg.mb_height)

    bw = BitWriter()
    hdr_writer(bw)
    mbt.emit_p_slice_mbs(bw, grid, num_ref_idx_l0)
    bw.write_trailing_bits()
    return bw.getvalue()
