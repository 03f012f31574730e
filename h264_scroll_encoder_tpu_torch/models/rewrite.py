"""Donor IDR re-headering (atlas ingestion).

Copied unchanged from h264_scroll_encoder_tpu/models/rewrite.py (it has
no framework dependency), so the port runs where jax is absent.

Byte-parity targets: h264_rewrite_idr_frame (src/h264_writer.c:242-294) and
h264_rewrite_as_non_idr_i_frame (:296-350): parse the donor encoder's IDR
slice header with the *donor's* SPS geometry (parse config), emit our own
header — IDR with long_term_reference_flag=1 for atlas slot 0, or non-IDR I
with MMCO 4/6/0 marking long-term idx 1 for slot B — then splice the donor's
macroblock payload at an unaligned bit offset.

The reference copies the payload one bit at a time (copy_bits
src/h264_writer.c:228-240, ~100 KB per donor).  Here the splice is a
vectorized bit-shift: unpack header+payload to bit vectors, concatenate,
repack — O(bytes) numpy ops on the once-per-session path.
"""

from __future__ import annotations

import numpy as np

from ..config import (ComposerConfig, NAL_REF_IDC_HIGHEST, NAL_TYPE_IDR,
                      NAL_TYPE_SLICE)
from ..ops.bitio import BitWriter
from ..syntax import parse
from ..syntax.nal import write_nal_unit


def _bits_of(data: bytes, nbits: int | None = None) -> np.ndarray:
    arr = np.unpackbits(np.frombuffer(data, np.uint8))
    return arr if nbits is None else arr[:nbits]


def _splice(header_bw: BitWriter, donor_rbsp: bytes,
            mb_data_start_bit: int) -> bytes:
    header_bits = _bits_of(header_bw.getvalue(), header_bw.bit_position)
    payload_bits = _bits_of(donor_rbsp)[mb_data_start_bit:]
    return np.packbits(np.concatenate([header_bits, payload_bits])).tobytes()


def _parse_donor_header(donor_rbsp: bytes, parse_cfg: ComposerConfig):
    return parse.parse_idr_slice_header(
        donor_rbsp,
        log2_max_frame_num=parse_cfg.log2_max_frame_num,
        pic_order_cnt_type=parse_cfg.pic_order_cnt_type,
        log2_max_pic_order_cnt_lsb=parse_cfg.log2_max_pic_order_cnt_lsb,
        deblocking_filter_control_present_flag=(
            parse_cfg.deblocking_filter_control_present_flag),
    )


def _write_deblock_tail(bw: BitWriter, write_cfg: ComposerConfig, hdr) -> None:
    if write_cfg.deblocking_filter_control_present_flag:
        bw.write_ue(hdr.disable_deblocking_filter_idc)
        if hdr.disable_deblocking_filter_idc != 1:
            bw.write_se(hdr.slice_alpha_c0_offset_div2)
            bw.write_se(hdr.slice_beta_offset_div2)


def _payload(header_bw: BitWriter, donor_rbsp: bytes, hdr,
             parse_cfg: ComposerConfig, mode: str) -> bytes:
    """Attach the donor MB payload after our new header.

    mode:
      "splice"  — raw bit-shift of the payload, exactly the C reference's
                  copy_bits behavior (src/h264_writer.c:228-240).
      "realign" — CAVLC-parse the donor macroblocks and re-emit them after
                  the new header.  Needed when the payload contains I_PCM
                  macroblocks and the new header length differs from the
                  donor's mod 8: pcm_alignment_zero_bits are
                  position-dependent, so a raw bit-shift corrupts them — a
                  latent reference defect invisible with x264 donors
                  (pure CAVLC has no alignment) but real for I_PCM input.
      "auto"    — realign only when the shift is misaligning and the
                  payload parses as containing I_PCM; splice otherwise.
    """
    if mode == "splice":
        return _splice(header_bw, donor_rbsp, hdr.mb_data_start_bit)

    from . import mb_transcode as mbt
    from ..ops.bitio import BitReader

    shift = (header_bw.bit_position - hdr.mb_data_start_bit) % 8
    if mode == "auto" and shift == 0:
        return _splice(header_bw, donor_rbsp, hdr.mb_data_start_bit)

    br = BitReader(donor_rbsp)
    br.skip_bits(hdr.mb_data_start_bit)
    grid = mbt.parse_i_slice_mbs(br, parse_cfg.mb_width, parse_cfg.mb_height)
    if mode == "auto" and not any(
            mb.kind == "ipcm" for row in grid for mb in row):
        return _splice(header_bw, donor_rbsp, hdr.mb_data_start_bit)
    mbt.emit_i_slice_mbs(header_bw, grid)
    header_bw.write_trailing_bits()
    return header_bw.getvalue()


def rewrite_idr_frame(write_cfg: ComposerConfig, parse_cfg: ComposerConfig,
                      donor_rbsp: bytes, *, mode: str = "auto") -> bytes:
    """Donor IDR -> our IDR NAL with long_term_reference_flag=1 (atlas A)."""
    hdr = _parse_donor_header(donor_rbsp, parse_cfg)

    bw = BitWriter()
    bw.write_ue(0)                         # first_mb_in_slice
    bw.write_ue(7)                         # slice_type I_ALL
    bw.write_ue(0)                         # pps_id
    bw.write_bits(0, write_cfg.log2_max_frame_num)
    bw.write_ue(write_cfg.idr_pic_id)
    if write_cfg.pic_order_cnt_type == 0:
        bw.write_bits(0, write_cfg.log2_max_pic_order_cnt_lsb)
    bw.write_bit(0)                        # no_output_of_prior_pics_flag
    bw.write_bit(1)                        # long_term_reference_flag = 1
    bw.write_se(hdr.slice_qp_delta)        # preserve donor QP
    _write_deblock_tail(bw, write_cfg, hdr)

    rbsp = _payload(bw, donor_rbsp, hdr, parse_cfg, mode)
    return write_nal_unit(rbsp, NAL_REF_IDC_HIGHEST, NAL_TYPE_IDR)


def rewrite_as_non_idr_i_frame(write_cfg: ComposerConfig,
                               parse_cfg: ComposerConfig,
                               donor_rbsp: bytes, frame_num: int, *,
                               mode: str = "auto",
                               long_term_idx: int = 1,
                               max_long_term_plus1: int = 2,
                               qp_delta_adjust: int = 0) -> bytes:
    """Donor IDR -> non-IDR I NAL with MMCO long-term marking (atlas B;
    defaults reproduce the reference's MMCO 4/6/0, src/h264_writer.c:
    323-329).

    The MASTER_DESIGN fallback path reuses this with `long_term_idx=0`
    (the conventional re-encode becomes the fresh atlas A) and
    `qp_delta_adjust` compensating a donor PPS QP base that differs from
    the already-emitted session PPS: decoded slice QP is
    pps_base + slice_qp_delta, so adding (donor_base - session_base)
    keeps every residual dequantizing exactly as x264 encoded it."""
    hdr = _parse_donor_header(donor_rbsp, parse_cfg)

    bw = BitWriter()
    bw.write_ue(0)
    bw.write_ue(7)                         # I_ALL
    bw.write_ue(0)
    bw.write_bits(frame_num, write_cfg.log2_max_frame_num)
    if write_cfg.pic_order_cnt_type == 0:
        bw.write_bits(frame_num * 2, write_cfg.log2_max_pic_order_cnt_lsb)
    bw.write_bit(1)                        # adaptive_ref_pic_marking_mode_flag
    bw.write_ue(4)                         # MMCO 4
    bw.write_ue(max_long_term_plus1)       # max_long_term_frame_idx_plus1
    bw.write_ue(6)                         # MMCO 6
    bw.write_ue(long_term_idx)             # long_term_frame_idx
    bw.write_ue(0)                         # MMCO 0 (end)
    bw.write_se(hdr.slice_qp_delta + qp_delta_adjust)
    _write_deblock_tail(bw, write_cfg, hdr)

    rbsp = _payload(bw, donor_rbsp, hdr, parse_cfg, mode)
    return write_nal_unit(rbsp, NAL_REF_IDC_HIGHEST, NAL_TYPE_SLICE)
