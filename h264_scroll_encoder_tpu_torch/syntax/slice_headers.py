"""Slice headers: P headers as batched fixed-shape symbol streams (device)
and the host writers of P, IDR and non-IDR I headers.

Port of h264_scroll_encoder_tpu/syntax/slice_headers.py.  Byte-parity
targets in the C reference: h264_write_p_slice_header and
h264_write_p_slice_header_waypoint (src/h264_writer.c:455-539),
h264_write_idr_slice_header and h264_write_non_idr_i_slice_header
(experiments/scroll-encoder/src/h264_encoder.c:622-715).  The base P
header is the waypoint variant specialized to zero waypoints and no MMCO
self-marking, so one branchless stream covers both: every optional field
has a fixed slot whose nbits is 0 when absent.  The host writers are
copied unchanged (they have no framework dependency).
"""

from __future__ import annotations

import torch

from ..config import ComposerConfig, MAX_WAYPOINTS, SLICE_TYPE_P
from ..ops import expgolomb
from ..ops.bitio import BitWriter
from ..ops.bitpack import U32

# Slot budget for the P slice header symbol stream (incl. the two
# optional short-term-lead reordering slots).
P_HEADER_SLOTS = 14 + 2 * MAX_WAYPOINTS + 7 + 2


def p_slice_header_symbols(cfg: ComposerConfig, frame_num, poc_lsb,
                           is_reference, long_term_idx,
                           num_waypoints, wp_long_term_idx, wp_valid,
                           first_mb=0, slice_qp_delta: int = 0,
                           prev_ref_abs_diff=0):
    """P slice headers as (patterns int64[B, P_HEADER_SLOTS],
    nbits int64[B, P_HEADER_SLOTS]).

    Args (per session [B] tensors, or Python scalars shared by all):
      frame_num: int[B], already wrapped to max_frame_num; fixes B and the
        device.
      poc_lsb: POC LSB (written only when cfg.pic_order_cnt_type == 0).
      is_reference: bool — write dec_ref_pic_marking.
      long_term_idx: >= 0 marks the frame long-term via MMCO 4/6/0
        (waypoint frames); < 0 uses the sliding window.
      num_waypoints: registered waypoints (the list gets 2 + that entries).
      wp_long_term_idx: int[B, MAX_WAYPOINTS] registry.
      wp_valid: bool[B, MAX_WAYPOINTS] registry validity.
      first_mb: first_mb_in_slice.
      slice_qp_delta: static se(v).
      prev_ref_abs_diff: > 0 leads the list with a short-term picture
        (reordering idc 0, abs_diff_pic_num_minus1 = value - 1); 0 = absent.
    """
    frame_num = torch.as_tensor(frame_num)
    B = frame_num.shape[0]
    dev = frame_num.device

    def vec(x, dtype=torch.int64):
        t = torch.as_tensor(x, device=dev).to(dtype)
        return t.expand(B) if t.dim() == 0 else t

    poc_lsb = vec(poc_lsb)
    is_reference = vec(is_reference, torch.bool)
    long_term_idx = vec(long_term_idx)
    num_waypoints = vec(num_waypoints)
    wp_long_term_idx = torch.as_tensor(wp_long_term_idx, device=dev).to(torch.int64)
    wp_valid = torch.as_tensor(wp_valid, device=dev).to(torch.bool)
    prev_ref_abs_diff = vec(prev_ref_abs_diff)
    st_lead = prev_ref_abs_diff > 0

    pats = []
    bits = []

    def sym(pattern, nbits):
        pats.append(vec(pattern) & U32)
        bits.append(vec(nbits))

    def sym_ue(value, present=None):
        p, n = expgolomb.ue(vec(value))
        if present is not None:
            n = torch.where(present, n, 0)
        sym(p, n)

    sym_ue(first_mb)               # first_mb_in_slice
    sym_ue(SLICE_TYPE_P)           # slice_type
    sym_ue(0)                      # pps_id
    fn_bits = cfg.log2_max_frame_num
    sym(vec(frame_num) & ((1 << fn_bits) - 1), fn_bits)
    if cfg.pic_order_cnt_type == 0:
        pb = cfg.log2_max_pic_order_cnt_lsb
        sym(poc_lsb & ((1 << pb) - 1), pb)
    else:
        sym(0, 0)

    sym(1, 1)                      # num_ref_idx_active_override_flag = 1
    # num_ref_idx_l0_active_minus1 = [st?] + 2 atlases + waypoints - 1.
    sym_ue(num_waypoints + 1 + st_lead.to(torch.int64))

    sym(1, 1)                      # ref_pic_list_modification_flag_l0 = 1
    sym_ue(0, st_lead)             # idc 0: short-term, pic_num down
    sym_ue(torch.clamp(prev_ref_abs_diff - 1, min=0), st_lead)
    sym_ue(2)
    sym_ue(0)                      # long_term_pic_num 0 (atlas A)
    sym_ue(2)
    sym_ue(1)                      # long_term_pic_num 1 (atlas B)
    for i in range(MAX_WAYPOINTS):
        present = (i < num_waypoints) & wp_valid[:, i]
        sym_ue(2, present)
        sym_ue(wp_long_term_idx[:, i], present)
    sym_ue(3)                      # end of modification

    # dec_ref_pic_marking (reference pictures only).
    mmco = is_reference & (long_term_idx >= 0)
    lt = torch.clamp(long_term_idx, min=0)
    sym(mmco.to(torch.int64), is_reference.to(torch.int64))  # adaptive flag
    sym_ue(4, mmco)                # MMCO 4
    sym_ue(lt + 1, mmco)           # max_long_term_frame_idx_plus1
    sym_ue(6, mmco)                # MMCO 6
    sym_ue(lt, mmco)               # long_term_frame_idx
    sym_ue(0, mmco)                # MMCO 0 (end)

    # slice_qp_delta (static se(v)).
    sym_ue(2 * slice_qp_delta - 1 if slice_qp_delta > 0
           else -2 * slice_qp_delta)
    if cfg.deblocking_filter_control_present_flag:
        sym_ue(1)                  # disable_deblocking_filter_idc = 1
    else:
        sym(0, 0)

    patterns = torch.stack(pats, dim=1)
    nbits = torch.stack(bits, dim=1)
    assert patterns.shape[1] == P_HEADER_SLOTS, patterns.shape
    return patterns, nbits


def write_p_slice_header(bw: BitWriter, cfg: ComposerConfig, frame_num: int,
                         *, is_reference: bool = False,
                         long_term_idx: int = -1, num_waypoints: int = 0,
                         wp_long_term_idx=(),
                         slice_qp_delta: int = 0,
                         prev_ref_abs_diff: int | None = None) -> None:
    """Host twin of p_slice_header_symbols (bit-identical output).

    prev_ref_abs_diff: when not None, the active reference list leads
    with a SHORT-TERM picture — reordering idc 0 with
    abs_diff_pic_num_minus1 = prev_ref_abs_diff - 1 — ahead of the
    long-term atlases (successive-donor splicing: the dynamic rect of
    frame N references composed frame N-1)."""
    bw.write_ue(0)
    bw.write_ue(SLICE_TYPE_P)
    bw.write_ue(0)
    bw.write_bits(frame_num & ((1 << cfg.log2_max_frame_num) - 1),
                  cfg.log2_max_frame_num)
    if cfg.pic_order_cnt_type == 0:
        bw.write_bits((frame_num * 2)
                      & ((1 << cfg.log2_max_pic_order_cnt_lsb) - 1),
                      cfg.log2_max_pic_order_cnt_lsb)
    n_st = 1 if prev_ref_abs_diff is not None else 0
    bw.write_bit(1)                       # num_ref_idx_active_override
    bw.write_ue(num_waypoints + 1 + n_st)  # [st?] + 2 atlases + waypoints
    bw.write_bit(1)                       # ref_pic_list_modification
    if n_st:
        bw.write_ue(0)                    # idc 0: short-term, pic_num down
        bw.write_ue(prev_ref_abs_diff - 1)
    bw.write_ue(2)
    bw.write_ue(0)
    bw.write_ue(2)
    bw.write_ue(1)
    for i in range(num_waypoints):
        bw.write_ue(2)
        bw.write_ue(wp_long_term_idx[i])
    bw.write_ue(3)
    if is_reference:
        if long_term_idx >= 0:
            bw.write_bit(1)
            bw.write_ue(4)
            bw.write_ue(long_term_idx + 1)
            bw.write_ue(6)
            bw.write_ue(long_term_idx)
            bw.write_ue(0)
        else:
            bw.write_bit(0)
    bw.write_se(slice_qp_delta)
    if cfg.deblocking_filter_control_present_flag:
        bw.write_ue(1)


# ---------------------------------------------------------------------------
# Host-side I-slice headers (session setup: I_PCM atlas frames).
# ---------------------------------------------------------------------------

def write_idr_slice_header(bw: BitWriter, cfg: ComposerConfig,
                           long_term_reference_flag: int = 1) -> None:
    """IDR I-slice header, frame_num=0, marks long-term atlas slot 0
    (h264_encoder.c:622-662)."""
    bw.write_ue(0)                        # first_mb_in_slice
    bw.write_ue(7)                        # slice_type I_ALL
    bw.write_ue(0)                        # pps_id
    bw.write_bits(0, cfg.log2_max_frame_num)
    bw.write_ue(cfg.idr_pic_id)
    if cfg.pic_order_cnt_type == 0:
        bw.write_bits(0, cfg.log2_max_pic_order_cnt_lsb)
    bw.write_bit(0)                       # no_output_of_prior_pics_flag
    bw.write_bit(long_term_reference_flag)
    bw.write_se(0)                        # slice_qp_delta
    if cfg.deblocking_filter_control_present_flag:
        bw.write_ue(1)                    # disable deblocking


def write_non_idr_i_slice_header(bw: BitWriter, cfg: ComposerConfig,
                                 frame_num: int) -> None:
    """Non-IDR I-slice header with MMCO 4/6/0 marking long-term idx 1
    (h264_encoder.c:667-715)."""
    bw.write_ue(0)
    bw.write_ue(7)                        # I_ALL
    bw.write_ue(0)
    bw.write_bits(frame_num, cfg.log2_max_frame_num)
    if cfg.pic_order_cnt_type == 0:
        bw.write_bits(frame_num * 2, cfg.log2_max_pic_order_cnt_lsb)
    bw.write_bit(1)                       # adaptive_ref_pic_marking_mode_flag
    bw.write_ue(4)                        # MMCO 4
    bw.write_ue(2)                        # max_long_term_frame_idx_plus1 = 2
    bw.write_ue(6)                        # MMCO 6
    bw.write_ue(1)                        # long_term_frame_idx = 1
    bw.write_ue(0)                        # MMCO 0 end
    bw.write_se(0)
    if cfg.deblocking_filter_control_present_flag:
        bw.write_ue(1)
