"""SPS / PPS generation.

Copied unchanged from h264_scroll_encoder_tpu/syntax/params.py (it has
no framework dependency), so the port runs where jax is absent.

Byte-parity targets: h264_generate_sps (src/h264_writer.c:49-100) and
h264_generate_pps (:105-127) — minimal Baseline (profile 66, constraints
0xc0, level 4.0) SPS with max_num_ref_frames = 2 + MAX_WAYPOINTS and
poc_type 2, and a minimal CAVLC PPS with 2 default refs and the
deblocking-control flag set.

These run once per session on the host; the output is a static byte string
per (width, height), so there is nothing to vectorize.
"""

from __future__ import annotations

import functools

from ..config import MAX_WAYPOINTS
from ..ops.bitio import BitWriter


@functools.lru_cache(maxsize=None)
def generate_sps(width: int, height: int, *, level_idc: int = 40,
                 max_num_ref_frames: int = 2 + MAX_WAYPOINTS,
                 log2_max_frame_num: int = 4) -> bytes:
    """Minimal Baseline-profile SPS RBSP (src/h264_writer.c:49-100)."""
    bw = BitWriter()
    bw.write_bits(66, 8)            # profile_idc: Baseline
    bw.write_bits(0xC0, 8)          # constraint_set0/1 + reserved
    bw.write_bits(level_idc, 8)     # level_idc (4.0 allows the MV range)
    bw.write_ue(0)                  # seq_parameter_set_id
    bw.write_ue(log2_max_frame_num - 4)  # log2_max_frame_num_minus4
    bw.write_ue(2)                  # pic_order_cnt_type = 2
    bw.write_ue(max_num_ref_frames)  # 2 base refs + waypoints
    bw.write_bit(0)                 # gaps_in_frame_num_value_allowed_flag
    bw.write_ue(width // 16 - 1)    # pic_width_in_mbs_minus1
    bw.write_ue(height // 16 - 1)   # pic_height_in_map_units_minus1
    bw.write_bit(1)                 # frame_mbs_only_flag
    bw.write_bit(1)                 # direct_8x8_inference_flag
    bw.write_bit(0)                 # frame_cropping_flag
    bw.write_bit(0)                 # vui_parameters_present_flag
    bw.write_trailing_bits()
    return bw.getvalue()


@functools.lru_cache(maxsize=None)
def generate_pps(*, num_ref_idx_l0_default_active_minus1: int = 1,
                 pic_init_qp_minus26: int = 0,
                 chroma_qp_index_offset: int = 0) -> bytes:
    """Minimal CAVLC PPS RBSP (src/h264_writer.c:105-127)."""
    bw = BitWriter()
    bw.write_ue(0)                  # pic_parameter_set_id
    bw.write_ue(0)                  # seq_parameter_set_id
    bw.write_bit(0)                 # entropy_coding_mode_flag (CAVLC)
    bw.write_bit(0)                 # bottom_field_pic_order_in_frame_present
    bw.write_ue(0)                  # num_slice_groups_minus1
    bw.write_ue(num_ref_idx_l0_default_active_minus1)
    bw.write_ue(0)                  # num_ref_idx_l1_default_active_minus1
    bw.write_bit(0)                 # weighted_pred_flag
    bw.write_bits(0, 2)             # weighted_bipred_idc
    bw.write_se(pic_init_qp_minus26)
    bw.write_se(0)                  # pic_init_qs_minus26
    bw.write_se(chroma_qp_index_offset)
    bw.write_bit(1)                 # deblocking_filter_control_present_flag
    bw.write_bit(0)                 # constrained_intra_pred_flag
    bw.write_bit(0)                 # redundant_pic_cnt_present_flag
    bw.write_trailing_bits()
    return bw.getvalue()
