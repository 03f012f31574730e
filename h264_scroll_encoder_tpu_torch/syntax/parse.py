"""Host-side Annex-B / SPS / PPS / slice-header parsing.

Copied unchanged from h264_scroll_encoder_tpu/syntax/parse.py (it has no
framework dependency), so the port runs where jax is absent.

Behavioral parity targets: nal_parser_next (src/nal_parser.c:28-65),
parse_sps (:137-222) including the High-profile chroma branch and the
explicit rejections (scaling matrices, poc_type 1, slice groups),
parse_pps (:224-276), and parse_idr_slice_header (src/h264_writer.c:194-226).

Parsing runs once per session on donor streams (tiny), so it stays on the
host; start-code scanning is vectorized with numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.bitio import BitReader
from ..ops.ebsp import ebsp_to_rbsp_np


@dataclasses.dataclass
class NALUnit:
    nal_ref_idc: int
    nal_unit_type: int
    data: bytes          # EBSP payload (after the header byte)

    @property
    def rbsp(self) -> bytes:
        return ebsp_to_rbsp_np(np.frombuffer(self.data, np.uint8)).tobytes()


def find_start_codes(data: np.ndarray) -> np.ndarray:
    """Indices i where a 00 00 01 pattern begins (vectorized)."""
    if data.size < 3:
        return np.empty(0, np.int64)
    z0 = data[:-2] == 0
    z1 = data[1:-1] == 0
    one = data[2:] == 1
    return np.nonzero(z0 & z1 & one)[0]


def iter_nal_units(stream: bytes):
    """Yield NALUnits from an Annex-B stream (nal_parser_next semantics:
    trailing zeros before the next start code are stripped)."""
    data = np.frombuffer(stream, np.uint8)
    starts = find_start_codes(data)
    if starts.size == 0:
        return
    # Payload begins after each 00 00 01; a preceding 0 byte means it was a
    # 4-byte start code (the extra zero also terminates the previous NAL).
    payload_starts = starts + 3
    for k, ps in enumerate(payload_starts):
        end = int(starts[k + 1]) if k + 1 < len(starts) else data.size
        # Strip trailing zeros (start-code prefix zeros / padding).
        while end > ps and data[end - 1] == 0:
            end -= 1
        if end <= ps:
            continue
        header = int(data[ps])
        yield NALUnit(
            nal_ref_idc=(header >> 5) & 0x03,
            nal_unit_type=header & 0x1F,
            data=data[ps + 1:end].tobytes(),
        )


@dataclasses.dataclass
class SPSInfo:
    width: int
    height: int
    log2_max_frame_num: int
    pic_order_cnt_type: int
    log2_max_pic_order_cnt_lsb: int


_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134}


class UnsupportedStream(ValueError):
    """Stream uses syntax the composer rejects (matching the C -1 returns)."""


def parse_sps(rbsp: bytes) -> SPSInfo:
    br = BitReader(rbsp)
    profile_idc = br.read_bits(8)
    br.read_bits(8)   # constraint flags + reserved
    br.read_bits(8)   # level_idc
    br.read_ue()      # seq_parameter_set_id

    if profile_idc in _HIGH_PROFILES:
        chroma_format_idc = br.read_ue()
        if chroma_format_idc == 3:
            br.read_bit()     # separate_colour_plane_flag
        br.read_ue()          # bit_depth_luma_minus8
        br.read_ue()          # bit_depth_chroma_minus8
        br.read_bit()         # qpprime_y_zero_transform_bypass_flag
        if br.read_bit():     # seq_scaling_matrix_present_flag
            raise UnsupportedStream("scaling matrices not supported")

    log2_max_frame_num = br.read_ue() + 4
    pic_order_cnt_type = br.read_ue()
    log2_max_pic_order_cnt_lsb = 0
    if pic_order_cnt_type == 0:
        log2_max_pic_order_cnt_lsb = br.read_ue() + 4
    elif pic_order_cnt_type == 1:
        raise UnsupportedStream("pic_order_cnt_type 1 not supported")

    br.read_ue()    # max_num_ref_frames
    br.read_bit()   # gaps_in_frame_num_value_allowed_flag
    pic_width_in_mbs = br.read_ue() + 1
    pic_height_in_map_units = br.read_ue() + 1
    frame_mbs_only = br.read_bit()
    mb_height = pic_height_in_map_units
    if not frame_mbs_only:
        br.read_bit()  # mb_adaptive_frame_field_flag
        mb_height *= 2

    return SPSInfo(
        width=pic_width_in_mbs * 16,
        height=mb_height * 16,
        log2_max_frame_num=log2_max_frame_num,
        pic_order_cnt_type=pic_order_cnt_type,
        log2_max_pic_order_cnt_lsb=log2_max_pic_order_cnt_lsb,
    )


@dataclasses.dataclass
class PPSInfo:
    num_ref_idx_l0_default_active_minus1: int
    deblocking_filter_control_present_flag: int
    pic_init_qp_minus26: int = 0
    chroma_qp_index_offset: int = 0
    entropy_coding_mode_flag: int = 0


def parse_pps(rbsp: bytes) -> PPSInfo:
    br = BitReader(rbsp)
    br.read_ue()    # pic_parameter_set_id
    br.read_ue()    # seq_parameter_set_id
    entropy = br.read_bit()  # entropy_coding_mode_flag (1 = CABAC)
    br.read_bit()   # bottom_field_pic_order_in_frame_present_flag
    if br.read_ue() > 0:  # num_slice_groups_minus1
        raise UnsupportedStream("slice groups not supported")
    num_ref_idx_l0 = br.read_ue()
    br.read_ue()    # num_ref_idx_l1_default_active_minus1
    br.read_bit()   # weighted_pred_flag
    br.read_bits(2)  # weighted_bipred_idc
    pic_init_qp_minus26 = br.read_se()
    br.read_se()    # pic_init_qs_minus26
    chroma_qp_index_offset = br.read_se()
    deblock = br.read_bit()
    return PPSInfo(
        num_ref_idx_l0_default_active_minus1=num_ref_idx_l0,
        deblocking_filter_control_present_flag=deblock,
        pic_init_qp_minus26=pic_init_qp_minus26,
        chroma_qp_index_offset=chroma_qp_index_offset,
        entropy_coding_mode_flag=entropy,
    )


@dataclasses.dataclass
class ParsedSliceHeader:
    mb_data_start_bit: int
    slice_qp_delta: int
    disable_deblocking_filter_idc: int
    slice_alpha_c0_offset_div2: int
    slice_beta_offset_div2: int


def parse_idr_slice_header(rbsp: bytes, *, log2_max_frame_num: int,
                           pic_order_cnt_type: int,
                           log2_max_pic_order_cnt_lsb: int,
                           deblocking_filter_control_present_flag: int
                           ) -> ParsedSliceHeader:
    """Locate the donor IDR's MB-data start bit and the fields we preserve
    (parse_idr_slice_header, src/h264_writer.c:194-226)."""
    br = BitReader(rbsp)
    br.read_ue()     # first_mb_in_slice
    br.read_ue()     # slice_type
    br.read_ue()     # pps_id
    br.read_bits(log2_max_frame_num)   # frame_num
    br.read_ue()     # idr_pic_id
    if pic_order_cnt_type == 0:
        br.read_bits(log2_max_pic_order_cnt_lsb)
    br.read_bit()    # no_output_of_prior_pics_flag
    br.read_bit()    # long_term_reference_flag
    slice_qp_delta = br.read_se()
    disable_idc = 0
    alpha = beta = 0
    if deblocking_filter_control_present_flag:
        disable_idc = br.read_ue()
        if disable_idc != 1:
            alpha = br.read_se()
            beta = br.read_se()
    return ParsedSliceHeader(
        mb_data_start_bit=br.bit_position,
        slice_qp_delta=slice_qp_delta,
        disable_deblocking_filter_idc=disable_idc,
        slice_alpha_c0_offset_div2=alpha,
        slice_beta_offset_div2=beta,
    )
