"""Composer configuration.

Mirrors the reference's ComposerConfig / H264EncoderConfig
(include/h264_writer.h:37-59, include/h264_encoder.h:46-74) including the
dual-config pattern: a *parse* config carrying the donor encoder's SPS/PPS
geometry and a *write* config carrying our own parameters
(src/composer.c:192-203).

Static geometry (width/height/flags) is Python-level so buffer shapes
are fixed per configuration; per-session dynamic state (frame_num,
waypoint registry) lives in `parallel.batch.SessionState` as tensors with
a leading session dimension.  Copied unchanged in substance from the JAX
package's config (it has no framework dependency).
"""

from __future__ import annotations

import dataclasses

# Hardware vertical-MV limit: 496 px, safely under the 512 px (2048 qpel)
# limit NVDEC/VAAPI enforce regardless of signaled level
# (include/h264_writer.h:23-24, experiments/scroll-encoder/README.md:92-108).
MV_LIMIT_PX = 496

# Maximum number of waypoint long-term references (include/h264_writer.h:27).
MAX_WAYPOINTS = 8

# Static bound on emulation-prevention insertions per frame: sizes the
# bounded NAL buffer at rbsp + cap bytes (composed CAVLC streams carry
# ~0-5 insertions).  Frames exceeding it are flagged as
# overflow exactly like the RBSP bit budget and re-emitted through the
# exact unbounded path (session retry contract), so this is a fast-path
# tuning knob, not a capability limit.
MAX_EBSP_INSERTIONS = 16

# Slice types (H.264 Table 7-6; include/h264_writer.h:19-21).
SLICE_TYPE_P = 0
SLICE_TYPE_I = 2
SLICE_TYPE_I_ALL = 7

# NAL unit types / ref idc (include/nal.h:10-23).
NAL_TYPE_SLICE = 1
NAL_TYPE_IDR = 5
NAL_TYPE_SEI = 6
NAL_TYPE_SPS = 7
NAL_TYPE_PPS = 8
NAL_TYPE_AUD = 9

NAL_REF_IDC_NONE = 0
NAL_REF_IDC_LOW = 1
NAL_REF_IDC_HIGH = 2
NAL_REF_IDC_HIGHEST = 3


@dataclasses.dataclass
class ComposerConfig:
    """Static encoder configuration (hashable; usable as a cache key).

    Defaults follow composer_config_init (src/h264_writer.c:13-28).
    """

    width: int
    height: int

    # Parsed/derived SPS values.
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb: int = 4

    # Parsed/derived PPS values.
    num_ref_idx_l0_default_minus1: int = 1
    deblocking_filter_control_present_flag: int = 1
    # Donor residuals are bit-copied, so they decode against whatever QP
    # base the session PPS declares: a donor session must adopt the
    # donor's pic_init_qp / chroma offset or every atlas decodes at the
    # wrong QP.  (Reference defect #6: h264_generate_pps hardcodes 0/0 —
    # src/h264_writer.c:118,120 — while generate_refs.sh donors are x264
    # output whose PPS carries e.g. pic_init_qp_minus26=-6,
    # chroma_qp_index_offset=-2; its atlases decode DC-shifted.)
    pic_init_qp_minus26: int = 0
    chroma_qp_index_offset: int = 0

    idr_pic_id: int = 0

    # Per-frame RBSP capacity budget in bits per macroblock.  The absolute
    # worst case is ~88 (max-magnitude mvds everywhere); real scroll/splice
    # frames run ~7-16.  Frames exceeding the budget set an overflow flag
    # (callers raise / fall back) rather than corrupting memory.  Smaller
    # budgets shrink every downstream buffer (pack, emulation prevention,
    # NAL) proportionally — the HBM-bandwidth lever.
    rbsp_bits_per_mb: int = 32

    def __post_init__(self):
        if self.width % 16 or self.height % 16:
            raise ValueError("width/height must be multiples of 16")

    @property
    def mb_width(self) -> int:
        return self.width // 16

    @property
    def mb_height(self) -> int:
        return self.height // 16

    @property
    def total_mbs(self) -> int:
        return self.mb_width * self.mb_height

    def with_sps_params(self, log2_max_frame_num: int, pic_order_cnt_type: int,
                        log2_max_pic_order_cnt_lsb: int) -> "ComposerConfig":
        """composer_config_set_sps_params (src/h264_writer.c:30-37)."""
        return dataclasses.replace(
            self,
            log2_max_frame_num=log2_max_frame_num,
            pic_order_cnt_type=pic_order_cnt_type,
            log2_max_pic_order_cnt_lsb=log2_max_pic_order_cnt_lsb,
        )

    def with_pps_params(self, num_ref_idx_l0_default_minus1: int,
                        deblocking_filter_control_present_flag: int,
                        pic_init_qp_minus26: int = 0,
                        chroma_qp_index_offset: int = 0) -> "ComposerConfig":
        """composer_config_set_pps_params (src/h264_writer.c:39-44), plus
        the QP base fields the reference fails to carry (defect #6)."""
        return dataclasses.replace(
            self,
            num_ref_idx_l0_default_minus1=num_ref_idx_l0_default_minus1,
            deblocking_filter_control_present_flag=deblocking_filter_control_present_flag,
            pic_init_qp_minus26=pic_init_qp_minus26,
            chroma_qp_index_offset=chroma_qp_index_offset,
        )

    # Hashability for use as a cache key.
    def __hash__(self):
        return hash(dataclasses.astuple(self))
