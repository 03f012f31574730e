"""Slice headers: P headers as batched fixed-shape symbol streams (device)
and the host writers of P, IDR and non-IDR I headers.

Port of h264_scroll_encoder_tpu/syntax/slice_headers.py.  Byte-parity
targets in the C reference: h264_write_p_slice_header and
h264_write_p_slice_header_waypoint (src/h264_writer.c:455-539),
h264_write_idr_slice_header and h264_write_non_idr_i_slice_header
(experiments/scroll-encoder/src/h264_encoder.c:622-715).  The base P
header is the waypoint variant specialized to zero waypoints and no MMCO
self-marking, so one branchless stream covers both: every optional field
has a fixed slot whose nbits is 0 when absent.  On CUDA tensors the
stream is one launch of K7 (csrc/header_kernels.cu), on CPU tensors its
plain version.  The host writers are copied unchanged (they have no
framework dependency).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .. import _kernels
from ..config import ComposerConfig, MAX_WAYPOINTS, SLICE_TYPE_P
from ..ops import expgolomb, grid
from ..ops.bitio import BitWriter

# Slot budget for the P slice header symbol stream (incl. the two
# optional short-term-lead reordering slots).
P_HEADER_SLOTS = 14 + 2 * MAX_WAYPOINTS + 7 + 2


def p_slice_header_symbols(cfg: ComposerConfig, frame_num, poc_lsb,
                           is_reference, long_term_idx,
                           num_waypoints, wp_long_term_idx, wp_valid,
                           first_mb=0, slice_qp_delta: int = 0,
                           prev_ref_abs_diff=0):
    """P slice headers as (patterns int32[B, P_HEADER_SLOTS] holding the
    JAX package's uint32 bits, nbits int32[B, P_HEADER_SLOTS]): the plain
    version for a CPU frame_num, one launch of K7 (csrc/header_kernels.cu,
    h264t_p_slice_header) for a CUDA one.

    The kernel reads each tensor input in place, in its own integer or
    bool dtype and strides, and takes a Python integer every session
    shares by value; it refuses (TypeError, ValueError) a tensor on
    another device, of a float dtype or of another shape, and anything
    else the plain version would first convert (lists, numpy arrays):
    there is no fallback.  Around the launch it runs no tensor op (the
    outputs are torch.empty).

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
    if frame_num.device.type != "cuda":
        return p_slice_header_symbols_plain(
            cfg, frame_num, poc_lsb, is_reference, long_term_idx,
            num_waypoints, wp_long_term_idx, wp_valid, first_mb,
            slice_qp_delta, prev_ref_abs_diff)
    return _p_slice_header_kernel(cfg, slice_qp_delta, dict(
        frame_num=frame_num, poc_lsb=poc_lsb, is_reference=is_reference,
        long_term_idx=long_term_idx, num_waypoints=num_waypoints,
        prev_ref_abs_diff=prev_ref_abs_diff, first_mb=first_mb,
        wp_long_term_idx=wp_long_term_idx, wp_valid=wp_valid))


def p_slice_header_symbols_plain(cfg: ComposerConfig, frame_num, poc_lsb,
                                 is_reference, long_term_idx,
                                 num_waypoints, wp_long_term_idx, wp_valid,
                                 first_mb=0, slice_qp_delta: int = 0,
                                 prev_ref_abs_diff=0):
    """p_slice_header_symbols in plain torch, with the same arguments and
    returns: K7's contract, and what CPU tensors run.  It takes what the
    kernel refuses too (lists and numpy arrays are placed on frame_num's
    device, other dtypes converted)."""
    frame_num = torch.as_tensor(frame_num)
    B = frame_num.shape[0]
    dev = frame_num.device

    def vec(x, dtype=torch.int32):
        if isinstance(x, (bool, int)):
            # A value every session shares is filled on the device: a CUDA
            # graph captures the fill, where it refuses a host copy.
            return torch.full((B,), x, dtype=dtype, device=dev)
        t = torch.as_tensor(x, device=dev).to(dtype)
        return t.expand(B) if t.dim() == 0 else t

    poc_lsb = vec(poc_lsb)
    is_reference = vec(is_reference, torch.bool)
    long_term_idx = vec(long_term_idx)
    num_waypoints = vec(num_waypoints)
    wp_long_term_idx = torch.as_tensor(wp_long_term_idx,
                                       device=dev).to(torch.int32)
    wp_valid = torch.as_tensor(wp_valid, device=dev).to(torch.bool)
    prev_ref_abs_diff = vec(prev_ref_abs_diff)
    st_lead = prev_ref_abs_diff > 0

    pats = []
    bits = []

    def sym(pattern, nbits):
        pats.append(vec(pattern))
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
    sym_ue(num_waypoints + 1 + st_lead.to(torch.int32))

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
    sym(mmco.to(torch.int32), is_reference.to(torch.int32))  # adaptive flag
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


# K7's inputs in the order of its descriptors (csrc/header_kernels.cu's
# HeaderInput): (argument, read as a flag); the last two are the
# [B, MAX_WAYPOINTS] registry.
_K7_INPUTS = (("frame_num", False), ("poc_lsb", False),
              ("is_reference", True), ("long_term_idx", False),
              ("num_waypoints", False), ("prev_ref_abs_diff", False),
              ("first_mb", False), ("wp_long_term_idx", False),
              ("wp_valid", True))
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _int32_value(name: str, v: int) -> int:
    if not _INT32_MIN <= v <= _INT32_MAX:
        raise ValueError(f"P slice header: {name} = {v} does not fit int32")
    return v


def _k7_input(name: str, x, B: int, dev, flag: bool, registry: bool):
    """(descriptor, value) of one input of K7: a Python integer every
    session shares by value (address 0), or a tensor on `dev` read in place
    (0-dim or [B]; the registry [B, >= MAX_WAYPOINTS]), as ops/grid's
    _field describes it.  Anything else raises."""
    if not isinstance(x, torch.Tensor):
        if registry or not isinstance(x, numbers.Integral):
            raise TypeError(f"P slice header on {dev}: {name} must be a "
                            f"tensor on {dev}"
                            + ("" if registry else " or a Python integer")
                            + f", not {type(x).__name__}")
        return (0, 0, 0, 0, 4), int(bool(x)) if flag else _int32_value(
            name, int(x))
    if x.device != dev:
        raise ValueError(f"P slice header: {name} is on {x.device}, not "
                         f"{dev} (no copy is made)")
    if x.dtype not in grid._DTYPE_CODES:
        raise TypeError(f"P slice header: {name} must be an integer or bool "
                        f"tensor, not {x.dtype}")
    e, code = x.element_size(), grid._DTYPE_CODES[x.dtype]
    if registry:
        if x.dim() != 2 or x.shape[0] != B or x.shape[1] < MAX_WAYPOINTS:
            raise ValueError(f"P slice header: {name} is {tuple(x.shape)}, "
                             f"not [{B}, {MAX_WAYPOINTS}]")
        return (x.data_ptr(), x.stride(0) * e, 0, x.stride(1) * e, code), 0
    if x.dim() == 0:
        return (x.data_ptr(), 0, 0, 0, code), 0
    if x.dim() != 1 or x.shape[0] != B:
        raise ValueError(f"P slice header: {name} is {tuple(x.shape)}, not "
                         f"[{B}] or a scalar")
    return (x.data_ptr(), x.stride(0) * e, 0, 0, code), 0


def _p_slice_header_kernel(cfg, slice_qp_delta, args: dict):
    """K7 on frame_num's card over the per-session arguments `args` (by
    name): one launch, none at B = 0."""
    frame_num = args["frame_num"]
    if frame_num.dim() != 1:
        raise ValueError(f"P slice header: frame_num is "
                         f"{tuple(frame_num.shape)}, not [B]")
    B, dev = frame_num.shape[0], frame_num.device
    inputs = [_k7_input(name, args[name], B, dev, flag,
                        name.startswith("wp_"))
              for name, flag in _K7_INPUTS]
    qp_ue = _int32_value("slice_qp_delta", 2 * slice_qp_delta - 1
                         if slice_qp_delta > 0 else -2 * slice_qp_delta)
    poc_bits = (cfg.log2_max_pic_order_cnt_lsb
                if cfg.pic_order_cnt_type == 0 else 0)
    with torch.cuda.device(dev):
        patterns = torch.empty((B, P_HEADER_SLOTS), dtype=torch.int32,
                               device=dev)
        nbits = torch.empty((B, P_HEADER_SLOTS), dtype=torch.int32,
                            device=dev)
        if B:
            values = (ctypes.c_int * len(inputs))(*(v for _d, v in inputs))
            _kernels.P_SLICE_HEADER.launch(
                grid._descriptors([d for d, _v in inputs]), values, B,
                cfg.log2_max_frame_num, poc_bits,
                int(bool(cfg.deblocking_filter_control_present_flag)),
                SLICE_TYPE_P, qp_ue, P_HEADER_SLOTS, MAX_WAYPOINTS,
                patterns.data_ptr(), nbits.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
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
