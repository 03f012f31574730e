"""UI-hint-driven frame composition (MASTER_DESIGN §5 per-frame hints).

Port of h264_scroll_encoder_tpu/models/hints.py.  Builds per-MB (ref, mv)
field grids from `FrameHints` motion regions over a static-chrome
background, then emits through the standard compose path
(models/scroll.emit_p_frame -> finish_slice -> K1).  With
`enable_pskip=True` the chrome (ref 0, zero MV) collapses into P_Skip
runs — the "composer 720p: static chrome + scroll region as P_Skip runs
with long-term ref atlas" configuration.

The dynamic-rect donor path lives in models/splice_device.py (device) and
models/splice.py (host); this module is the donor-less fast path.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..config import ComposerConfig, MAX_WAYPOINTS
from ..syntax.slice_headers import p_slice_header_symbols
from . import scroll as scroll_model
from .splice import FrameHints


def hint_fields(cfg: ComposerConfig, hints: FrameHints, device="cuda"):
    """FrameHints -> dense (ref, mv_x, mv_y) int32 MB grids [h, w] on
    `device` (the card unless the caller asks for the CPU).

    Background is static chrome referencing atlas slot 0 with zero MV
    (P_Skip-eligible); motion regions override with their hinted vector.
    Later regions win where they overlap (z-order, MASTER_DESIGN §10).
    """
    device = _kernels.resolve_device(device)
    H, W = cfg.mb_height, cfg.mb_width
    ref = np.zeros((H, W), np.int32)
    mvx = np.zeros((H, W), np.int32)
    mvy = np.zeros((H, W), np.int32)
    for reg in hints.motion_regions:
        ys = slice(max(0, reg.mb_y0), min(H, reg.mb_y1))
        xs = slice(max(0, reg.mb_x0), min(W, reg.mb_x1))
        ref[ys, xs] = reg.ref_idx
        mvx[ys, xs] = reg.mv_x * 4
        mvy[ys, xs] = reg.mv_y * 4
    return tuple(torch.as_tensor(a, device=device) for a in (ref, mvx, mvy))


def hint_frame(cfg: ComposerConfig, frame_num, ref, mv_x, mv_y,
               num_waypoints, wp_ltidx, wp_valid, *,
               enable_pskip: bool = True, compact_x: bool = False):
    """One non-reference hint-composed P-frame per session: frame_num and
    num_waypoints int[B], field grids int[B, h, w], the waypoint registry
    [B, MAX_WAYPOINTS] for the reference list (2 + num_waypoints entries,
    per session).  compact_x packs each MB into two symbol slots (valid
    when every mv_x is zero; byte-identical to the generic layout there).
    Returns (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
    overflow bool[B]) on the device of the inputs."""
    fn = torch.as_tensor(frame_num).to(torch.int64) % (1 << cfg.log2_max_frame_num)
    num_waypoints = scroll_model._i64(num_waypoints, fn)
    hp, hn = p_slice_header_symbols(
        cfg, fn, fn * 2, is_reference=False, long_term_idx=-1,
        num_waypoints=num_waypoints, wp_long_term_idx=wp_ltidx,
        wp_valid=wp_valid)
    return scroll_model.emit_p_frame(
        cfg, hp, hn, ref, mv_x, mv_y, num_refs=2 + num_waypoints,
        nal_ref_idc=0, enable_pskip=enable_pskip, compact_x=compact_x)


def emit_hint_frame(cfg: ComposerConfig, frame_num: int, hints: FrameHints,
                    *, enable_pskip: bool = True, num_waypoints=0,
                    wp_ltidx=None, wp_valid=None, device="cuda"):
    """One hint-composed P-frame NAL on `device` (the card unless the
    caller asks for the CPU), as a batch of one session: wp_ltidx and
    wp_valid are that session's registry ([MAX_WAYPOINTS] or
    [1, MAX_WAYPOINTS]; none registered when omitted).

    Returns (nal u8[1, n_nal], nal_len i32[1], rbsp_bits i32[1],
    overflow bool[1])."""
    device = _kernels.resolve_device(device)
    ref, mvx, mvy = hint_fields(cfg, hints, device)

    def registry(x, dtype):
        if x is None:
            return torch.zeros((1, MAX_WAYPOINTS), dtype=dtype, device=device)
        return torch.as_tensor(x, device=device).to(dtype).reshape(
            1, MAX_WAYPOINTS)

    return hint_frame(
        cfg, torch.tensor([frame_num], device=device), ref[None], mvx[None],
        mvy[None], torch.as_tensor(num_waypoints, device=device).reshape(1),
        registry(wp_ltidx, torch.int32), registry(wp_valid, torch.bool),
        enable_pskip=enable_pskip)
