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

`emit_hint_frame` runs one session's frame as one CUDA graph per
configuration on the card (utils/graphs; the JAX package's
`_jitted_hint_frame`), its inputs in one copy of one packed row.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..config import ComposerConfig, MAX_WAYPOINTS
from ..syntax.slice_headers import p_slice_header_symbols
from ..utils import graphs
from . import scroll as scroll_model
from .splice import FrameHints


def _field_grids(cfg: ComposerConfig, hints: FrameHints):
    """hint_fields' (ref, mv_x, mv_y) as numpy int32 grids [h, w]."""
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
    return ref, mvx, mvy


def hint_fields(cfg: ComposerConfig, hints: FrameHints, device="cuda"):
    """FrameHints -> dense (ref, mv_x, mv_y) int32 MB grids [h, w] on
    `device` (the card unless the caller asks for the CPU).

    Background is static chrome referencing atlas slot 0 with zero MV
    (P_Skip-eligible); motion regions override with their hinted vector.
    Later regions win where they overlap (z-order, MASTER_DESIGN §10).
    """
    device = _kernels.resolve_device(device)
    return tuple(torch.as_tensor(a, device=device)
                 for a in _field_grids(cfg, hints))


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
    fn = torch.as_tensor(frame_num).to(torch.int32) % (1 << cfg.log2_max_frame_num)
    num_waypoints = scroll_model._i32(num_waypoints, fn)
    hp, hn = p_slice_header_symbols(
        cfg, fn, fn * 2, is_reference=False, long_term_idx=-1,
        num_waypoints=num_waypoints, wp_long_term_idx=wp_ltidx,
        wp_valid=wp_valid)
    return scroll_model.emit_p_frame(
        cfg, hp, hn, ref, mv_x, mv_y, num_refs=2 + num_waypoints,
        nal_ref_idc=0, enable_pskip=enable_pskip, compact_x=compact_x)


@graphs.step_factory
def graphed_hint_frame(cfg: ComposerConfig, enable_pskip: bool):
    """hint_frame of one session from one packed int32 row — frame_num,
    num_waypoints, the registry's long-term indices and validity
    (MAX_WAYPOINTS each), then the ref, mv_x and mv_y grids (h * w each) —
    as one graph per configuration (the JAX package's _jitted_hint_frame):
    row -> (nal u8[1, n_nal], nal_len i32[1], rbsp_bits i32[1],
    overflow bool[1])."""
    H, W, M = cfg.mb_height, cfg.mb_width, MAX_WAYPOINTS

    def frame(row):
        o, n = 2 + 2 * M, H * W
        grids = [row[o + k * n:o + (k + 1) * n].view(1, H, W)
                 for k in range(3)]
        return hint_frame(cfg, row[0:1], *grids, row[1:2],
                          row[2:2 + M].view(1, M),
                          row[2 + M:2 + 2 * M].view(1, M).to(torch.bool),
                          enable_pskip=enable_pskip)
    return graphs.graphed(frame, "session hint frame")


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
    row = hint_frame_row(cfg, frame_num, hints, num_waypoints, wp_ltidx,
                         wp_valid)
    return graphed_hint_frame(cfg, enable_pskip)(
        torch.from_numpy(row).to(device))


def hint_frame_row(cfg: ComposerConfig, frame_num: int, hints: FrameHints,
                   num_waypoints=0, wp_ltidx=None, wp_valid=None):
    """graphed_hint_frame's packed row (numpy int32) of one session's
    frame: its registry as emit_hint_frame takes it (none when omitted)."""
    def registry(x):
        if x is None:
            return np.zeros(MAX_WAYPOINTS, np.int32)
        if isinstance(x, torch.Tensor):
            x = x.cpu()
        return np.asarray(x).astype(np.int32).reshape(MAX_WAYPOINTS)

    return np.concatenate([
        np.asarray([frame_num, num_waypoints], np.int32),
        registry(wp_ltidx), registry(wp_valid),
        *(g.reshape(-1) for g in _field_grids(cfg, hints))])
