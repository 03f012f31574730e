"""Batched multi-session compose: one P-frame per session per step.

Port of the batched step of h264_scroll_encoder_tpu/parallel/batch.py.
The reference is a single-threaded C program; the first-class parallel
axis is data parallelism over independent UI sessions.  Per-session state
(frame_num + waypoint registry) is a set of tensors with a leading session
dimension on the device, and each step composes one P-frame per session.

`make_batched_splice_step_rows` is the rows splice step (the serving hot
path): a pre-encoded donor rect composed into each session's P-frame;
`make_batched_splice_step_dense` is the same frame over the dense (per-MB)
donor layout, its byte-for-byte parity partner; `make_batched_hint_step`
composes hint frames (static chrome plus motion regions);
`compact_batch_nal` is egress, the sessions' valid bytes in one buffer.

Not ported yet: the sharded step.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..config import ComposerConfig, MAX_WAYPOINTS
from ..models import hints, scroll, splice_device
from ..models.splice_device import donor_arrays_from_numpy  # noqa: F401

_FIELDS = ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid", "wp_count")


@dataclasses.dataclass
class SessionState:
    """Device-resident per-session state (session dimension leading): the
    C reference's frame_num and waypoint registry, i.e. exactly what must
    be saved to evict and restore a session.  Field names and dtypes
    match the JAX package's SessionState."""
    frame_num: torch.Tensor        # int32[B]
    wp_offsets: torch.Tensor       # int32[B, MAX_WAYPOINTS]
    wp_ltidx: torch.Tensor         # int32[B, MAX_WAYPOINTS]
    wp_valid: torch.Tensor         # bool[B, MAX_WAYPOINTS]
    wp_count: torch.Tensor         # int32[B]

    @classmethod
    def create(cls, batch: int, frame_num: int = 2, *,
               device="cuda") -> "SessionState":
        """Fresh sessions, frame_num=2 (after the two atlas frames), on
        `device` (the card unless the caller asks for the CPU)."""
        device = _kernels.resolve_device(device)
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(
            frame_num=torch.full((batch,), frame_num, dtype=torch.int32,
                                 device=device),
            wp_offsets=z(batch, MAX_WAYPOINTS),
            wp_ltidx=z(batch, MAX_WAYPOINTS),
            wp_valid=z(batch, MAX_WAYPOINTS, dtype=torch.bool),
            wp_count=z(batch),
        )

    def to_numpy(self) -> dict:
        """Fields as numpy arrays (int32 / bool), the JAX package's layout."""
        return {f: getattr(self, f).cpu().numpy() for f in _FIELDS}

    @classmethod
    def from_numpy(cls, d, *, device="cuda") -> "SessionState":
        """State from numpy arrays keyed by field name — e.g. a JAX
        SessionState's fields — so both packages continue one session."""
        device = _kernels.resolve_device(device)
        def t(f, dtype):
            return torch.tensor(np.asarray(d[f]), device=device).to(dtype)
        return cls(frame_num=t("frame_num", torch.int32),
                   wp_offsets=t("wp_offsets", torch.int32),
                   wp_ltidx=t("wp_ltidx", torch.int32),
                   wp_valid=t("wp_valid", torch.bool),
                   wp_count=t("wp_count", torch.int32))


def _session_step(cfg: ComposerConfig, enable_pskip: bool,
                  emit_waypoints: bool, state: SessionState, offset_px):
    """One composed frame per session.

    Exactly one NAL per session per step: on a step whose offset crosses a
    496 px boundary (h264_needs_waypoint) it is the waypoint reference
    frame, which the session registers; the caller repeats the offset next
    step for the scroll frame.  A step that needs a 9th waypoint slot
    flags `overflow` (frame not servable) instead of silently emitting
    illegal > 496 px MVs.
    """
    offset_px = torch.as_tensor(offset_px, device=state.frame_num.device)
    offset_px = offset_px.to(torch.int64)
    wp_offsets = state.wp_offsets.to(torch.int64)
    wp_count = state.wp_count.to(torch.int64)
    if emit_waypoints:
        needs = scroll.needs_waypoint(offset_px, wp_offsets, state.wp_valid,
                                      wp_count)
    else:
        needs = torch.zeros_like(state.wp_valid[:, 0])

    nal, nal_len, rbsp_bits, overflow = scroll.unified_frame(
        cfg, state.frame_num, offset_px, wp_offsets, state.wp_ltidx,
        state.wp_valid, wp_count, needs, enable_pskip=enable_pskip)

    # Register the waypoint (masked scatter on [B, MAX_WAYPOINTS]).
    slot = torch.clamp(wp_count, max=MAX_WAYPOINTS - 1)
    exhausted = needs & (wp_count >= MAX_WAYPOINTS)
    can_reg = needs & ~exhausted
    idx = torch.arange(MAX_WAYPOINTS, device=slot.device)
    hit = (idx[None, :] == slot[:, None]) & can_reg[:, None]
    i32 = torch.int32
    state = SessionState(
        frame_num=state.frame_num + 1,
        wp_offsets=torch.where(hit, offset_px[:, None], wp_offsets).to(i32),
        wp_ltidx=torch.where(hit, 2 + wp_count[:, None],
                             state.wp_ltidx.to(torch.int64)).to(i32),
        wp_valid=state.wp_valid | hit,
        wp_count=(wp_count + can_reg.to(torch.int64)).to(i32),
    )
    return state, (nal, nal_len, needs, rbsp_bits, overflow | exhausted)


def make_batched_step(cfg: ComposerConfig, *, enable_pskip: bool = False,
                      emit_waypoints: bool = True):
    """(SessionState[B], offsets int[B]) -> (SessionState[B], (nal u8[B, N],
    nal_len i32[B], emitted_waypoint bool[B], rbsp_bits i32[B],
    overflow bool[B])).  Runs on the device of the state's tensors."""
    return functools.partial(_session_step, cfg, enable_pskip, emit_waypoints)


def make_batched_splice_step_rows(cfg: ComposerConfig, rect_mb_x: int,
                                  rect_mb_y: int, rect_w: int, rect_h: int,
                                  num_refs: int = 2, *,
                                  nal_ref_idc: int = 0,
                                  has_align: bool = False,
                                  n_rbsp: int | None = None,
                                  ebsp_exact: bool = False,
                                  compact_x: bool = False,
                                  s_row: int | None = None,
                                  s_flat: int | None = None,
                                  s_exc: int | None = None,
                                  bg_static_skip: bool = False,
                                  bg_budget: int | None = None):
    """The rows splice step over a batch of sessions:

        step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn)
            -> (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
                overflow bool[B])

    with per-session header symbols hp/hn [B, nh], background fields
    [B, H, W] and the donor wire `dn` with a leading [B] axis (from
    models/splice_device.prepare_donor_rows_serving, or a JAX donor wire
    carried across by donor_arrays_from_numpy).  Every donor-dependent
    value is a tensor, so one step serves every donor that shares the rect
    geometry, the row chunk class and the n_rbsp budget.  Modes as in
    splice_device.rows_splice_symbols (compact_x, bg_static_skip,
    bg_budget; flat and blob wires need s_row / s_flat / s_exc); the step
    runs on the device of its inputs."""
    def step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn):
        return splice_device.emit_spliced_frame_rows(
            cfg, rect_mb_x, rect_mb_y, rect_h, rect_w, num_refs,
            hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn,
            nal_ref_idc=nal_ref_idc, has_align=has_align, n_rbsp=n_rbsp,
            ebsp_exact=ebsp_exact, compact_x=compact_x, s_row=s_row,
            s_flat=s_flat, s_exc=s_exc, bg_static_skip=bg_static_skip,
            bg_budget=bg_budget)
    return step


def make_batched_splice_step_dense(cfg: ComposerConfig, rect_mb_x: int,
                                   rect_mb_y: int, rect_w: int, rect_h: int,
                                   num_refs: int = 2, *,
                                   has_align: bool = False,
                                   n_rbsp: int | None = None,
                                   ebsp_exact: bool = False):
    """The dense splice step over a batch of sessions, with the rows step's
    arguments and returns:

        step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn)
            -> (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
                overflow bool[B])

    where `dn` is the dense donor wire (splice_device.dense_device_arrays,
    or a JAX one through donor_arrays_from_numpy) with a leading [B] axis.
    The default n_rbsp is the donor chunk class's budget
    (splice_device.emit_spliced_frame_dense); the step runs on the device
    of its inputs."""
    def step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn):
        return splice_device.emit_spliced_frame_dense(
            cfg, rect_mb_x, rect_mb_y, rect_h, rect_w, num_refs,
            hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn,
            has_align=has_align, n_rbsp=n_rbsp, ebsp_exact=ebsp_exact)
    return step


def make_batched_hint_step(cfg: ComposerConfig, *, enable_pskip: bool = True,
                           compact_x: bool = False, device="cuda"):
    """The hint-frame step over a batch of sessions on `device` (the card
    unless the caller asks for the CPU):

        step(frame_num, ref, mv_x, mv_y, wp_count, wp_ltidx, wp_valid)
            -> (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
                overflow bool[B])

    with frame_num and wp_count int[B], field grids int[B, H, W] (from
    models/hints.hint_fields or any per-session composition logic) and the
    waypoint registries [B, MAX_WAYPOINTS], which set each session's
    reference list (2 + wp_count entries).  Static chrome collapses to
    P_Skip runs.  compact_x packs each MB into two symbol slots instead of
    three, valid whenever every mv_x is zero (the vertical-scroll serving
    shape) and byte-identical to the generic layout there.  Inputs may be
    numpy arrays or tensors; they are placed on `device`."""
    device = _kernels.resolve_device(device)

    def step(frame_num, ref, mv_x, mv_y, wp_count, wp_ltidx, wp_valid):
        t = functools.partial(torch.as_tensor, device=device)
        return hints.hint_frame(cfg, t(frame_num), t(ref), t(mv_x), t(mv_y),
                                t(wp_count), t(wp_ltidx), t(wp_valid),
                                enable_pskip=enable_pskip,
                                compact_x=compact_x)
    return step


def _checksum(nal):
    """Sum of a step's NAL bytes per session, mod 2**32."""
    return nal.to(torch.int64).sum(dim=-1) & 0xFFFFFFFF


def run_frames(cfg: ComposerConfig, state: SessionState, offsets,
               *, enable_pskip: bool = False, emit_waypoints: bool = True,
               composer_semantics: bool = False):
    """Run a [T, B] offset schedule; returns the final state and stacked
    per-frame (nal_len, emitted_waypoint, rbsp_bits, checksum, overflow),
    each [T, B] (checksum: the NAL bytes' sum mod 2**32).

    With composer_semantics=True each session follows the composer CLI's
    two-NAL behaviour: a step that emits a waypoint does not consume the
    session's schedule entry — the session keeps its own schedule pointer
    and re-presents the same offset next step for the scroll frame
    (trailing steps past the schedule replay its last entry).
    """
    step = make_batched_step(cfg, enable_pskip=enable_pskip,
                             emit_waypoints=emit_waypoints)
    dev = state.frame_num.device
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int64)
    T, B = offsets.shape
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    cols = torch.arange(B, device=dev)
    outs = []
    for t in range(T):
        offs = (offsets[ptr.clamp(0, T - 1), cols] if composer_semantics
                else offsets[t])
        state, (nal, nal_len, emitted_wp, rbsp_bits, overflow) = step(
            state, offs)
        ptr = ptr + (~emitted_wp).to(torch.int64)
        outs.append((nal_len, emitted_wp, rbsp_bits, _checksum(nal),
                     overflow))
    return state, tuple(torch.stack(x) for x in zip(*outs))


def compact_batch_nal(nal, nal_len, cap: int):
    """Concatenate a batch's valid NAL bytes into one dense buffer, so
    egress is one contiguous copy per step instead of B strided copies of
    mostly-padding rows (the reference delivers its bytes too,
    src/composer.c:274-291).

    nal u8[B, N] with nal_len int[B] valid bytes each -> (packed u8[cap],
    total i32, overflow bool): packed[:total] is session 0's bytes, then
    session 1's, ...; bytes past `total` are zero.  overflow means
    total > cap: packed then holds the first `cap` bytes and the caller
    retries with a larger cap (nothing is truncated silently).

    An exclusive cumsum of the lengths gives each session's offset; each
    output byte finds its session by a binary search over the inclusive
    offsets and gathers its byte, so bytes past a session's length are
    never read."""
    B, N = nal.shape
    lens = nal_len.to(torch.int64)
    incl = torch.cumsum(lens, dim=0)
    total = incl[-1]
    pos = torch.arange(cap, device=nal.device)
    session = torch.searchsorted(incl, pos, right=True).clamp(max=B - 1)
    col = (pos - (incl - lens)[session]).clamp(0, N - 1)
    packed = torch.where(pos < total, nal[session, col], 0).to(torch.uint8)
    return packed, total.to(torch.int32), total > cap
