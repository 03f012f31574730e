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

Across devices (the JAX package's "sessions" mesh axis) sessions split
into equal contiguous blocks, one per device (`shard_batch`; `gather_batch`
reads them back); the hot path needs no collectives.  `run_on_blocks`
calls a step on every block with the block's card current:
`make_sharded_step` is the scroll step run so, and the rows, dense and
hint steps run sharded the same way, since they run on the device of
their inputs.  `compact_sharded_nal` is egress across the blocks: the
blocks' rows gathered onto one device (the one cross-device copy), then
`compact_batch_nal`.

Every step is compiled as the JAX package's `jax.jit(jax.vmap(...))` is:
each factory (cached, as the JAX factories are) returns a
utils/graphs.Graphed, which on the card captures the step once per
batch shape and device as a CUDA graph and replays it on every later
call; `.eager` runs the same step op by op.  On CPU tensors the step
runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import _kernels
from ..config import ComposerConfig, MAX_WAYPOINTS
from ..models import hints, scroll, splice_device
from ..models.splice_device import donor_arrays_from_numpy  # noqa: F401
from ..utils import graphs
from ..utils.trace import TRACER

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


# A SessionState is a node of torch's pytrees, so a graphed step keys and
# copies its fields as it does any tensor argument.
pytree.register_pytree_node(
    SessionState, lambda s: ([getattr(s, f) for f in _FIELDS], None),
    lambda fields, _: SessionState(*fields))


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
    offset_px = offset_px.to(torch.int32)
    wp_offsets = state.wp_offsets.to(torch.int32)
    wp_count = state.wp_count.to(torch.int32)
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
    idx = torch.arange(MAX_WAYPOINTS, dtype=torch.int32, device=slot.device)
    hit = (idx[None, :] == slot[:, None]) & can_reg[:, None]
    state = SessionState(
        frame_num=state.frame_num + 1,
        wp_offsets=torch.where(hit, offset_px[:, None], wp_offsets),
        wp_ltidx=torch.where(hit, 2 + wp_count[:, None],
                             state.wp_ltidx.to(torch.int32)),
        wp_valid=state.wp_valid | hit,
        wp_count=wp_count + can_reg.to(torch.int32),
    )
    return state, (nal, nal_len, needs, rbsp_bits, overflow | exhausted)


@graphs.step_factory
def make_batched_step(cfg: ComposerConfig, *, enable_pskip: bool = False,
                      emit_waypoints: bool = True):
    """(SessionState[B], offsets int[B]) -> (SessionState[B], (nal u8[B, N],
    nal_len i32[B], emitted_waypoint bool[B], rbsp_bits i32[B],
    overflow bool[B])).  Runs on the device of the state's tensors; on the
    card one CUDA graph per batch size and device (utils/graphs)."""
    return graphs.graphed(
        functools.partial(_session_step, cfg, enable_pskip, emit_waypoints),
        "scroll step")


def block_device(device) -> torch.device:
    """A block's device with its index (a bare "cuda" is the current card)."""
    dev = _kernels.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(device):
    """The context a block's work is issued in: its card made current (the
    kernel plans and the streams are per card); nothing on the CPU."""
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def shard_batch(x, devices) -> list:
    """Split a batch over `devices`, as jax.device_put with a
    NamedSharding(mesh, P("sessions")) places it: sessions split into equal
    contiguous blocks along the leading axis, block i on devices[i] (a
    device may repeat).  `x` is a tensor or array, a dict or tuple of them
    (a donor wire, a step's outputs) or a SessionState; returns one such
    block per device.  A batch that does not divide raises ValueError."""
    devices = [block_device(d) for d in devices]
    n = len(devices)
    if isinstance(x, SessionState):
        parts = {f: shard_batch(getattr(x, f), devices) for f in _FIELDS}
        return [SessionState(**{f: parts[f][i] for f in _FIELDS})
                for i in range(n)]
    if isinstance(x, dict):
        parts = {k: shard_batch(v, devices) for k, v in x.items()}
        return [{k: parts[k][i] for k in x} for i in range(n)]
    if isinstance(x, tuple):
        parts = [shard_batch(v, devices) for v in x]
        return [tuple(p[i] for p in parts) for i in range(n)]
    x = torch.as_tensor(x)
    B = x.shape[0]
    if n == 0 or B % n:
        raise ValueError(f"a batch of {B} sessions does not split into "
                         f"equal blocks over {n} devices")
    size = B // n
    return [x[i * size:(i + 1) * size].to(d) for i, d in enumerate(devices)]


def gather_batch(blocks, device=None):
    """Inverse of shard_batch: the blocks' sessions concatenated in order on
    `device` (default: the first block's device)."""
    first = blocks[0]
    if isinstance(first, SessionState):
        return SessionState(**{f: gather_batch([getattr(b, f) for b in blocks],
                                               device) for f in _FIELDS})
    if isinstance(first, dict):
        return {k: gather_batch([b[k] for b in blocks], device) for k in first}
    if isinstance(first, tuple):
        return tuple(gather_batch(list(p), device) for p in zip(*blocks))
    dev = first.device if device is None else block_device(device)
    return torch.cat([b.to(dev) for b in blocks])


def run_on_blocks(step, devices, *blocks) -> list:
    """step(*args) on every block, the i-th call with devices[i] current
    and args its i-th entry of each of `blocks` (per-device lists, as
    shard_batch returns them); returns the per-block outputs.  Nothing
    waits on a card between blocks, so the cards run their blocks side by
    side; a repeated device runs its blocks one after another."""
    outs = []
    for dev, args in zip(devices, zip(*blocks)):
        with on_device(dev):
            outs.append(step(*args))
    return outs


def make_sharded_step(cfg: ComposerConfig, devices, *,
                      enable_pskip: bool = False, emit_waypoints: bool = True):
    """The batched step with the session axis split over `devices`, the
    counterpart of the JAX package's make_sharded_step over a 1-D
    "sessions" mesh:

        step(states, offsets) -> (states, outs)

    with one SessionState block and one offsets block per device
    (shard_batch), in the order of `devices`; returns the new state blocks
    and one (nal, nal_len, emitted_waypoint, rbsp_bits, overflow) per
    block, every output on its block's device.  Sessions are independent,
    so there are no collectives; the blocks run through run_on_blocks, and
    a device may repeat.  On the cards the step is make_batched_step's
    graph: one per device, each captured with its card current; the
    returned function's `.eager` runs the blocks op by op."""
    devices = tuple(block_device(d) for d in devices)
    step = make_batched_step(cfg, enable_pskip=enable_pskip,
                             emit_waypoints=emit_waypoints)

    def over_blocks(step):
        def sharded(states, offsets):
            if len(states) != len(devices) or len(offsets) != len(devices):
                raise ValueError(f"{len(states)} state and {len(offsets)} "
                                 f"offset blocks for {len(devices)} devices")
            for dev, state in zip(devices, states):
                if state.frame_num.device != dev:
                    raise ValueError(f"a state block on "
                                     f"{state.frame_num.device} is not on "
                                     f"its device {dev}")
            results = run_on_blocks(step, devices, states, offsets)
            return [r[0] for r in results], [r[1] for r in results]
        return sharded

    sharded = over_blocks(step)
    sharded.eager = over_blocks(step.eager)
    return sharded


@graphs.step_factory
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
    runs on the device of its inputs.  On the card it is one CUDA graph
    per batch size and donor wire shape (utils/graphs): a fresh donor of
    the same classes replays it, as the JAX package's one compiled
    program serves every such donor."""
    def step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn):
        return splice_device.emit_spliced_frame_rows(
            cfg, rect_mb_x, rect_mb_y, rect_h, rect_w, num_refs,
            hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn,
            nal_ref_idc=nal_ref_idc, has_align=has_align, n_rbsp=n_rbsp,
            ebsp_exact=ebsp_exact, compact_x=compact_x, s_row=s_row,
            s_flat=s_flat, s_exc=s_exc, bg_static_skip=bg_static_skip,
            bg_budget=bg_budget)
    program = ("static-chrome" if bg_static_skip
               else "compact" if compact_x else "generic")
    return graphs.graphed(step, f"rows splice step ({program}"
                          f"{', ebsp_exact' if ebsp_exact else ''})")


@graphs.step_factory
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
    of its inputs, on the card as one CUDA graph per batch size and donor
    wire shape (utils/graphs)."""
    def step(hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn):
        return splice_device.emit_spliced_frame_dense(
            cfg, rect_mb_x, rect_mb_y, rect_h, rect_w, num_refs,
            hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn,
            has_align=has_align, n_rbsp=n_rbsp, ebsp_exact=ebsp_exact)
    return graphs.graphed(step, "dense splice step"
                          + (" (ebsp_exact)" if ebsp_exact else ""))


@graphs.step_factory
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
    numpy arrays or tensors; they are placed on `device`, where the card
    runs the step as one CUDA graph per batch size (utils/graphs)."""
    device = _kernels.resolve_device(device)

    def step(frame_num, ref, mv_x, mv_y, wp_count, wp_ltidx, wp_valid):
        t = functools.partial(torch.as_tensor, device=device)
        return hints.hint_frame(cfg, t(frame_num), t(ref), t(mv_x), t(mv_y),
                                t(wp_count), t(wp_ltidx), t(wp_valid),
                                enable_pskip=enable_pskip,
                                compact_x=compact_x)
    return graphs.graphed(step, "hint step", device)


def _checksum(nal):
    """Sum of a step's NAL bytes per session, mod 2**32 (the uint32 sum,
    as int32 bits)."""
    return nal.sum(dim=-1, dtype=torch.int32)


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
    (trailing steps past the schedule replay its last entry).  The step
    is make_batched_step's graph, replayed T times (the JAX package's
    lax.scan).
    """
    step = make_batched_step(cfg, enable_pskip=enable_pskip,
                             emit_waypoints=emit_waypoints)
    dev = state.frame_num.device
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int32)
    T, B = offsets.shape
    ptr = torch.zeros(B, dtype=torch.int32, device=dev)
    cols = torch.arange(B, dtype=torch.int32, device=dev)
    outs = []
    for t in range(T):
        offs = (offsets[ptr.clamp(0, T - 1), cols] if composer_semantics
                else offsets[t])
        state, (nal, nal_len, emitted_wp, rbsp_bits, overflow) = step(
            state, offs)
        ptr = ptr + (~emitted_wp).to(torch.int32)
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
    never read.

    Under the composer's tracer it is the device-timed span
    `batch.compact`; while the tracer records, `batch.compact_positions`
    counts the caps (total stays on the device)."""
    with TRACER.span("batch.compact") as span:
        span.time_device(nal.device)
        B, N = nal.shape
        lens = nal_len.to(torch.int32)
        incl = torch.cumsum(lens, dim=0, dtype=torch.int32)
        total = incl[-1]
        pos = torch.arange(cap, dtype=torch.int32, device=nal.device)
        session = torch.searchsorted(incl, pos, right=True,
                                     out_int32=True).clamp(max=B - 1)
        col = (pos - (incl - lens)[session]).clamp(0, N - 1)
        packed = torch.where(pos < total, nal[session, col],
                             0).to(torch.uint8)
    if TRACER.on:
        TRACER.count("batch.compact_positions", cap)
    return packed, total, total > cap


def compact_sharded_nal(nal_blocks, len_blocks, cap: int, device=None):
    """compact_batch_nal over a batch split into blocks (shard_batch): the
    blocks' NAL rows and lengths gathered onto `device` (default: the
    first block's device), then compacted there; the returns equal
    compact_batch_nal's on the whole batch, overflow included."""
    return compact_batch_nal(gather_batch(nal_blocks, device),
                             gather_batch(len_blocks, device), cap)
