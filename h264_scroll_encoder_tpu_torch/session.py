"""Composer session — the public API mirroring include/composer.h.

Port of h264_scroll_encoder_tpu/session.py.  A session owns the
write/parse configs (dual-config pattern, src/composer.c:192-203), the
output Annex-B stream, and the per-session dynamic state (frame_num +
waypoint registry).  Every device frame runs through the port's batched
functions at B = 1 on the session's device (the card unless the caller
asks for the CPU); header and atlas setup runs on the host once per
session.

The waypoint decision (h264_needs_waypoint) is mirrored on the host so the
single-session path dispatches the scroll frame except on the steps that
also emit a waypoint reference frame; the batched step in
parallel/batch.py keeps the registry on the device instead.

Each device frame is compiled as the JAX session's `_jitted_scroll` and
`_jitted_waypoint` are: one CUDA graph per frame kind and configuration,
shared by the sessions of that configuration and replayed each frame
(utils/graphs), its `ebsp_exact` retry a graph of its own captured on the
first overflow.  A frame's per-call values (frame_num, offset, waypoint
registry) reach the card in one copy of one packed int32 row, and the
frame comes back to the host in one synchronising copy: the NAL buffer,
its length and its overflow flag together.

Under the composer's tracer (utils/trace) `write_scroll_frame` and
`write_scroll_or_waypoint_frame` are the span `session.frame`, over the
frame graph's `graphs.call` and the fetch to the host, `session.fetch`;
while the tracer records, each frame emitted counts `session.frames`
(`session.waypoint_frames` for a waypoint frame), its NAL bytes
`session.bytes`, and an overflow retry `session.exact_retries`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from . import _kernels
from .config import (ComposerConfig, MAX_WAYPOINTS, MV_LIMIT_PX,
                     NAL_REF_IDC_HIGHEST, NAL_TYPE_PPS, NAL_TYPE_SPS)
from .models import ipcm, rewrite, scroll
from .syntax import parse
from .syntax.nal import AnnexBWriter, write_nal_unit
from .syntax.params import generate_pps, generate_sps
from .utils import graphs
from .utils.trace import TRACER


@dataclasses.dataclass
class WaypointRegistry:
    """Host mirror of the waypoint registry (include/h264_writer.h:30-34)."""
    offsets: list
    long_term_idx: list
    count: int = 0

    @classmethod
    def empty(cls) -> "WaypointRegistry":
        return cls(offsets=[0] * MAX_WAYPOINTS,
                   long_term_idx=[0] * MAX_WAYPOINTS, count=0)

    def needs_waypoint(self, offset_px: int) -> bool:
        if offset_px == 0 or offset_px % MV_LIMIT_PX != 0:
            return False
        return offset_px not in self.offsets[: self.count]

    def register(self, offset_px: int) -> int:
        if self.count >= MAX_WAYPOINTS:
            # The C reference silently drops the 9th+ waypoint
            # (src/h264_writer.c:771-777), after which scroll offsets past
            # MAX_WAYPOINTS*496 px emit motion vectors beyond the +-496 px
            # vertical MV budget — an illegal stream with no diagnostic.
            # Raising here turns that silent corruption into an error.
            raise OverflowError(
                f"waypoint registry full ({MAX_WAYPOINTS} slots = "
                f"{MAX_WAYPOINTS * MV_LIMIT_PX} px of scroll range); "
                "composing past this would exceed the 496 px MV limit")
        long_term_idx = 2 + self.count
        self.offsets[self.count] = offset_px
        self.long_term_idx[self.count] = long_term_idx
        self.count += 1
        return long_term_idx

    def as_arrays(self, device="cuda"):
        """(offsets int32[1, MAX_WAYPOINTS], long_term_idx int32[1, ...],
        valid bool[1, ...], count int32[1]) on `device`: the registry as
        one session of the batched functions."""
        device = _kernels.resolve_device(device)
        valid = np.zeros(MAX_WAYPOINTS, bool)
        valid[: self.count] = True

        def t(x, dtype):
            return torch.as_tensor(np.asarray([x], dtype), device=device)

        return (t(self.offsets, np.int32), t(self.long_term_idx, np.int32),
                t(valid, bool), t(self.count, np.int32))


# A frame's per-call values packed into one int32 row (one copy to the
# device): frame_num, offset, the registry's offsets, long-term indices
# and validity (MAX_WAYPOINTS each), and its count.
FRAME_ROW = 3 + 3 * MAX_WAYPOINTS


def unpack_frame_row(row):
    """(frame_num [1], offset [1], wp_offsets [1, W], wp_ltidx [1, W],
    wp_valid bool [1, W], count [1]) of one session, the arguments of the
    scroll model's frame functions, from a packed row int32[FRAME_ROW]."""
    W = MAX_WAYPOINTS
    return (row[0:1], row[1:2], row[2:2 + W].view(1, W),
            row[2 + W:2 + 2 * W].view(1, W),
            row[2 + 2 * W:2 + 3 * W].view(1, W).to(torch.bool),
            row[2 + 3 * W:3 + 3 * W])


@graphs.step_factory
def graphed_frame(kind: str, cfg: ComposerConfig, enable_pskip: bool,
                  boundary_policy: str = "floor", ebsp_exact: bool = False):
    """models/scroll.<kind> ("scroll_frame" or "waypoint_frame") of one
    session from its packed row, as one graph per configuration (the JAX
    session's _jitted_scroll and _jitted_waypoint): row -> (nal u8[1,
    n_nal], nal_len i32[1], rbsp_bits i32[1], overflow bool[1])."""
    def frame(row):
        return getattr(scroll, kind)(
            cfg, *unpack_frame_row(row), enable_pskip=enable_pskip,
            boundary_policy=boundary_policy, ebsp_exact=ebsp_exact)
    return graphs.graphed(frame, f"session {kind}"
                          + (" (ebsp_exact)" if ebsp_exact else ""))


@graphs.step_factory
def graphed_sliced_frame(cfg: ComposerConfig, enable_pskip: bool,
                         ebsp_exact: bool = False):
    """models/scroll.scroll_frame_sliced of one session from its packed
    row, as one graph per configuration and slice height:
    (row, rows_per_slice) -> its K slices' (nal, nal_len, rbsp_bits,
    overflow), each with K rows."""
    def frame(row, rows_per_slice):
        return scroll.scroll_frame_sliced(
            cfg, *unpack_frame_row(row), rows_per_slice=rows_per_slice,
            enable_pskip=enable_pskip, ebsp_exact=ebsp_exact)
    return graphs.graphed(frame, "session sliced frame"
                          + (" (ebsp_exact)" if ebsp_exact else ""))


def _fetch(frame):
    """One synchronising device-to-host copy of a frame function's outputs
    (nal, nal_len, rbsp_bits, overflow): (NAL rows as numpy u8[K, n_nal],
    lengths int[K], overflow bool[K]) for its K rows."""
    nal, nal_len, _bits, overflow = frame
    K = nal_len.numel()
    with TRACER.span("session.fetch"):
        host = torch.cat([nal.reshape(-1),
                          nal_len.reshape(K).to(torch.int32).view(torch.uint8),
                          overflow.reshape(K).to(torch.uint8)]).cpu().numpy()
    rows = host[: nal.numel()].reshape(K, -1)
    lens = host[nal.numel(): nal.numel() + 4 * K].view(np.int32)
    return rows, lens, host[nal.numel() + 4 * K:].astype(bool)


class ComposerSession:
    """One UI session composing an H.264 stream at the bitstream level, its
    device frames on `device` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: ComposerConfig,
                 parse_cfg: ComposerConfig | None = None,
                 *, enable_pskip: bool = False,
                 boundary_policy: str = "floor", device="cuda"):
        self.cfg = cfg
        self.parse_cfg = parse_cfg or cfg
        self.enable_pskip = enable_pskip
        self.boundary_policy = boundary_policy
        self.device = _kernels.resolve_device(device)
        self.writer = AnnexBWriter()
        self.frame_num = 0
        self.waypoints = WaypointRegistry.empty()
        self.frames_written = 0
        # Frame functions of one packed row (graphed_frame).
        self._scroll_fn = graphed_frame("scroll_frame", cfg, enable_pskip,
                                        boundary_policy)
        self._waypoint_fn = graphed_frame("waypoint_frame", cfg,
                                          enable_pskip, boundary_policy)

    # -- setup paths --------------------------------------------------------

    def write_parameter_sets(self, *, nal_ref_idc: int = NAL_REF_IDC_HIGHEST,
                             level_idc: int = 40) -> None:
        sps = generate_sps(self.cfg.width, self.cfg.height,
                           level_idc=level_idc,
                           log2_max_frame_num=self.cfg.log2_max_frame_num)
        pps = generate_pps(
            pic_init_qp_minus26=self.cfg.pic_init_qp_minus26,
            chroma_qp_index_offset=self.cfg.chroma_qp_index_offset)
        self.writer.write_nal_unit(sps, nal_ref_idc, NAL_TYPE_SPS)
        self.writer.write_nal_unit(pps, nal_ref_idc, NAL_TYPE_PPS)

    def write_test_atlases(self, *, striped: bool = True,
                           color_a=(128, 128, 128), color_b=(128, 128, 128)):
        """Test-mode I_PCM atlas pair (experiment main.c:226-252)."""
        if striped:
            # Frame A: Red/Green/Blue; frame B: Yellow/Cyan/Magenta (BT.601).
            self.writer.append_raw(ipcm.idr_frame_striped(
                self.cfg, (81, 90, 240), (145, 54, 34), (41, 240, 110)))
            self.frame_num = 1
            self.writer.append_raw(ipcm.non_idr_i_frame_striped(
                self.cfg, self.frame_num,
                (210, 16, 146), (170, 166, 16), (106, 202, 222)))
            self.frame_num += 1
        else:
            self.writer.append_raw(ipcm.idr_frame_color(self.cfg, *color_a))
            self.frame_num = 1
            self.writer.append_raw(ipcm.non_idr_i_frame_color(
                self.cfg, self.frame_num, *color_b))
            self.frame_num += 1

    def write_donor_atlases(self, donor_a_rbsp: bytes,
                            donor_b_rbsp: bytes, *,
                            rewrite_mode: str = "auto") -> None:
        """Donor-mode atlas pair: rewrite two donor IDR RBSPs
        (composer_write_header, src/composer.c:232-253).

        rewrite_mode "splice" reproduces the C reference's raw bit-shift
        (corrupts I_PCM-bearing donors — see models/rewrite._payload);
        "auto" realigns I_PCM payloads when needed."""
        self.writer.append_raw(rewrite.rewrite_idr_frame(
            self.cfg, self.parse_cfg, donor_a_rbsp, mode=rewrite_mode))
        self.frame_num = 1
        self.writer.append_raw(rewrite.rewrite_as_non_idr_i_frame(
            self.cfg, self.parse_cfg, donor_b_rbsp, self.frame_num,
            mode=rewrite_mode))
        self.frame_num += 1

    # -- per-frame hot path --------------------------------------------------

    def write_scroll_frame(self, offset_px: int) -> None:
        """composer_write_scroll_frame (src/composer.c:255-264): emit a
        waypoint reference frame first if this offset needs one."""
        with TRACER.span("session.frame"):
            if self.waypoints.needs_waypoint(offset_px):
                self.write_waypoint_frame(offset_px)
            self._emit(self._scroll_fn, offset_px)
            self.frames_written += 1

    def write_scroll_or_waypoint_frame(self, offset_px: int) -> None:
        """Experiment scheduling (scroll-encoder main.c:417-424): a step
        that needs a waypoint emits *only* the waypoint frame."""
        with TRACER.span("session.frame"):
            if self.waypoints.needs_waypoint(offset_px):
                self.write_waypoint_frame(offset_px)
            else:
                self._emit(self._scroll_fn, offset_px)
            self.frames_written += 1

    def write_waypoint_frame(self, offset_px: int) -> None:
        """Emit one waypoint reference P-frame and register it."""
        self._emit(self._waypoint_fn, offset_px, waypoint=True)
        self.waypoints.register(offset_px)

    def _frame_row(self, offset_px: int) -> torch.Tensor:
        """This frame's packed row (FRAME_ROW) on the session's device, made
        by one copy."""
        W, wp = MAX_WAYPOINTS, self.waypoints
        row = np.zeros(FRAME_ROW, np.int32)
        row[0], row[1] = self.frame_num, offset_px
        row[2:2 + W] = wp.offsets
        row[2 + W:2 + 2 * W] = wp.long_term_idx
        row[2 + 2 * W:2 + 2 * W + wp.count] = 1
        row[2 + 3 * W] = wp.count
        return torch.from_numpy(row).to(self.device)

    def _frame_args(self, offset_px: int):
        """(frame_num, offset, registry...) as one session's tensors."""
        return unpack_frame_row(self._frame_row(offset_px))

    def write_scroll_frame_sliced(self, offset_px: int,
                                  rows_per_slice: int) -> None:
        """Scroll frame as multiple MB-row-aligned slices (parallel-decode
        friendly; extension over the reference's one-slice frames), all
        bands in one back-end call.  Waypoint frames, when needed, are
        still emitted single-slice."""
        if self.waypoints.needs_waypoint(offset_px):
            self.write_waypoint_frame(offset_px)
        row = self._frame_row(offset_px)

        def emit(ebsp_exact):
            return _fetch(graphed_sliced_frame(
                self.cfg, self.enable_pskip, ebsp_exact)(row, rows_per_slice))

        nals, lens, ovf = emit(False)
        if ovf.any():
            # Retry with exact unbounded emulation prevention (see _emit).
            nals, lens, ovf = emit(True)
        if ovf.any():
            raise OverflowError("sliced frame exceeds the RBSP budget")
        for k in range(nals.shape[0]):
            self.writer.append_raw(nals[k][: int(lens[k])].tobytes())
        self.frame_num += 1
        self.frames_written += 1

    def preprovision_waypoints(self) -> None:
        """Emit the full waypoint chain up front (offsets 496, 992, ...).

        Fixes the reference's low-offset MV-limit violation
        (docs/KNOWN_ISSUES_ANALYSIS.md): with the chain in place, the
        existing B-region waypoint selection (src/h264_writer.c:573-588)
        keeps every frame's vectors within the 496 px budget.  Costs one
        small reference P-frame per 496 px of height, once per session;
        scroll output is NOT byte-compatible with the C reference (which
        lacks the early waypoints)."""
        for offset in range(MV_LIMIT_PX, self.cfg.height, MV_LIMIT_PX):
            if self.waypoints.needs_waypoint(offset):
                self.write_waypoint_frame(offset)

    def write_hint_frame(self, hints) -> None:
        """Hint-composed frame: static chrome (P_Skip) + motion regions
        (MASTER_DESIGN §5/§6.1; BASELINE 'composer 720p' config)."""
        from .models.hints import emit_hint_frame

        count = self.waypoints.count
        for region in hints.motion_regions:
            if not 0 <= region.ref_idx < count + 2:
                # te(v) coding would silently wrap an out-of-range index.
                raise ValueError(
                    f"motion region ref_idx {region.ref_idx} outside the "
                    f"active reference list (size {count + 2})")
        valid = np.arange(MAX_WAYPOINTS) < count
        # Hint frames are a new capability (no C equivalent to byte-match),
        # so they always use the validated P_Skip path — that is the point
        # of static chrome.
        nal, nal_len, overflow = _fetch(emit_hint_frame(
            self.cfg, self.frame_num, hints, enable_pskip=True,
            num_waypoints=count, wp_ltidx=self.waypoints.long_term_idx,
            wp_valid=valid, device=self.device))
        if overflow[0]:
            raise OverflowError("hint frame exceeds the RBSP budget")
        self.writer.append_raw(nal[0][: int(nal_len[0])].tobytes())
        self.frame_num += 1
        self.frames_written += 1

    def write_fallback_frame(self, frame, *, qp: int = 20,
                             x264_params: str = "",
                             long_term_idx: int = 0) -> None:
        """MASTER_DESIGN §10 fallback: full conventional encode of one
        frame, on the host (no kernel runs).

        `frame` is the frame's pixels (a pixel_oracle.Picture or (y, cb,
        cr) uint8 planes at session dimensions).  x264 (avref) encodes it,
        and the resulting IDR is re-ingested through the non-IDR-I rewrite
        as a *reference* frame that MMCO-marks itself long-term
        `long_term_idx`: it displays the conventional encode and becomes a
        fresh atlas the session keeps composing against.  The MMCO 4
        marking (max_long_term_frame_idx_plus1=2) truncates waypoint
        long-term indices, so the waypoint chain is reset.

        The encode's PPS QP base is compensated through the slice QP delta
        (the session PPS is already on the wire); a chroma QP offset
        mismatch cannot be compensated in the header and raises."""
        from . import avref
        from .pixel_oracle import Picture

        if isinstance(frame, Picture):
            frame = (frame.y, frame.cb, frame.cr)
        y = np.asarray(frame[0])
        if y.shape != (self.cfg.height, self.cfg.width):
            raise ValueError(
                f"fallback frame is {y.shape[1]}x{y.shape[0]}, session is "
                f"{self.cfg.width}x{self.cfg.height}")
        if "chroma-qp-offset" not in x264_params:
            # x264's psy optimization shifts the chroma QP offset by -2
            # after parsing its parameters; the session PPS is already on
            # the wire, so disable psy and pin the offset to match it.
            pin = (f"psy=0:chroma-qp-offset="
                   f"{self.cfg.chroma_qp_index_offset}")
            x264_params = f"{x264_params}:{pin}" if x264_params else pin
        data = avref.encode_x264([tuple(frame)], qp=qp, keyint=1, refs=1,
                                 extra_params=x264_params)
        info = _parse_reference_file(data)
        sps, pps = info["sps"], info["pps"]
        if pps.chroma_qp_index_offset != self.cfg.chroma_qp_index_offset:
            raise ValueError(
                f"fallback encode chroma_qp_index_offset "
                f"{pps.chroma_qp_index_offset} != session PPS "
                f"{self.cfg.chroma_qp_index_offset}; pass x264_params="
                f"'chroma-qp-offset={self.cfg.chroma_qp_index_offset}'")
        parse_cfg = ComposerConfig(sps.width, sps.height).with_sps_params(
            sps.log2_max_frame_num, sps.pic_order_cnt_type,
            sps.log2_max_pic_order_cnt_lsb,
        ).with_pps_params(pps.num_ref_idx_l0_default_active_minus1,
                          pps.deblocking_filter_control_present_flag)
        self.writer.append_raw(rewrite.rewrite_as_non_idr_i_frame(
            self.cfg, parse_cfg, info["idr_rbsp"],
            self.frame_num % (1 << self.cfg.log2_max_frame_num),
            long_term_idx=long_term_idx,
            qp_delta_adjust=(pps.pic_init_qp_minus26
                             - self.cfg.pic_init_qp_minus26)))
        self.frame_num += 1
        self.frames_written += 1
        self.waypoints = WaypointRegistry.empty()

    def write_hint_frame_or_fallback(self, hints, fallback_frame=None,
                                     **fallback_kw) -> bool:
        """Hint-composed frame with the MASTER_DESIGN §10 recovery rule:
        validate the hints first; on HintsNotServable, conventional-
        encode `fallback_frame` (write_fallback_frame) and continue the
        session against the fresh atlas.  Returns True when the fallback
        path was taken; re-raises when no fallback pixels were given."""
        from .models.splice import HintsNotServable

        try:
            hints.validate(self.cfg, 2 + self.waypoints.count)
        except HintsNotServable:
            if fallback_frame is None:
                raise
            self.write_fallback_frame(fallback_frame, **fallback_kw)
            return True
        self.write_hint_frame(hints)
        return False

    def write_spliced_frame(self, hints, donor_grid, *,
                            donor_slice_qp: int | None = None,
                            as_reference: bool = False,
                            donor_refs_previous: bool = False,
                            retarget_donor_mvs: bool | None = None) -> None:
        """Dynamic-rect composite frame: hint-composed background with the
        donor rect's pre-encoded CAVLC macroblocks spliced in under
        nC-context repair (MASTER_DESIGN §7; host path — exact hint-mvd
        resolution next to the rect).  Donor ref indices are remapped into
        this session's active list (atlases + registered waypoints).

        donor_slice_qp: the donor slice's SliceQPy (26 + donor PPS
        pic_init_qp_minus26 + donor slice_qp_delta).  When given, the
        composed slice header aligns its own QP to it so the donor's
        bit-copied residuals decode at their encoded scale.

        as_reference stores the composed frame in the decoder's DPB
        (sliding window, nal_ref_idc 2).  donor_refs_previous puts the
        most recent such frame at the FRONT of the active reference list
        so donor ref 0 targets it — the successive-donor mode; hint
        regions' atlas/waypoint indices are shifted transparently."""
        from .models.splice import (donor_mv_targets_from_grid,
                                    finalize_spliced_frame, splice_p_frame)
        from .syntax.slice_headers import write_p_slice_header

        if retarget_donor_mvs is None:
            retarget_donor_mvs = donor_refs_previous
        targets = (donor_mv_targets_from_grid(donor_grid)
                   if retarget_donor_mvs else None)

        n_wp = self.waypoints.count
        n_st = 1 if donor_refs_previous else 0
        if donor_refs_previous:
            if getattr(self, "_last_ref_frame_num", None) is None:
                raise ValueError(
                    "donor_refs_previous needs a prior as_reference frame")
            max_fn = 1 << self.cfg.log2_max_frame_num
            abs_diff = (self.frame_num - self._last_ref_frame_num) % max_fn
            abs_diff = abs_diff or max_fn
            # Hint regions address [atlases | waypoints]; with the
            # short-term entry in front, shift them by one.
            hints = dataclasses.replace(hints, motion_regions=tuple(
                dataclasses.replace(m, ref_idx=m.ref_idx + 1)
                for m in hints.motion_regions))
        num_refs = n_wp + 2 + n_st
        grid = splice_p_frame(self.cfg, hints, donor_grid, num_refs,
                              donor_mv_targets=targets)
        qp_delta = 0
        if donor_slice_qp is not None:
            qp_delta = donor_slice_qp - (26 + self.cfg.pic_init_qp_minus26)

        def hdr(bw):
            write_p_slice_header(
                bw, self.cfg, self.frame_num, num_waypoints=n_wp,
                wp_long_term_idx=self.waypoints.long_term_idx[:n_wp],
                slice_qp_delta=qp_delta,
                is_reference=as_reference,
                prev_ref_abs_diff=abs_diff if donor_refs_previous else None)

        rbsp = finalize_spliced_frame(self.cfg, grid, num_refs, hdr)
        self.writer.append_raw(write_nal_unit(rbsp, 2 if as_reference else 0,
                                              1))
        if as_reference:
            self._last_ref_frame_num = self.frame_num
        self.frame_num += 1
        self.frames_written += 1

    def _emit(self, fn, offset_px: int, *, waypoint: bool = False) -> None:
        row = self._frame_row(offset_px)
        nal, nal_len, overflow = _fetch(fn(row))
        retried = bool(overflow[0])
        if retried:
            # The fast path statically bounds emulation-prevention work
            # (MAX_EBSP_INSERTIONS / the zero-run window) and uses a tight
            # RBSP budget; legal payloads past those bounds re-emit
            # through the exact unbounded path (K2's pack) at
            # cfg.rbsp_bits_per_mb before concluding the RBSP bit budget
            # itself was exceeded.
            exact = graphed_frame(
                "waypoint_frame" if waypoint else "scroll_frame", self.cfg,
                self.enable_pskip, self.boundary_policy, ebsp_exact=True)
            nal, nal_len, overflow = _fetch(exact(row))
        if overflow[0]:
            raise OverflowError(
                f"frame at offset {offset_px} exceeds the RBSP budget of "
                f"{self.cfg.rbsp_bits_per_mb} bits/MB — raise "
                f"ComposerConfig.rbsp_bits_per_mb")
        self.writer.append_raw(nal[0][: int(nal_len[0])].tobytes())
        self.frame_num += 1
        if TRACER.on:
            TRACER.count("session.frames")
            TRACER.count("session.waypoint_frames", int(waypoint))
            TRACER.count("session.exact_retries", int(retried))
            TRACER.count("session.bytes", int(nal_len[0]))

    # -- output --------------------------------------------------------------

    def getvalue(self) -> bytes:
        return self.writer.getvalue()

    def write_to_file(self, path) -> int:
        data = self.getvalue()
        Path(path).write_bytes(data)
        return len(data)


def open_donor_session(ref_a_path, ref_b_path, *,
                       enable_pskip: bool = False,
                       device="cuda") -> ComposerSession:
    """composer_init equivalent (src/composer.c:127-222): load two donor
    .h264 files, extract SPS/PPS/IDR, build dual configs, write nothing yet."""
    a = _parse_reference_file(Path(ref_a_path).read_bytes())
    b = _parse_reference_file(Path(ref_b_path).read_bytes())
    if (a["sps"].width, a["sps"].height) != (b["sps"].width, b["sps"].height):
        raise ValueError(
            f"Reference frame dimensions don't match: "
            f"{a['sps'].width}x{a['sps'].height} vs "
            f"{b['sps'].width}x{b['sps'].height}")

    sps, pps = a["sps"], a["pps"]
    parse_cfg = ComposerConfig(sps.width, sps.height).with_sps_params(
        sps.log2_max_frame_num, sps.pic_order_cnt_type,
        sps.log2_max_pic_order_cnt_lsb,
    ).with_pps_params(pps.num_ref_idx_l0_default_active_minus1,
                      pps.deblocking_filter_control_present_flag)
    # Write config: our own log2_max_frame_num=4 / poc_type=2, donor's
    # deblocking flag preserved (src/composer.c:199-203) — plus the
    # donor's PPS QP base, which the bit-copied residuals decode against
    # (fixes reference defect #6, see ComposerConfig).
    write_cfg = ComposerConfig(sps.width, sps.height).with_sps_params(
        4, 2, 4).with_pps_params(1, pps.deblocking_filter_control_present_flag,
                                 pps.pic_init_qp_minus26,
                                 pps.chroma_qp_index_offset)

    session = ComposerSession(write_cfg, parse_cfg, enable_pskip=enable_pskip,
                              device=device)
    session._donor_a_rbsp = a["idr_rbsp"]
    session._donor_b_rbsp = b["idr_rbsp"]
    return session


def open_two_idr_session(input_path, *,
                         enable_pskip: bool = False,
                         device="cuda") -> ComposerSession:
    """Experiment-style donor ingest (scroll-encoder main.c:256-382): one
    donor stream containing SPS + PPS + two IDR frames."""
    data = Path(input_path).read_bytes()
    sps = pps = None
    idr_rbsps = []
    for unit in parse.iter_nal_units(data):
        if unit.nal_unit_type == 7 and sps is None:
            sps = parse.parse_sps(unit.rbsp)
        elif unit.nal_unit_type == 8 and pps is None:
            pps = parse.parse_pps(unit.rbsp)
        elif unit.nal_unit_type == 5 and len(idr_rbsps) < 2:
            idr_rbsps.append(unit.rbsp)
    if sps is None or pps is None:
        raise ValueError("Input must contain SPS and PPS")
    if len(idr_rbsps) < 2:
        raise ValueError(
            f"Input must contain 2 IDR frames (found {len(idr_rbsps)})")
    if pps.entropy_coding_mode_flag:
        raise ValueError(
            "Donor stream is CABAC-encoded; the composer requires "
            "Baseline/CAVLC donors (re-encode with entropy=CAVLC)")

    parse_cfg = ComposerConfig(sps.width, sps.height).with_sps_params(
        sps.log2_max_frame_num, sps.pic_order_cnt_type,
        sps.log2_max_pic_order_cnt_lsb,
    ).with_pps_params(pps.num_ref_idx_l0_default_active_minus1,
                      pps.deblocking_filter_control_present_flag)
    # Experiment write config: our SPS (log2_mfn=4, poc 2) and our PPS with
    # deblocking control always present (main.c:358-360); donor PPS QP
    # base adopted (reference defect #6, see ComposerConfig).
    write_cfg = ComposerConfig(sps.width, sps.height).with_sps_params(
        4, 2, 4).with_pps_params(1, 1, pps.pic_init_qp_minus26,
                                 pps.chroma_qp_index_offset)

    session = ComposerSession(write_cfg, parse_cfg, enable_pskip=enable_pskip,
                              device=device)
    session._donor_a_rbsp = idr_rbsps[0]
    session._donor_b_rbsp = idr_rbsps[1]
    return session


def _parse_reference_file(data: bytes) -> dict:
    """parse_reference_file (src/composer.c:45-125): first SPS, PPS, IDR."""
    out = {"sps": None, "pps": None, "idr_rbsp": None}
    for unit in parse.iter_nal_units(data):
        if unit.nal_unit_type == 7 and out["sps"] is None:
            out["sps"] = parse.parse_sps(unit.rbsp)
        elif unit.nal_unit_type == 8 and out["pps"] is None:
            out["pps"] = parse.parse_pps(unit.rbsp)
        elif unit.nal_unit_type == 5 and out["idr_rbsp"] is None:
            out["idr_rbsp"] = unit.rbsp
    missing = [k for k, v in out.items() if v is None]
    if missing:
        raise ValueError(f"Reference file missing {missing}")
    if out["pps"].entropy_coding_mode_flag:
        # Donor MB data is spliced bit-verbatim into a CAVLC stream; a
        # CABAC donor would be silently corrupting (the C reference only
        # guards this in its shell scripts, netflix_scroll.sh:74-78).
        raise ValueError(
            "Donor stream is CABAC-encoded; the composer requires "
            "Baseline/CAVLC donors (re-encode with entropy=CAVLC)")
    return out
