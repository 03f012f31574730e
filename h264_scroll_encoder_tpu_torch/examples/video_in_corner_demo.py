"""The MASTER_DESIGN flagship composition: scrolling UI with a video
playing in a corner, composed entirely at the bitstream level.

Port of examples/video_in_corner_demo.py.  Per frame, ONE spliced P-frame
carries both surfaces:
  - background hint regions scroll the atlas content (motion-vector-only
    macroblocks, no pixel encoding),
  - the dynamic rect plays a real x264 clip: the first frame is seeded as
    I_PCM from the decoded donor IDR, then each donor P slice is spliced
    with its reference retargeted to the previous composed frame and every
    mvd re-resolved against the composite prediction context.

The result is checked three ways: structural conformance, libavcodec
(0 decoder errors), and pixel equality of the video interior against the
clip's own decode within the re-seed margin.

    python -m h264_scroll_encoder_tpu_torch.examples.video_in_corner_demo \
        [OUT.h264] [--device cuda|cpu]
    python -m h264_scroll_encoder_tpu_torch.examples.video_in_corner_demo \
        --batched [OUT.h264] [--batch B] [--device cuda|cpu]

--batched runs the same composition at 1280x720 as a batched device
pipeline: B sessions step through the rows splice step with native
in-place MV retargeting (successive donors reference the previous composed
frame via the short-term-lead header), byte-identical to the host path.

Both need libavcodec and libx264 (avref); where they are missing the
demo prints what is missing and exits 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

RESEED_EVERY = 4


def _clip():
    """The 'video': an 8-frame x264 clip with drifting content ->
    (clip frames, decoded pictures, sps, pps, P-slice NAL units)."""
    from .. import avref
    from ..syntax import parse

    vh, vw = 80, 96
    yy, xx = np.mgrid[:vh + 64, :vw]
    canvas = (40 + 80 * np.sin(yy / 9.0) + 60 * np.cos(xx / 7.0)
              + yy * 0.7).clip(16, 235).astype(np.uint8)
    cc = (np.full((vh // 2, vw // 2), 90, np.uint8),
          np.full((vh // 2, vw // 2), 150, np.uint8))
    clip_frames = [(canvas[k * 4:k * 4 + vh],) + cc for k in range(8)]
    clip = avref.encode_x264(clip_frames, qp=24, keyint=99, refs=1,
                             extra_params="no-deblock=1")
    clip_pics, _ = avref.decode_pictures(clip)
    sps = pps = None
    p_units = []
    for u in parse.iter_nal_units(clip):
        if u.nal_unit_type == 7:
            sps = parse.parse_sps(u.rbsp)
        elif u.nal_unit_type == 8:
            pps = parse.parse_pps(u.rbsp)
        elif u.nal_unit_type == 1:
            p_units.append(u)
    return clip_frames, clip_pics, sps, pps, p_units


def _slice_header(u, sps, pps):
    from ..models.splice import parse_slice_header
    from ..ops.bitio import BitReader

    br = BitReader(u.rbsp)
    hdr = parse_slice_header(
        br, is_idr=False, nal_ref_idc=u.nal_ref_idc,
        log2_max_frame_num=sps.log2_max_frame_num,
        pps_num_ref_idx_l0_default=(
            pps.num_ref_idx_l0_default_active_minus1 + 1))
    return br, hdr


def _check_interior(data, clip_frames, clip_pics, rx, ry, dW, dH) -> list:
    """0 libavcodec errors, and each composed frame's video rect equals the
    clip's decode beyond a margin that grows 4 px per frame since the last
    re-seed (donor-edge MC clamping); returns the margins."""
    from .. import avref

    pics, nerrors = avref.decode_pictures(data)
    if nerrors:
        raise AssertionError(f"{nerrors} decoder errors")
    vh, vw = clip_frames[0][0].shape
    bands = []
    for k in range(len(clip_frames)):
        comp = pics[2 + k]
        rect = comp.y[ry * 16:(ry + dH) * 16, rx * 16:(rx + dW) * 16]
        d = np.abs(rect.astype(int) - clip_pics[k].y.astype(int))
        m = 0
        while m < 40 and d[m:vh - m or None, m:vw - m or None].max() != 0:
            m += 1
        if m > 8 + 4 * (k % RESEED_EVERY):
            raise AssertionError(f"frame {k}: interior exact only beyond "
                                 f"{m} px")
        bands.append(m)
    return bands


def main(out_path="video_in_corner.h264", device="cuda", log=print) -> bytes:
    """The host-path composition at 320x240; returns the stream."""
    from ..config import ComposerConfig
    from ..models import mb_transcode as mbt
    from ..models.splice import (FrameHints, MotionRegion,
                                 ipcm_grid_from_picture)
    from ..session import ComposerSession
    from ..utils import mp4mux
    from ..verify import verify_stream

    clip_frames, clip_pics, sps, pps, p_units = _clip()
    dW, dH = sps.width // 16, sps.height // 16

    # --- the UI session ----------------------------------------------
    cfg = ComposerConfig(320, 240)
    s = ComposerSession(cfg, device=device)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    rx, ry = 12, 9                       # video rect (MB coords)

    def ui_hints(scroll_px: int) -> FrameHints:
        """Scroll the upper UI band; keep chrome below static (P_Skip)."""
        return FrameHints(motion_regions=(
            MotionRegion(0, 0, cfg.mb_width, 8, ref_idx=0,
                         mv_x=0, mv_y=scroll_px),),
            dynamic_mb_x=rx, dynamic_mb_y=ry)

    # Frame 1: seed the video rect (I_PCM of the decoded clip IDR).  A
    # periodic I_PCM re-seed — the dynamic encoder's keyframe cadence —
    # resets the margin band that donor-edge MC clamping drifts.
    s.write_spliced_frame(ui_hints(0),
                          ipcm_grid_from_picture(clip_pics[0], 0, 0, dW, dH),
                          as_reference=True)
    # Frames 2..: scroll the UI while the clip plays in the rect.
    for k, u in enumerate(p_units):
        scroll = 4 * (k + 1)
        if (k + 1) % RESEED_EVERY == 0:
            s.write_spliced_frame(
                ui_hints(scroll),
                ipcm_grid_from_picture(clip_pics[k + 1], 0, 0, dW, dH),
                as_reference=True)
            continue
        br, hdr = _slice_header(u, sps, pps)
        grid = mbt.parse_p_slice_mbs(br, dW, dH, hdr.num_ref_idx_l0)
        s.write_spliced_frame(
            ui_hints(scroll), grid, as_reference=True,
            donor_refs_previous=True,
            donor_slice_qp=26 + pps.pic_init_qp_minus26 + hdr.qp_delta)

    data = s.getvalue()
    out_path = Path(out_path)
    out_path.write_bytes(data)
    rep = verify_stream(data)
    if not rep.ok:
        raise AssertionError(f"{out_path}: {rep.errors}")
    bands = _check_interior(data, clip_frames, clip_pics, rx, ry, dW, dH)
    log(f"{out_path}: {len(data)} bytes — scrolling UI + {len(clip_frames)}"
        f"-frame x264 clip, 0 decoder errors; per-frame exact-beyond-margin "
        f"px: {bands} (re-seed every {RESEED_EVERY} resets the band)")

    mp4_path = out_path.with_suffix(".mp4")
    mp4_path.write_bytes(mp4mux.mux(data, fps=30))
    log(f"muxed -> {mp4_path} ({mp4_path.stat().st_size} bytes)")
    return data


def main_batched(out_path="video_in_corner_720p.h264", batch: int = 4, *,
                 width: int = 1280, height: int = 720, rx: int = 40,
                 ry: int = 25, device="cuda", log=print) -> list:
    """Batched device path of the same composition (default 1280x720);
    every session's stream must equal the host path's.  Returns the
    sessions' streams."""
    import torch

    from ..config import ComposerConfig, MAX_WAYPOINTS
    from ..models import mb_transcode as mbt
    from ..models import splice_device
    from ..models.splice import (FrameHints, MotionRegion,
                                 ipcm_grid_from_picture)
    from ..ops.bitio import BitWriter
    from ..parallel import batch as batch_mod
    from ..session import ComposerSession
    from ..syntax.slice_headers import p_slice_header_symbols

    clip_frames, clip_pics, sps, pps, p_units = _clip()
    dW, dH = sps.width // 16, sps.height // 16

    cfg = ComposerConfig(width, height)
    H, W = cfg.mb_height, cfg.mb_width
    # The clip rect inside static chrome, below the scrolling band.
    BAND_H = 8                            # scrolling band rows 0..7

    def ui_hints(scroll_px, ref_shift):
        return FrameHints(motion_regions=(
            MotionRegion(0, 0, W, BAND_H, ref_idx=0 + ref_shift,
                         mv_x=0, mv_y=scroll_px),),
            dynamic_mb_x=rx, dynamic_mb_y=ry)

    # Host twin: the exact host composition for byte comparison.
    host = ComposerSession(cfg, device=device)
    host.write_parameter_sets()
    host.write_test_atlases(striped=True)

    def bg_fields(scroll_px, ref_shift):
        def field(value, dtype=torch.int32):
            f = torch.zeros((batch, H, W), dtype=dtype, device=device)
            f[:, :BAND_H] = value
            return f
        return (field(ref_shift), field(0), field(scroll_px * 4),
                field(True, torch.bool))

    SEED_CLASS, P_CLASS = 768, 64
    seed_budget = splice_device.splice_rbsp_budget(
        cfg, dW * dH, dH * SEED_CLASS * 32, bg_bits_per_mb=16)
    p_budget = splice_device.splice_rbsp_budget(
        cfg, dW * dH, dH * P_CLASS * 32, bg_bits_per_mb=16)
    seed_step = batch_mod.make_batched_splice_step_rows(
        cfg, rx, ry, dW, dH, num_refs=2, nal_ref_idc=2, has_align=True,
        n_rbsp=seed_budget, compact_x=True)
    p_step = batch_mod.make_batched_splice_step_rows(
        cfg, rx, ry, dW, dH, num_refs=3, nal_ref_idc=2, has_align=True,
        n_rbsp=p_budget, compact_x=True)
    # The per-slice qp_delta is in the header; x264 at a fixed qp keeps it
    # constant across the clip.
    hdr0 = None
    zl = torch.zeros((batch, MAX_WAYPOINTS), dtype=torch.int32, device=device)

    def run_step(step, payload, start_bit, donor_num_refs, num_refs, s_row,
                 scroll_px, ref_shift, frame_num, abs_diff, qp_delta,
                 retarget):
        dn, _meta = splice_device.prepare_donor_rows_serving(
            [payload] * batch, [start_bit] * batch, dH, dW, donor_num_refs,
            num_refs, s_row=s_row, retarget_mvs=retarget, device=device)
        fn = torch.full((batch,), frame_num % 16, dtype=torch.int32,
                        device=device)
        hp, hn = p_slice_header_symbols(
            cfg, fn, fn * 2, True, -1, 0, zl, zl.bool(),
            slice_qp_delta=qp_delta, prev_ref_abs_diff=abs_diff)
        nal, nal_len, _, ovf = step(hp, hn, *bg_fields(scroll_px, ref_shift),
                                    dn)
        nal, nal_len, ovf = (x.cpu().numpy() for x in (nal, nal_len, ovf))
        if ovf.any():
            raise AssertionError("a spliced frame overflowed")
        return nal, nal_len

    streams = [bytearray(host.getvalue()) for _ in range(batch)]
    frame_num = 2
    timed = 0.0
    n_p_frames = 0

    def seed_payload(pic):
        grid = ipcm_grid_from_picture(pic, 0, 0, dW, dH)
        bw = BitWriter()
        mbt.emit_p_slice_mbs(bw, grid, 1)
        bw.write_trailing_bits()
        return grid, bw.getvalue()

    # Frame 1: I_PCM seed.
    grid, payload = seed_payload(clip_pics[0])
    nal, nal_len = run_step(seed_step, payload, 0, 1, 2, SEED_CLASS, 0, 0,
                            frame_num, 0, 0, False)
    host.write_spliced_frame(ui_hints(0, 0), grid, as_reference=True)
    for b in range(batch):
        streams[b] += nal[b][: nal_len[b]].tobytes()
    frame_num += 1

    for k, u in enumerate(p_units):
        scroll = 4 * (k + 1)
        if (k + 1) % RESEED_EVERY == 0:
            grid, payload = seed_payload(clip_pics[k + 1])
            nal, nal_len = run_step(seed_step, payload, 0, 1, 2, SEED_CLASS,
                                    scroll, 0, frame_num, 0, 0, False)
            host.write_spliced_frame(ui_hints(scroll, 0), grid,
                                     as_reference=True)
        else:
            br, hdr = _slice_header(u, sps, pps)
            if hdr0 is None:
                hdr0 = hdr.qp_delta
            if hdr.qp_delta != hdr0:
                raise AssertionError("clip qp_delta changed mid-run")
            qp_delta = (26 + pps.pic_init_qp_minus26 + hdr.qp_delta
                        - (26 + cfg.pic_init_qp_minus26))
            t0 = time.perf_counter()
            nal, nal_len = run_step(
                p_step, u.rbsp, br.bit_position, hdr.num_ref_idx_l0, 3,
                P_CLASS, scroll, 1, frame_num, 1, qp_delta, True)
            timed += time.perf_counter() - t0
            n_p_frames += 1
            br2, hdr2 = _slice_header(u, sps, pps)
            grid = mbt.parse_p_slice_mbs(br2, dW, dH, hdr2.num_ref_idx_l0)
            # write_spliced_frame shifts hint refs by 1 itself in
            # donor_refs_previous mode; pass the unshifted hints here (the
            # device background grids carry the shifted index 1).
            host.write_spliced_frame(
                ui_hints(scroll, 0), grid, as_reference=True,
                donor_refs_previous=True,
                donor_slice_qp=26 + pps.pic_init_qp_minus26 + hdr.qp_delta)
        for b in range(batch):
            streams[b] += nal[b][: nal_len[b]].tobytes()
        frame_num += 1

    host_stream = host.getvalue()
    streams = [bytes(s) for s in streams]
    for b, data in enumerate(streams):
        if data != host_stream:
            first = next((i for i, (x, y) in enumerate(zip(data, host_stream))
                          if x != y), min(len(data), len(host_stream)))
            raise AssertionError(f"session {b} diverges from the host path "
                                 f"at byte {first}")

    data = streams[0]
    out_path = Path(out_path)
    out_path.write_bytes(data)
    _check_interior(data, clip_frames, clip_pics, rx, ry, dW, dH)
    fps = batch * n_p_frames / timed if timed else 0.0
    log(f"{out_path}: {len(data)} bytes x {batch} sessions, "
        f"{2 + len(clip_frames)} frames each, byte-identical to the host "
        f"path, 0 decoder errors; successive-donor splice on {device} "
        f"~{fps:.0f} frames/s at batch {batch} (host prep included, small "
        f"sample)")
    return streams


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--rx", type=int, default=40)
    ap.add_argument("--ry", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .. import avref

    if avref.missing() is not None:
        print(f"ERROR: needs libavcodec and libx264 (avref): "
              f"{avref.missing()}", file=sys.stderr)
        return 1
    if args.batched:
        main_batched(args.out or "video_in_corner_720p.h264", args.batch,
                     width=args.width, height=args.height, rx=args.rx,
                     ry=args.ry, device=args.device)
    else:
        main(args.out or "video_in_corner.h264", args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
