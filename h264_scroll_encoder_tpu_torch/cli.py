"""Command-line programs with the reference's surface.

Port of h264_scroll_encoder_tpu/cli.py.  `composer` mirrors
src/main.c:14-141 (donor mode, triangle-wave scroll 0 -> height -> 0),
`scroll-encoder` mirrors the experiment's main.c:121-448 (test mode with
I_PCM atlases, scroll starting at 496 px so waypoints engage, max offset
height-16), and `splice-demo` embeds a donor's macroblocks into composed
P-frames.  Their output bytes are the JAX package's.  Each takes
`--device` (default `cuda`; `cpu` runs the kernels' plain versions).
`trans-resizer` widens a CAVLC stream with padding macroblocks (host
code on the native CAVLC engine):

    python -m h264_scroll_encoder_tpu_torch.cli composer --ref-a A --ref-b B ...
    python -m h264_scroll_encoder_tpu_torch.cli scroll-encoder -n 8 ...
    python -m h264_scroll_encoder_tpu_torch.cli splice-demo --donor D ...
    python -m h264_scroll_encoder_tpu_torch.cli trans-resizer IN OUT --out-width 720

(with no program name, the arguments go to `composer`, as the JAX
package's module does).
"""

from __future__ import annotations

import argparse
import sys

from .config import ComposerConfig
from .session import (ComposerSession, open_donor_session,
                      open_two_idr_session)

# BT.601 color table (experiments/scroll-encoder/src/main.c:19-30).
COLOR_TABLE = {
    "red": (81, 90, 240),
    "blue": (41, 240, 110),
    "green": (145, 54, 34),
    "yellow": (210, 16, 146),
    "cyan": (170, 166, 16),
    "magenta": (106, 202, 222),
    "white": (235, 128, 128),
    "black": (16, 128, 128),
    "gray": (128, 128, 128),
}


def triangle_offsets(num_frames: int, speed: int, max_offset: int,
                     start_offset: int = 0):
    """Scroll pattern 0 -> max -> 0 -> ... (src/main.c:109-120)."""
    cycle_len = max_offset * 2
    for i in range(num_frames):
        cycle_pos = (i * speed + start_offset) % cycle_len
        yield cycle_pos if cycle_pos < max_offset else cycle_len - cycle_pos


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the composed frames (default "
                         "cuda; cpu runs the kernels' plain versions)")


def composer_main(argv=None) -> int:
    """Donor-mode composer CLI (src/main.c)."""
    ap = argparse.ArgumentParser(
        prog="composer",
        description="Compose scroll P-frames from two donor I-frames")
    ap.add_argument("--ref-a", required=True, help="First reference I-frame")
    ap.add_argument("--ref-b", required=True, help="Second reference I-frame")
    ap.add_argument("-n", "--frames", type=int, default=250)
    ap.add_argument("-s", "--speed", type=int, default=4,
                    help="Scroll speed in pixels/frame")
    ap.add_argument("-o", "--output", default="output.h264")
    ap.add_argument("--pskip", action="store_true",
                    help="Enable spec-correct P_Skip runs (smaller frames; "
                         "not byte-compatible with the C reference)")
    ap.add_argument("--safe-mv", action="store_true",
                    help="Pre-provision the waypoint chain so every MV "
                         "stays within the 496px hardware budget (fixes "
                         "the reference's low-offset violation; not "
                         "byte-compatible)")
    _add_device(ap)
    args = ap.parse_args(argv)

    if args.frames <= 0 or args.speed <= 0:
        print("Error: --frames and --speed must be positive", file=sys.stderr)
        return 1

    try:
        session = open_donor_session(args.ref_a, args.ref_b,
                                     enable_pskip=args.pskip,
                                     device=args.device)
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    cfg = session.cfg
    print(f"Composer initialized: {cfg.width}x{cfg.height}")
    print(f"Generating {args.frames} frames, scroll speed "
          f"{args.speed} px/frame")

    session.write_parameter_sets()
    session.write_donor_atlases(session._donor_a_rbsp, session._donor_b_rbsp)
    if args.safe_mv:
        session.preprovision_waypoints()

    for offset in triangle_offsets(args.frames, args.speed, cfg.height):
        session.write_scroll_frame(offset)

    size = session.write_to_file(args.output)
    print(f"Written {size} bytes to {args.output}")
    print(f"\nDone! To play:\n  ffmpeg -i {args.output} -c:v copy "
          f"output.mp4 && ffplay output.mp4")
    return 0


def scroll_encoder_main(argv=None) -> int:
    """Test-mode scroll encoder CLI (experiments/scroll-encoder main.c)."""
    ap = argparse.ArgumentParser(
        prog="scroll-encoder",
        description="Generate a scrolling H.264 stream (I_PCM test atlases)")
    ap.add_argument("-i", "--input", help="Donor H.264 with 2 IDR frames")
    ap.add_argument("-o", "--output", default="output.h264")
    ap.add_argument("-n", "--frames", type=int, default=900)
    ap.add_argument("-S", "--speed", type=int, default=1)
    ap.add_argument("-w", "--width", type=int, default=640)
    ap.add_argument("-H", "--height", type=int, default=480)
    ap.add_argument("-s", "--striped", action="store_true", default=True)
    ap.add_argument("--color-a", default="gray", choices=COLOR_TABLE)
    ap.add_argument("--color-b", default="gray", choices=COLOR_TABLE)
    ap.add_argument("--solid", action="store_true",
                    help="Solid colors instead of striped test frames")
    ap.add_argument("--pskip", action="store_true")
    ap.add_argument("--rows-per-slice", type=int, default=0,
                    help="Emit each frame as multiple MB-row-aligned "
                         "slices (0 = single slice, reference-compatible)")
    _add_device(ap)
    args = ap.parse_args(argv)

    if args.input:
        try:
            session = open_two_idr_session(args.input,
                                           enable_pskip=args.pskip,
                                           device=args.device)
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        # Experiment donor mode frames SPS/PPS with nal_ref_idc=2
        # (main.c:341-347).
        session.write_parameter_sets(nal_ref_idc=2)
        session.write_donor_atlases(session._donor_a_rbsp,
                                    session._donor_b_rbsp)
        cfg = session.cfg
    else:
        cfg = ComposerConfig(args.width, args.height)
        session = ComposerSession(cfg, enable_pskip=args.pskip,
                                  device=args.device)
        session.write_parameter_sets()
        session.write_test_atlases(
            striped=not args.solid,
            color_a=COLOR_TABLE[args.color_a],
            color_b=COLOR_TABLE[args.color_b])

    max_offset = cfg.height - 16  # leave 1 MB row (experiment main.c:387)
    start = 496                   # engage waypoints (experiment main.c:400)
    for offset in triangle_offsets(args.frames, args.speed, max_offset,
                                   start_offset=start):
        if args.rows_per_slice:
            session.write_scroll_frame_sliced(offset, args.rows_per_slice)
        else:
            session.write_scroll_or_waypoint_frame(offset)

    size = session.write_to_file(args.output)
    print(f"Output size: {size} bytes\nWritten to {args.output}")
    return 0


def splice_demo_main(argv=None) -> int:
    """Dynamic-rect splice demo: compose P-frames with a donor rectangle
    embedded over P_Skip chrome + optional motion regions
    (MASTER_DESIGN §6; BASELINE 'dynamic-rect splice' config).

    The donor is a small CAVLC stream; its slices are spliced at
    --rect-x/--rect-y each frame (host path).
    """
    from pathlib import Path

    from .models import mb_transcode as mbt
    from .models.splice import (FrameHints, MotionRegion, parse_slice_header,
                                splice_p_frame, finalize_spliced_frame)
    from .ops.bitio import BitReader
    from .syntax import parse as sparse
    from .syntax.nal import write_nal_unit
    from .syntax.slice_headers import write_p_slice_header
    from .verify import verify_stream

    ap = argparse.ArgumentParser(
        prog="splice-demo",
        description="Embed a donor's pre-encoded macroblocks into composed "
                    "P-frames (dynamic-rect splice)")
    ap.add_argument("--donor", required=True,
                    help="CAVLC H.264 stream supplying dynamic-region MBs")
    ap.add_argument("-o", "--output", default="spliced.h264")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--rect-x", type=int, default=28,
                    help="rect position in MBs")
    ap.add_argument("--rect-y", type=int, default=10)
    ap.add_argument("--scroll-region", action="store_true",
                    help="add a scrolling motion region beside the rect")
    _add_device(ap)
    args = ap.parse_args(argv)

    donor_data = Path(args.donor).read_bytes()
    d_sps = d_pps = None
    donor_slices = []
    for u in sparse.iter_nal_units(donor_data):
        if u.nal_unit_type == 7 and d_sps is None:
            d_sps = sparse.parse_sps(u.rbsp)
        elif u.nal_unit_type == 8 and d_pps is None:
            d_pps = sparse.parse_pps(u.rbsp)
        elif u.nal_unit_type in (1, 5):
            donor_slices.append(u)
    if d_sps is None or d_pps is None or not donor_slices:
        print("Error: donor must contain SPS, PPS and slices",
              file=sys.stderr)
        return 1
    if d_pps.entropy_coding_mode_flag:
        print("Error: donor is CABAC; CAVLC required", file=sys.stderr)
        return 1

    cfg = ComposerConfig(args.width, args.height)
    session = ComposerSession(cfg, device=args.device)
    session.write_parameter_sets()
    session.write_test_atlases(striped=True)

    dw, dh = d_sps.width // 16, d_sps.height // 16
    num_refs = 2
    frame_idx = 0
    for u in donor_slices:
        br = BitReader(u.rbsp)
        hdr = parse_slice_header(
            br, is_idr=(u.nal_unit_type == 5), nal_ref_idc=u.nal_ref_idc,
            log2_max_frame_num=d_sps.log2_max_frame_num,
            pps_num_ref_idx_l0_default=(
                d_pps.num_ref_idx_l0_default_active_minus1 + 1))
        if hdr.is_i:
            donor_grid = mbt.parse_i_slice_mbs(br, dw, dh)
        else:
            donor_grid = mbt.parse_p_slice_mbs(br, dw, dh,
                                               hdr.num_ref_idx_l0)

        regions = ()
        if args.scroll_region:
            regions = (MotionRegion(0, 0, cfg.mb_width, args.rect_y - 1,
                                    ref_idx=0, mv_y=4 * (frame_idx + 1)),)
        hints = FrameHints(motion_regions=regions,
                           dynamic_mb_x=args.rect_x,
                           dynamic_mb_y=args.rect_y)
        grid = splice_p_frame(cfg, hints, donor_grid, num_refs)
        fn = session.frame_num

        def hdr_writer(bw, fn=fn):
            write_p_slice_header(bw, cfg, fn)

        rbsp = finalize_spliced_frame(cfg, grid, num_refs, hdr_writer)
        session.writer.append_raw(write_nal_unit(rbsp, 0, 1))
        session.frame_num += 1
        frame_idx += 1

    size = session.write_to_file(args.output)
    rep = verify_stream(session.getvalue())
    print(f"Output: {args.output} ({size} bytes, {frame_idx} spliced "
          f"frames)")
    print("Verification:", "SUCCESS" if rep.ok else f"FAILED {rep.errors[:3]}")
    return 0 if rep.ok else 1


def trans_resizer_main(argv=None) -> int:
    """Padding transcoder CLI (trans-resizer equivalent, generalized
    geometry; experiments/trans-resizer/trans_resizer.c:1787-1793): host
    code on the native CAVLC engine, verified with verify_stream."""
    from pathlib import Path

    from .models.splice import transcode_pad_stream
    from .syntax import parse as sparse
    from .verify import verify_stream

    ap = argparse.ArgumentParser(
        prog="trans-resizer",
        description="Widen a CAVLC H.264 stream by appending padding "
                    "macroblocks at each row's end")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--out-width", type=int, default=720)
    ap.add_argument("--out-height", type=int, default=None,
                    help="default: input height")
    ap.add_argument("--bug-compat", action="store_true",
                    help="reproduce the C reference's duplicated final "
                         "skip run byte-for-byte")
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args(argv)

    data = Path(args.input).read_bytes()
    try:
        sps = next(sparse.parse_sps(u.rbsp)
                   for u in sparse.iter_nal_units(data)
                   if u.nal_unit_type == 7)
        out_h = args.out_height or sps.height
        out = transcode_pad_stream(data, args.out_width, out_h,
                                   bug_compat=args.bug_compat)
    except (ValueError, StopIteration) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    Path(args.output).write_bytes(out)
    print(f"Output: {args.output} ({len(out)} bytes)")

    if not args.no_verify:
        # Self-verification, as the reference checks with ffmpeg
        # (trans_resizer.c:2176-2186), with the structural oracle.
        rep = verify_stream(out, strict_trailing=not args.bug_compat)
        print("Verification:", "SUCCESS" if rep.ok else
              f"FAILED {rep.errors[:3]}")
        return 0 if rep.ok else 1
    return 0


PROGRAMS = {"composer": composer_main,
            "scroll-encoder": scroll_encoder_main,
            "splice-demo": splice_demo_main,
            "trans-resizer": trans_resizer_main}


def main(argv=None) -> int:
    """`python -m h264_scroll_encoder_tpu_torch.cli [program] args...`:
    the first argument names the program (composer by default)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in PROGRAMS:
        return PROGRAMS[argv[0]](argv[1:])
    return composer_main(argv)


if __name__ == "__main__":
    sys.exit(main())
