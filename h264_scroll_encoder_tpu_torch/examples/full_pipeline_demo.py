"""One session, every frame generator: the full composition surface.

Port of examples/full_pipeline_demo.py.  Builds a single Annex-B stream
that interleaves
  1. I_PCM atlas frames (long-term references),
  2. device-composed scroll P-frames,
  3. a hint-composed frame (static chrome + motion regions),
  4. a dynamic-rect spliced frame (donor CAVLC MBs + nC repair),
  5. more scroll frames (frame_num continuity across generators),
then re-parses the whole stream with the structural oracle and muxes it
to a progressive MP4 (utils/mp4mux).

    python -m h264_scroll_encoder_tpu_torch.examples.full_pipeline_demo \
        [OUT.h264] [--device cuda|cpu]

The MP4 goes beside OUT with the suffix .mp4.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def run(out_path, device="cuda", log=print) -> tuple:
    """Compose, verify and mux; returns (stream bytes, MP4 bytes)."""
    from ..config import ComposerConfig
    from ..models import mb_transcode as mbt
    from ..models.splice import FrameHints, MotionRegion
    from ..session import ComposerSession
    from ..utils import fixtures, mp4mux
    from ..verify import verify_stream

    cfg = ComposerConfig(1280, 720)
    s = ComposerSession(cfg, device=device)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    # Emit the waypoint chain up front so low-offset frames stay within
    # the 512 px decoder MV limit, and the spliced frame below exercises
    # donor-ref remapping against a populated reference list.
    s.preprovision_waypoints()

    # 1) scroll away from offset 0 (crosses no waypoint at these offsets)
    for off in (0, 8, 16, 24):
        s.write_scroll_or_waypoint_frame(off)

    # 2) hint frame: static chrome with two scrolling content bands
    hint = FrameHints(motion_regions=(
        MotionRegion(0, 2, 80, 10, ref_idx=0, mv_x=0, mv_y=32),
        MotionRegion(0, 34, 80, 42, ref_idx=1, mv_x=0, mv_y=-16)))
    s.write_hint_frame(hint)

    # 3) spliced frame: a 6x6-MB donor rect of synthetic CAVLC MBs
    #    composited into the hinted background (host path, exact mvds)
    rng = np.random.default_rng(42)
    donor = fixtures.random_p_slice_grid(rng, 6, 6, 1)
    for row in donor:
        for i, mb in enumerate(row):
            if mb is not mbt.SKIP and mb.kind == "ipcm":
                row[i] = fixtures.random_inter_mb(rng, 1)
    splice_hints = FrameHints(
        motion_regions=(MotionRegion(0, 2, 80, 10, ref_idx=0,
                                     mv_x=0, mv_y=40),),
        dynamic_mb_x=40, dynamic_mb_y=20)
    s.write_spliced_frame(splice_hints, donor)

    # 4) back to plain scrolling — frame_num must stay continuous
    for off in (32, 40, 48):
        s.write_scroll_or_waypoint_frame(off)

    data = s.getvalue()
    out_path = Path(out_path)
    out_path.write_bytes(data)
    rep = verify_stream(data)
    if not rep.ok:
        raise AssertionError(f"{out_path}: {rep.errors}")
    log(f"{out_path}: {len(data)} bytes, verifies OK "
        f"(errors={rep.errors}, warnings={rep.warnings})")

    mp4 = mp4mux.mux(data, fps=30)
    mp4_path = out_path.with_suffix(".mp4")
    mp4_path.write_bytes(mp4)
    log(f"muxed -> {mp4_path} ({len(mp4)} bytes)")
    return data, mp4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="full_pipeline.h264")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
