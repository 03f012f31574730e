"""Generate reference I-frame donor files (generate_refs.sh equivalent).

Port of scripts/generate_refs.py.  The reference's script uses
ffmpeg/libx264 to produce two half-and-half color IDR files
(scripts/generate_refs.sh:20-44).  By default the donors here are I_PCM IDR
frames from the port's own generator — accepted identically by the
composer and the C reference binary (the donor path treats the payload as
opaque macroblock data).  With --x264 the donors come from the real x264
encoder through the system libavcodec (avref), reproducing the reference
script's donor contract exactly (baseline profile, keyint=1).

    python -m h264_scroll_encoder_tpu_torch.scripts.generate_refs \
        [--width W --height H] [--out-dir DIR] [--x264] [--device D]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..cli import COLOR_TABLE


def half_and_half_rows(cfg, top, bottom):
    rows = np.empty((cfg.mb_height, 3), np.uint8)
    half = cfg.mb_height // 2
    rows[:half] = top
    rows[half:] = bottom
    return rows


def main(argv=None) -> int:
    from ..config import ComposerConfig
    from ..models import ipcm
    from ..session import ComposerSession

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--color-a", default="red", choices=COLOR_TABLE)
    ap.add_argument("--color-b", default="blue", choices=COLOR_TABLE)
    ap.add_argument("--x264", action="store_true",
                    help="encode donors with the real x264 encoder "
                         "(generate_refs.sh parity) instead of I_PCM")
    ap.add_argument("--qp", type=int, default=20, help="x264 QP")
    ap.add_argument("--device", default="cuda",
                    help="device of the writing session (the donors are "
                         "host bytes either way)")
    args = ap.parse_args(argv)

    cfg = ComposerConfig(args.width, args.height)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.x264:
        from .. import avref
        if avref.missing() is not None:
            print(f"ERROR: libx264 unavailable (avref): {avref.missing()}",
                  file=sys.stderr)
            return 1
    # Ref A: color-a over color-b halves; Ref B: swapped (mirrors the
    # reference script's two half-and-half screens).
    ca, cb = COLOR_TABLE[args.color_a], COLOR_TABLE[args.color_b]
    for name, rows in (("ref_a", half_and_half_rows(cfg, ca, cb)),
                       ("ref_b", half_and_half_rows(cfg, cb, ca))):
        path = out / f"{name}.h264"
        if args.x264:
            from .. import avref
            w = args.width
            y = np.repeat(rows[:, 0], 16)[:, None].repeat(w, 1)
            u = np.repeat(rows[:, 1], 8)[:, None].repeat(w // 2, 1)
            v = np.repeat(rows[:, 2], 8)[:, None].repeat(w // 2, 1)
            data = avref.encode_x264([(y, u, v)], qp=args.qp,
                                     keyint=1, refs=1)
            path.write_bytes(data)
            size = len(data)
        else:
            s = ComposerSession(cfg, device=args.device)
            s.write_parameter_sets()
            s.writer.append_raw(ipcm.idr_frame(cfg, rows))
            size = s.write_to_file(path)
        print(f"wrote {path} ({size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
