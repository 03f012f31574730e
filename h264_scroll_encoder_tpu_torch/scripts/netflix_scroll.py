"""Real-content scroll pipeline (netflix_scroll.sh equivalent).

Port of scripts/netflix_scroll.py.  Mirrors
experiments/scroll-encoder/scripts/netflix_scroll.sh:1-116 without an
ffmpeg CLI: two images -> YUV420 -> genuine x264 two-IDR donor
(baseline/CAVLC, the :64-71 encode) -> composer donor mode -> MP4, then
the :106-111 verification (real-decoder error count) plus frame
extraction for eyeballing (test_encoder.sh:90-91).

    python -m h264_scroll_encoder_tpu_torch.scripts.netflix_scroll \
        image_a.png image_b.png [-o out.mp4] [--device D]
    python -m h264_scroll_encoder_tpu_torch.scripts.netflix_scroll --demo

Needs libavcodec and libx264 (avref); where they are missing it prints
what is missing and exits 1.  Images and extracted frames need PIL
(pass --extract-frames with no value to extract none).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np


def rgb_to_yuv420(rgb: np.ndarray):
    """BT.601 limited-range RGB -> planar YUV420 (ffmpeg -pix_fmt yuv420p)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256
    cb = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256
    cr = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256
    y = np.clip(np.round(y), 16, 235).astype(np.uint8)
    sub = (lambda p: np.round(
        p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean((1, 3))))
    cb = np.clip(sub(cb), 16, 240).astype(np.uint8)
    cr = np.clip(sub(cr), 16, 240).astype(np.uint8)
    return y, cb, cr


def yuv_to_rgb(y, cb, cr):
    """Inverse (for extracted-frame PNGs)."""
    yf = (y.astype(np.float64) - 16) * 255 / 219
    up = (lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1).astype(np.float64))
    cbf, crf = up(cb) - 128, up(cr) - 128
    r = yf + 1.596 * crf * 224 / 255 * 255 / 219
    g = yf - (0.813 * crf + 0.391 * cbf) * 224 / 255 * 255 / 219
    b = yf + 2.018 * cbf * 224 / 255 * 255 / 219
    return np.clip(np.stack([r, g, b], -1).round(), 0, 255).astype(np.uint8)


def load_image(path: str, mb_align=True):
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    if mb_align:
        h = img.shape[0] // 16 * 16
        w = img.shape[1] // 16 * 16
        img = img[:h, :w]
    return img


def demo_image(seed: int, w: int, h: int):
    """Synthesized 'screenshot': gradient bands + text-like noise rows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 255) // w, (yy * 255) // h,
                     255 - (yy * 255) // h], -1).astype(np.uint8)
    for row in range(24, h - 24, 48):       # "text" rows
        mask = rng.random((16, w)) < 0.25
        base[row: row + 16][mask] = (240, 240, 240)
    return base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image_a", nargs="?")
    ap.add_argument("image_b", nargs="?")
    ap.add_argument("-o", "--output", default="netflix_scroll.mp4")
    ap.add_argument("-n", "--frames", type=int, default=900)
    ap.add_argument("-S", "--speed", type=int, default=1)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--qp", type=int, default=23)
    ap.add_argument("--demo", action="store_true",
                    help="synthesize demo images (no inputs needed)")
    ap.add_argument("--demo-size", default="640x480")
    ap.add_argument("--extract-frames", type=int, nargs="*",
                    default=[0, 15, 30, 45],
                    help="frame indices to dump as PNG next to the output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import avref
    from ..cli import scroll_encoder_main
    from ..syntax import parse
    from ..utils import mp4mux

    if avref.missing() is not None:
        print(f"ERROR: system libavcodec/libx264 unavailable (avref): "
              f"{avref.missing()}", file=sys.stderr)
        return 1

    if args.demo:
        w, h = map(int, args.demo_size.split("x"))
        img_a, img_b = demo_image(1, w, h), demo_image(2, w, h)
    else:
        if not (args.image_a and args.image_b):
            print("ERROR: need two images (or --demo)", file=sys.stderr)
            return 1
        img_a, img_b = load_image(args.image_a), load_image(args.image_b)
        if img_a.shape != img_b.shape:
            print("ERROR: image dimensions differ", file=sys.stderr)
            return 1
    h, w = img_a.shape[:2]
    print(f"Resolution: {w}x{h}")

    # [1-2] YUV420 + genuine x264 two-IDR donor (baseline => CAVLC; the
    # netflix_scroll.sh CABAC guard :74-78 becomes structural here).
    print("[1/4] Encoding donor frames with x264 (baseline profile)...")
    donor = avref.encode_x264([rgb_to_yuv420(img_a), rgb_to_yuv420(img_b)],
                              qp=args.qp, keyint=1, refs=1)
    for u in parse.iter_nal_units(donor):
        if u.nal_unit_type == 8:
            if parse.parse_pps(u.rbsp).entropy_coding_mode_flag != 0:
                raise AssertionError("x264 produced CABAC — baseline "
                                     "contract violated")
            break
    print(f"  Donor: {len(donor)} bytes, CAVLC confirmed")

    with tempfile.TemporaryDirectory() as td:
        donor_path = Path(td) / "two_frames.h264"
        donor_path.write_bytes(donor)
        scroll_path = Path(td) / "scroll.h264"

        # [3] Compose the scroll animation (donor input mode).
        print(f"[2/4] Composing {args.frames} scroll frames "
              f"(speed {args.speed} px/frame) on {args.device}...")
        rc = scroll_encoder_main(["-i", str(donor_path),
                                  "-o", str(scroll_path),
                                  "-n", str(args.frames),
                                  "-S", str(args.speed),
                                  "--device", args.device])
        if rc:
            return rc
        stream = scroll_path.read_bytes()

    # [4] MP4 container.
    print("[3/4] Muxing MP4...")
    out = Path(args.output)
    out.write_bytes(mp4mux.mux(stream, fps=args.fps))
    print(f"  Created: {out} ({out.stat().st_size} bytes)")

    # [5] Verification: real-decoder error count (:106-111) + extraction.
    print("[4/4] Verifying with libavcodec...")
    pics, nerrors = avref.decode_pictures(stream)
    status = ("SUCCESS (no errors)" if nerrors == 0 else
              f"WARNING ({nerrors} errors found)")
    print(f"  Decode: {status}; {len(pics)} frames")

    if args.extract_frames:
        from PIL import Image
        for idx in args.extract_frames:
            if idx < len(pics):
                p = pics[idx]
                png = out.with_name(f"{out.stem}_frame{idx:04d}.png")
                Image.fromarray(yuv_to_rgb(p.y, p.cb, p.cr)).save(png)
                print(f"  Extracted {png}")

    print(f"\nDone!  Play: ffplay {out}")
    return 1 if nerrors else 0


if __name__ == "__main__":
    sys.exit(main())
