"""P5: the insertion-count scan of K3's stage, per-thread runs against warp
ballots.

Port of scripts/ebsp_cumsum_probe.py, which races three ways of computing
the running insertion count inside the bounded EBSP stage on the TPU:
an int32 cumsum (shipped), an associative scan on uint8 lanes, and a
two-level scan over [R, 128] uint8 lanes.  On the card the count comes
from K3's emulation-prevention stage (ops/probes.ebsp_variant_batch,
csrc/probe_kernels.cu), and each JAX name is timed as the variant that
stands for it:

  int32-cumsum  runs    K3 itself: contiguous runs of bytes a thread, a
                        max-scan and a sum-scan across the block
  u8-cumsum     runs    no counterpart: 8-bit lanes do not exist in 32-bit
                        registers, so `runs` is timed in its place
  u8-two-level  ballot  32 consecutive bytes a warp step, ballots and
                        __popc within the warp, one carry scan across warps

First every variant is held equal to K3 (ops/ebsp_flat.rbsp_to_nal_batch)
and to K3's plain version (NAL bytes, and the count), then each is timed
on the JAX probe's input: B sessions of random bytes (seed 5) with the
last third zero, two thirds of the 5,960-byte budget valid ("serving-rep"),
n_nal = (5 + n_rbsp * 3 // 2 + 11) // 4 * 4.  Timing:
utils/timing.chained_ms, and on the card utils/timing.device_ms.

    python -m h264_scroll_encoder_tpu_torch.scripts.ebsp_cumsum_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ebsp_flat, probes
from ..utils import timing
from . import _probe_common as common
from .ebsp_stage_probe import payload

SHAPES = ((5960, "serving-rep"),)
RACE = (("int32-cumsum", "runs"), ("u8-cumsum", "runs"),
        ("u8-two-level", "ballot"))


def n_nal_of(n_rbsp: int) -> int:
    return (5 + n_rbsp * 3 // 2 + 11) // 4 * 4


def hostile_rows(n_rbsp: int = 5960):
    """Three sessions at the stage's edges: all zeros (saturates past the
    64-byte window), all 0x03 (never inserts), and random nonzero bytes
    with a 00 00 01 every 97 bytes (inserts past the cap): (rows uint8
    [3, n_rbsp], lengths int64 [3]) numpy."""
    rows = np.zeros((3, n_rbsp), np.uint8)
    rows[1] = 3
    rows[2] = np.random.default_rng(2).integers(1, 256, n_rbsp)
    for p in range(10, n_rbsp - 60, 97):
        rows[2, p:p + 3] = (0, 0, 1)
    return rows, np.asarray([n_rbsp, n_rbsp, n_rbsp - 60], np.int64)


def check_variants(variants, rows, lens, n_nal: int, header: int = 0x41):
    """Each variant equals K3 and K3's plain version on these rows
    (AssertionError otherwise)."""
    want = ebsp_flat.rbsp_to_nal_plain(rows, lens, header, n_nal, common.CAP)
    got = {"K3": ebsp_flat.rbsp_to_nal_batch(rows, lens, header, n_nal,
                                              common.CAP)}
    for v in variants:
        got[v] = probes.ebsp_variant_batch(v, rows, lens, header, n_nal,
                                           common.CAP)
    for name, outs in got.items():
        for g, w in zip(outs, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name} differs from K3's plain version "
                                     f"at n_nal {n_nal}")


def race(args, dev, n_rbsp: int, names, n_nal: int) -> dict:
    """{JAX name: {variant, ms[, device_ms]}} of the (JAX name, variant)
    pairs `names` at one budget and NAL size, after check_variants."""
    rows, lens = payload(args.batch, n_rbsp, dev)
    check_variants({v for _, v in names}, rows, lens, n_nal)
    out = {}
    for name, v in names:
        fn = lambda b, v=v: probes.ebsp_variant_batch(  # noqa: E731
            v, b, lens, 0x41, n_nal, common.CAP)
        r = {"variant": v, "n_rbsp": n_rbsp, "n_nal": n_nal,
             "ms": common.chained(fn, rows, args)}
        if dev.type == "cuda":
            r["device_ms"] = timing.device_ms(lambda fn=fn: fn(rows))
        out[name] = r
    return out


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    rows = {}
    for n_rbsp, tag in SHAPES:
        for name, r in race(args, dev, n_rbsp, RACE, n_nal_of(n_rbsp)).items():
            rows[f"{tag} {name}"] = r
            print(f"{tag} (n_nal={r['n_nal']}) {name} ({r['variant']}): "
                  f"{r['ms']:.5f} ms / batch-{args.batch} step"
                  + (f", device {r['device_ms']:.5f} ms a call"
                     if "device_ms" in r else ""), flush=True)
    print("parity ok: runs and ballot equal K3 and K3's plain version at "
          "every shape", flush=True)
    common.table("ebsp_cumsum_probe", dev, rows, batch=args.batch,
                 u8_cumsum="no 8-bit lanes in 32-bit registers: runs timed "
                           "in its place")
    return 0


if __name__ == "__main__":
    sys.exit(main())
