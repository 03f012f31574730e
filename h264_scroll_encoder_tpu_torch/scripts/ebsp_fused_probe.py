"""P6: K3's placement and framing, a shared-memory NAL against 16-bit
lanes and a NAL built in place.

Port of scripts/ebsp_fused_probe.py, which races, on the TPU, the shipped
bounded expansion (three rolled arrays: values, remaining shift, live)
against one uint16 lane carrying value and remaining shift, and then a
framing whose prefix enters as live lanes, which removes the zeros(n_nal)
and the prefix placement.  On the card the stage is K3's
(ops/probes.ebsp_variant_batch, csrc/probe_kernels.cu), and each JAX form
is timed as the variant that stands for it:

  3-array         shared  K3: the NAL assembled in shared memory, then
                          written out by store_nal's 16-byte stores
  fused-u16       lanes   the counting pass keeps byte | insert << 8 as
                          16-bit lanes, the scatter pass rereads them
  fused-framing   direct  the NAL built in place in the output row with its
                          prefix (K3's global plan forced on), no
                          shared-memory NAL and no copy-out

First the JAX probe's exactness cases (24 streams of 4,096 bytes salted
with zero runs, seed 11, and 64 valid bytes of all zeros and of all
0x03): every variant equals K3 and K3's plain version (NAL bytes and the
count, also past the insertion cap).  Then the race on the JAX probe's
input: B sessions of random bytes (seed 5) with the last third zero, two
thirds valid, at n_rbsp 5,960 ("serving-rep") and 16,384
("profiler-rep"), n_nal = (5 + n_rbsp + cap + 11) // 4 * 4.  Timing:
utils/timing.chained_ms, and on the card utils/timing.device_ms.

    python -m h264_scroll_encoder_tpu_torch.scripts.ebsp_fused_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import _probe_common as common
from .ebsp_cumsum_probe import check_variants, race

SHAPES = ((5960, "serving-rep"), (16384, "profiler-rep"))
RACE = (("3-array", "shared"), ("fused-u16", "lanes"),
        ("fused-framing", "direct"))
EXACT_BYTES = 4096


def n_nal_of(n_rbsp: int) -> int:
    return (5 + n_rbsp + common.CAP + 11) // 4 * 4


def exact_cases():
    """The JAX probe's exactness cases (check_exact, seed 11): 24 salted
    streams, then all zeros and all 0x03 with 64 valid bytes: (rows uint8
    [26, 4096], lengths int64 [26]) numpy."""
    rng = np.random.default_rng(11)
    rows, lens = [], []
    for _ in range(24):
        n = int(rng.integers(1, EXACT_BYTES))
        buf = rng.integers(0, 256, EXACT_BYTES, dtype=np.uint8)
        for _ in range(8):
            p = int(rng.integers(0, max(1, n - 4)))
            buf[p:p + int(rng.integers(2, 5))] = 0
            buf[min(n - 1, p + 4)] = int(rng.integers(0, 4))
        rows.append(buf)
        lens.append(n)
    rows += [np.zeros(EXACT_BYTES, np.uint8), np.full(EXACT_BYTES, 3, np.uint8)]
    lens += [64, 64]
    return np.stack(rows), np.asarray(lens, np.int64)


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    rows_np, lens_np = exact_cases()
    check_variants([v for _, v in RACE], torch.as_tensor(rows_np, device=dev),
                   torch.as_tensor(lens_np, device=dev),
                   n_nal_of(EXACT_BYTES))
    print(f"exactness: {len(lens_np)} cases OK (shared, lanes, direct == K3 "
          "== K3's plain version)", flush=True)
    rows = {}
    for n_rbsp, tag in SHAPES:
        for name, r in race(args, dev, n_rbsp, RACE, n_nal_of(n_rbsp)).items():
            rows[f"{tag} {name}"] = r
            print(f"{tag} (n_nal={r['n_nal']}) {name} ({r['variant']}): "
                  f"{r['ms']:.5f} ms / batch-{args.batch} step"
                  + (f", device {r['device_ms']:.5f} ms a call"
                     if "device_ms" in r else ""), flush=True)
    common.table("ebsp_fused_probe", dev, rows, batch=args.batch,
                 exact_cases=len(lens_np))
    return 0


if __name__ == "__main__":
    sys.exit(main())
