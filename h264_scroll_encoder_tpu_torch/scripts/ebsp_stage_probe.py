"""K3 against the plain bounded EBSP at the serving budgets.

Port of scripts/ebsp_stage_probe.py, which races the fused Pallas EBSP
and framing (K3's TPU kernel) against the XLA bounded-tree composition.
On the card the race is K3 (ops/ebsp_flat.rbsp_to_nal_batch) against the
port's plain version of the same function (rbsp_to_nal_plain), on the
JAX probe's input: B sessions of random bytes (seed 5) with the last
third zero, two thirds of the budget valid, at the budgets 5,960
("serving-rep") and 16,384 ("conservative") with the JAX probe's 1.5x
NAL sizing.  Timing: utils/timing.chained_ms (CUDA events).

    python -m h264_scroll_encoder_tpu_torch.scripts.ebsp_stage_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ebsp_flat
from . import _probe_common as common

BUDGETS = ((5960, "serving-rep"), (16384, "conservative"))


def payload(batch: int, n_rbsp: int, dev):
    """The JAX probe's rows (seed 5, a zero tail third) and lengths (two
    thirds of the budget), as K3's entry path takes them."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (batch, n_rbsp), dtype=np.uint8)
    rows[:, -n_rbsp // 3:] = 0
    lens = torch.full((batch,), n_rbsp * 2 // 3, dtype=torch.int64, device=dev)
    return torch.as_tensor(rows, device=dev), lens


def race(args, dev, n_rbsp: int, n_nal: int) -> dict:
    rb, lens = payload(args.batch, n_rbsp, dev)
    cap = common.CAP
    return {"n_rbsp": n_rbsp, "n_nal": n_nal,
            "plain_ms": common.chained(lambda b: ebsp_flat.rbsp_to_nal_plain(
                b, lens, 0x41, n_nal, cap), rb, args),
            "k3_ms": common.chained(lambda b: ebsp_flat.rbsp_to_nal_batch(
                b, lens, 0x41, n_nal, cap), rb, args)}


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    rows = {}
    for n_rbsp, tag in BUDGETS:
        n_nal = (5 + n_rbsp * 3 // 2 + 11) // 4 * 4
        rows[tag] = race(args, dev, n_rbsp, n_nal)
        r = rows[tag]
        print(f"{tag} (n_rbsp={n_rbsp}, n_nal={n_nal}): plain "
              f"{r['plain_ms']:.5f} ms  K3 {r['k3_ms']:.5f} ms / B={args.batch}",
              flush=True)
    common.table("ebsp_stage_probe", dev, rows, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
