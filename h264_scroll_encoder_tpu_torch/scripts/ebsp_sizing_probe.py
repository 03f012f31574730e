"""K3 at the old 1.5x NAL sizing against the rbsp + cap sizing.

Port of scripts/ebsp_sizing_probe.py, which timed the bounded EBSP and
framing stage at the old 1.5x NAL buffer against the shipped rbsp + cap
buffer.  Here both sizings run through K3 (ops/ebsp_flat
.rbsp_to_nal_batch) as it is, on the JAX probe's input (B sessions,
seed 5, zero tail third, two thirds valid) at the serving-representative
budget of 5,960 bytes.  Timing: utils/timing.chained_ms (CUDA events).

    python -m h264_scroll_encoder_tpu_torch.scripts.ebsp_sizing_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

from ..ops import ebsp_flat, emit_fused
from . import _probe_common as common
from .ebsp_stage_probe import payload

N_RBSP = 5960


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    rb, lens = payload(args.batch, N_RBSP, dev)
    cap = common.CAP
    rows = {}
    for name, n_nal in (("old 1.5x sizing", (5 + N_RBSP * 3 // 2 + 11) // 4 * 4),
                        ("rbsp+cap sizing", emit_fused.nal_bytes(N_RBSP, cap))):
        ms = common.chained(lambda b, n_nal=n_nal: ebsp_flat.rbsp_to_nal_batch(
            b, lens, 0x41, n_nal, cap), rb, args)
        rows[name] = {"n_nal": n_nal, "k3_ms": ms}
        print(f"serving-rep {name} (n_nal={n_nal}): K3 {ms:.5f} ms / "
              f"B={args.batch}", flush=True)
    common.table("ebsp_sizing_probe", dev, rows, n_rbsp=N_RBSP, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
