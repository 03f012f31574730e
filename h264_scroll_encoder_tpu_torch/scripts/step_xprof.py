"""Op-level profile of the rows splice step.

Port of scripts/step_xprof.py (which reads an XLA device trace): the
compact rows splice step at bench.py's geometry (the 32 seeded
representative donors on the blob wire, tiled over B sessions), run op by op (the step's `.eager`, not its CUDA graph, so
that each op is its own launch in the trace) under torch.profiler over a
few warm steps, and from its trace

  - the top device kernels by total time, with their count per step;
  - the device's busy time per step against the host wall, and the
    longest idle gaps between kernels on the card.

On the CPU there is no device trace: the table lists the top CPU ops by
self time instead and says so.

    python -m h264_scroll_encoder_tpu_torch.scripts.step_xprof \
        [--batch B] [--steps S] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from .. import cases
from ..config import ComposerConfig
from . import _probe_common as common

TOP = 15  # kernels (CPU ops) and gaps listed


def compact_step(args, dev):
    """(fn running one compact rows step op by op, its argument tuple)."""
    cfg = ComposerConfig(1280, 720)
    dn, bits, align = common.splice_donors(args, dev)
    step = cases.splice_steps(cfg, int(bits.max()), bool(align.any()))["compact"]
    blob = dn["blob"][torch.arange(args.batch, device=dev) % dn["blob"].shape[0]]
    inputs = cases.splice_session_inputs(cfg, args.batch, dev) + ({"blob": blob},)
    return step.eager, inputs


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], steps=4,
                         donors=True).parse_args(argv)
    dev = common.device_of(args)
    step, inputs = compact_step(args, dev)
    cuda = dev.type == "cuda"
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(*inputs)
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            step(*inputs)
        if cuda:
            torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    n = args.steps
    if cuda:
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])),
                      reverse=True)[:TOP]
        totals = {}
        for e in kernels:
            t = totals.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
        top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:TOP]
        rows = {"top_ops": [{"name": k[:120], "us_per_step": v[0] / n,
                             "count_per_step": v[1] / n} for k, v in top],
                "kernels_per_step": len(kernels) / n,
                "device_ms_per_step": busy_us / 1e3 / n,
                "wall_ms_per_step": wall_ms,
                "busy_share": busy_us / 1e3 / n / wall_ms,
                "longest_gaps_us": [g for g, _ in gaps]}
        print(f"B={args.batch}: {rows['kernels_per_step']:.1f} kernels and "
              f"{rows['device_ms_per_step']:.5f} ms of device time per step, "
              f"host wall {wall_ms:.5f} ms (busy {rows['busy_share']:.1%}) "
              "under the profiler", flush=True)
    else:
        ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        rows = {"top_ops": [{"name": e.key, "us_per_step": e.self_cpu_time_total / n,
                             "count_per_step": e.count / n}
                            for e in ev[:TOP]],
                "wall_ms_per_step": wall_ms,
                "note": "CPU ops by self time; no device trace on the CPU"}
    for op in rows["top_ops"]:
        print(f"  {op['us_per_step']:10.2f} us/step  x{op['count_per_step']:<6.1f} "
              f"{op['name'][:100]}", flush=True)
    if cuda:
        print("  longest idle gaps (us): " + ", ".join(
            f"{g:.1f}" for g in rows["longest_gaps_us"]), flush=True)
    common.table("step_xprof", dev, rows, batch=args.batch, steps=n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
