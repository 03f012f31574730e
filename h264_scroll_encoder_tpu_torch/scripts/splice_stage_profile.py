"""Stage decomposition of the rows splice step.

Port of scripts/splice_stage_profile.py: each stage of the serving step
timed alone at bench.py's geometry (23x23 MBs at MB (30, 10) of a 720p
frame, B sessions, one seeded donor, seed 7), with utils/timing
`chained_ms` (the JAX probes' chain, CUDA events):

  symbols  splice_device.rows_splice_symbols
  finish   the finish (_finish_splice: K1) on the symbols computed once
  pack     K2 (pack_words_place_batch) at the same shapes
  ebsp     K3 (rbsp_to_nal_batch) at the same budget on random bytes
  full     the shipped step (parallel/batch.make_batched_splice_step_rows)
           run op by op: its `.eager`, as every stage above runs
  graphed  the shipped step as it serves: its CUDA graph replayed

and beside each its CUDA API launches and device time per call by
torch.profiler.  `--dense` takes the dense donor grid family
(fixtures.dense_donor_grid), `--static` the static-chrome program.

    python -m h264_scroll_encoder_tpu_torch.scripts.splice_stage_profile \
        [--dense] [--static] [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import cases
from ..config import ComposerConfig
from ..models import splice_device
from ..ops import bitpack_flat, ebsp_flat, emit_fused
from ..parallel import batch
from ..utils import fixtures
from . import _probe_common as common

R = C = 23
R0, C0 = 10, 30


def step_inputs(args, dev):
    """(step inputs (hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded, dn),
    n_rbsp, has_align, kwargs of the step) at the script's batch."""
    cfg = ComposerConfig(1280, 720)
    fab = (fixtures.dense_donor_grid if args.dense
           else fixtures.representative_donor_grid)
    dr = common.donor_rows(fab, np.random.default_rng(7), args.engine, R, C)
    dn = {k: v.expand(args.batch, *v.shape).contiguous()
          for k, v in splice_device.rows_device_arrays(dr, dev).items()}
    if args.static:
        n_rbsp = splice_device.splice_rows_rbsp_budget(
            cfg, R * C, R, dr.donor_bits, static_bg=True)
    else:
        n_rbsp = splice_device.splice_rows_rbsp_budget(
            cfg, R * C, R, dr.donor_bits, bg_bits_per_mb=4)
    kw = {"compact_x": not args.static, "bg_static_skip": args.static}
    return (cases.splice_session_inputs(cfg, args.batch, dev) + (dn,), n_rbsp,
            bool(dr.has_align), kw)


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true",
                    help="the dense donor grid family")
    ap.add_argument("--static", action="store_true",
                    help="the static-chrome program")
    ap.add_argument("--engine", default="native", choices=("native", "python"))
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cfg = ComposerConfig(1280, 720)
    inputs, n_rbsp, has_align, kw = step_inputs(args, dev)
    hp, rest = inputs[0], inputs[1:]
    step = batch.make_batched_splice_step_rows(
        cfg, C0, R0, C, R, num_refs=2, has_align=has_align, n_rbsp=n_rbsp, **kw)

    def symbols(h):
        return splice_device.rows_splice_symbols(
            cfg, C0, R0, R, C, 2, h, *rest, n_rbsp=n_rbsp, **kw)[:2]

    pat, nb = symbols(hp)
    cap = common.CAP
    rng = np.random.default_rng(3)
    rbsp = torch.as_tensor(np.tile(rng.integers(0, 256, n_rbsp, dtype=np.uint8),
                                   (args.batch, 1)), device=dev)
    rbsp_len = torch.full((args.batch,), n_rbsp, dtype=torch.int64, device=dev)
    n_nal = emit_fused.nal_bytes(n_rbsp, cap)
    nw = (n_rbsp + 3) // 4
    stages = {
        "full": (lambda h: step.eager(h, *rest), hp),
        "graphed": (lambda h: step(h, *rest), hp),
        "symbols": (symbols, hp),
        "finish": (lambda p: splice_device._finish_splice(
            p, nb, n_rbsp, 0, has_align=has_align, ebsp_exact=False), pat),
        "pack": (lambda p: bitpack_flat.pack_words_place_batch(p, nb, nw), pat),
        "ebsp": (lambda b: ebsp_flat.rbsp_to_nal_batch(b, rbsp_len, 0x01, n_nal,
                                                       cap), rbsp),
    }
    print(f"symbol lanes: {pat.shape[1]}, n_rbsp: {n_rbsp}, batch {args.batch}"
          f"{' (dense donor)' if args.dense else ''}"
          f"{' (static chrome)' if args.static else ''}", flush=True)
    rows = {}
    for name, (fn, x) in stages.items():
        ms = common.chained(fn, x, args)
        prof = common.launches(lambda: fn(x))
        rows[name] = {"ms": ms, "launches": None if prof is None else prof[0],
                      "device_ms": None if prof is None else prof[1]}
        print(f"  {name:8s} {ms:9.5f} ms/step, " + (
            "launches not measured (no device time)" if prof is None else
            f"{prof[0]:.1f} launches and {prof[1]:.5f} ms of device time "
            "per call"), flush=True)
    full = rows["full"]["ms"]
    print("shares of full: " + ", ".join(
        f"{n} {100 * rows[n]['ms'] / full:.0f}%"
        for n in ("symbols", "finish", "pack", "ebsp")), flush=True)
    common.table("splice_stage_profile", dev, rows, n_symbols=pat.shape[1],
                 n_rbsp=n_rbsp, dense=args.dense, static=args.static,
                 batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
