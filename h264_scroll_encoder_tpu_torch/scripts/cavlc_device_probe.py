"""Lockstep CAVLC residual decode on the card (P4) against the host engine.

Port of scripts/cavlc_device_probe.py.  Host donor prep is the one stage
of the splice path that stays off the device; the JAX probe asks whether
a batch of donors can walk the bit-serial residual grammar in lockstep on
the accelerator instead.  Here the decoder is ops/cavlc_lockstep
(`h264t_cavlc_lockstep`, csrc/cavlc_lockstep.cu: one thread a donor lane),
on the JAX probe's input: B = 256 lanes of K = 256 random residual blocks
from seed 5, each decode checked exactly against the host truth from
ops/cavlc before it is timed (utils/timing.chained_ms; the chain perturbs
a pad byte ahead of each row, so every step decodes the probe's streams).
`--wide W` adds a row of W lanes (the 256 streams repeated), so that more
of the card than 256 / 32 = 8 SMs is busy; the verdict reads the first
row.

The verdict's host side is measured on the same machine: the port's donor
prep (cases.prepare_splice_donors: splice_device.prepare_donor_rows_serving
with the native engine, as the rows splice step's inputs) of `--donors`
representative donors in one batch, per donor.  The device side is the
JAX probe's donor-equivalent: a representative donor carries DONOR_BITS of
residual payload, so DONOR_BITS / (mean bits a block) blocks, at the
measured time per block-lane.  Thresholds as the JAX probe's: KEEP below
0.5x the host's time, PARITY below 2x, REFUTE above.

    python -m h264_scroll_encoder_tpu_torch.scripts.cavlc_device_probe \
        [--batch B] [--blocks K] [--wide W] [--steps S] [--reps R] \
        [--donors N] [--engine native|python] [--device cpu]
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from .. import cases
from ..ops import cavlc_lockstep
from . import _probe_common as common

# The JAX probe's framing constant: residual bits of a representative
# 23x23 donor (scripts/cavlc_device_probe.py `donor_bits`).
DONOR_BITS = 43000
KEEP, PARITY = 0.5, 2.0


def hostile_blocks():
    """Blocks at the grammar's edges: tc = 16 with t1 = 3 and with t1 = 0
    (no total_zeros), level prefixes 14 and 15 at suffix length 0 (first
    level after fewer and after three trailing ones), large levels at
    longer suffixes, zeros left >= 7 (run_before class 7, runs up to 12)
    and empty blocks: [(levels, total_zeros, runs)]."""
    return [
        ((1, -1, 1) + tuple((-1) ** i * (2 + 3 * i) for i in range(13)), 0, ()),
        (tuple((-1) ** i * (40 + 120 * i) for i in range(16)), 0, ()),
        ((9,), 15, ()),                  # lc 14: prefix 14, suffix 0
        ((16,), 3, ()),                  # lc 28: prefix 14, suffix 14
        ((17,), 0, ()),                  # lc 30: prefix 15, suffix 0
        ((-500, 3), 5, (2,)),            # prefix 15, 12-bit suffix
        ((1, 1, -1, 8), 2, (1, 0, 1)),   # three trailing ones, then prefix 14
        ((-1, 1, 1, 16), 0, ()),         # three trailing ones, then prefix 15
        ((), 0, ()),
        ((5, -2), 14, (10,)),            # zeros left 14: class 7, run 10
        ((3, 2, -2), 13, (8, 3)),        # runs 8 then 3 (zeros left 5)
        ((2, 2, 2, 2), 12, (0, 0, 12)),  # run 12 at zeros left 12
        ((7, 6, 5, 4, 3, 2, 2, 2, 2, 2), 6, (1, 1, 1, 1, 1, 1)),
        ((), 0, ()),
    ]


def hostile_streams(lanes: int = 8):
    """`lanes` streams of the hostile blocks, lane b starting at block b:
    (data uint8 [lanes, nbytes], truth int32 [lanes, k, 5])."""
    blocks = hostile_blocks()
    streams, truths = zip(*(cavlc_lockstep.encode_stream(
        blocks[b % len(blocks):] + blocks[:b % len(blocks)])
        for b in range(lanes)))
    return (cavlc_lockstep.stream_batch(streams),
            np.asarray(truths, np.int32))


def check_exact(data, truth, luts, dev) -> None:
    """The decode of `data` equals the host truth (AssertionError)."""
    k = truth.shape[1]
    _end, out = cavlc_lockstep.decode_lockstep_batch(
        torch.as_tensor(data, device=dev), k, luts)
    if not np.array_equal(out.cpu().numpy(), truth):
        raise AssertionError("device decode != host decode")


def decode_ms(args, dev, data, k: int, luts) -> float:
    """chained_ms of the decode: each row behind one pad byte, which the
    chain perturbs and the decoder never reads."""
    x = torch.zeros((data.shape[0], data.shape[1] + 1), dtype=torch.uint8,
                    device=dev)
    x[:, 1:] = torch.as_tensor(data, device=dev)
    return common.chained(lambda d: cavlc_lockstep.decode_lockstep_batch(
        d[:, 1:], k, luts), x, args)


def host_ms_per_donor(args, dev, reps: int = 5) -> float:
    """Host donor prep per donor: --donors representative donors through
    cases.prepare_splice_donors (blob wire, to `dev`), median of `reps`
    batches after a warm one."""
    payloads = [cases.splice_donor_payload(k) for k in range(args.donors)]
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        cases.prepare_splice_donors(payloads, engine=args.engine, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:]) / args.donors


def row(args, dev, data, truth, luts, avg_bits: float) -> dict:
    B, k = truth.shape[:2]
    check_exact(data, truth, luts, dev)
    ms = decode_ms(args, dev, data, k, luts)
    us = ms * 1e3 / (B * k)
    levels = truth[:, :, 0] - truth[:, :, 1]
    warps = levels[:B // 32 * 32].reshape(-1, 32, k).max(axis=1) if B >= 32 \
        else levels
    return {"lanes": B, "blocks": k, "nbytes": data.shape[1], "ms": ms,
            "us_per_block_lane": us,
            "ms_per_donor": us * DONOR_BITS / avg_bits / 1e3,
            "levels_per_block": float(levels.mean()),
            "levels_per_block_warp_max": float(warps.mean())}


def verdict(ratio: float) -> str:
    if ratio < KEEP:
        return (f"KEEP: device decode is {1 / ratio:.1f}x the host engine; "
                "build the full-grammar on-device ingest")
    if ratio < PARITY:
        return (f"PARITY ({ratio:.2f}x host): not worth the full-grammar "
                "build while host cores are available")
    return (f"REFUTE: device decode is {ratio:.1f}x SLOWER than the host "
            "engine at lockstep; the per-step divergence and chained loads "
            "do not amortize")


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0], donors=True)
    ap.add_argument("--blocks", type=int, default=cavlc_lockstep.BLOCKS,
                    help="residual blocks a lane (default 256)")
    ap.add_argument("--wide", type=int, default=0,
                    help="lanes of an extra row, the streams repeated "
                         "(0: none)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    luts = cavlc_lockstep.device_luts(dev)
    data, truth, avg_bits = cavlc_lockstep.probe_streams(
        args.batch, args.blocks, cavlc_lockstep.SEED)
    h_data, h_truth = hostile_streams()
    check_exact(h_data, h_truth, luts, dev)
    print(f"verified: {args.batch} lanes x {args.blocks} blocks and "
          f"{h_truth.shape[0]} lanes of hostile blocks decoded exactly "
          f"(avg {avg_bits:.1f} bits/block)", flush=True)
    rows = {f"B={args.batch}": row(args, dev, data, truth, luts, avg_bits)}
    if args.wide:
        reps = -(-args.wide // args.batch)
        rows[f"B={args.wide}"] = row(
            args, dev, np.tile(data, (reps, 1))[:args.wide],
            np.tile(truth, (reps, 1, 1))[:args.wide], luts, avg_bits)
    host = host_ms_per_donor(args, dev)
    first = rows[f"B={args.batch}"]
    ratio = first["ms_per_donor"] / host
    for label, r in rows.items():
        print(f"{label}: {r['ms']:.5f} ms per {r['lanes']}x{r['blocks']}-block "
              f"decode = {r['us_per_block_lane']:.6f} us/block/lane; "
              f"donor-equivalent ({DONOR_BITS / avg_bits:.0f} blocks of "
              f"{DONOR_BITS} bits) {r['ms_per_donor']:.6f} ms/donor", flush=True)
    print(f"host donor prep ({args.engine} engine, {args.donors} donors a "
          f"batch): {host:.5f} ms/donor", flush=True)
    text = verdict(ratio)
    print(f"VERDICT: {text}", flush=True)
    common.table("cavlc_device_probe", dev, rows, donor_bits=DONOR_BITS,
                 avg_block_bits=avg_bits, host_ms_per_donor=host,
                 host_engine=args.engine, host_donors=args.donors,
                 ratio=ratio, verdict=text.split(":")[0].split(" ")[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
