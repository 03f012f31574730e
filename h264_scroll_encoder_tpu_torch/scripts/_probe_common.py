"""What the measurement scripts share: their arguments, the inputs they
measure (the JAX probes' own symbols and the 720p splice and scroll
shapes), the clock and the one-line table each prints last.

Every script runs on the card unless `--device cpu` is given; on the CPU
its kernels run their plain versions and its times come from the host
clock, which is no device time (each table says which clock it read).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import _kernels, cases
from ..config import MAX_EBSP_INSERTIONS, ComposerConfig
from ..utils import timing

CAP = MAX_EBSP_INSERTIONS
# The JAX probes' input: 8,483 symbols a session, widths 0-8, seed 1.
PROBE_SYMBOLS = 8483
PROBE_SEED = 1


def parser(description: str, *, batch: int = 256, steps: int = 8,
           reps: int = 3, donors: bool = False) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--batch", type=int, default=batch,
                    help=f"sessions a call (default {batch})")
    ap.add_argument("--steps", type=int, default=steps,
                    help="calls in a timed chain")
    ap.add_argument("--reps", type=int, default=reps,
                    help="chains timed (the best is reported)")
    if donors:
        ap.add_argument("--donors", type=int, default=cases.DENSE_DONORS,
                        help="seeded representative donors (default 32)")
        ap.add_argument("--engine", default="native",
                        choices=("native", "python"),
                        help="the CAVLC engine of the host donor prep")
    return ap


def device_of(args) -> torch.device:
    """The device the script runs on; a CUDA device without CUDA raises."""
    return _kernels.resolve_device(args.device)


def card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def clock(dev) -> str:
    return ("CUDA events, chains queued behind a sleep (device time)"
            if dev.type == "cuda"
            else "host clock, CPU plain versions (not a device time)")


def chained(fn, x, args) -> float:
    """utils/timing.chained_ms at the script's steps and reps."""
    return timing.chained_ms(fn, x, args.steps, args.reps)


def launches(fn, calls: int = 10):
    """(CUDA API launches, device ms) per call by torch.profiler after a
    warm call, or None where it records no device time (always on the
    CPU)."""
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return timing.profile_launches(fn, calls)


def probe_symbols(batch: int, dev, n: int = PROBE_SYMBOLS,
                  seed: int = PROBE_SEED):
    """The JAX probes' symbols: widths drawn from 0-8 and patterns masked
    to them (numpy, seeded), the same row for every session: int32
    (patterns, nbits) [batch, n], the symbol stages' widths."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 9, size=n).astype(np.int32)
    pat = rng.integers(0, 2 ** 31, size=n).astype(np.int32) & ((1 << nb) - 1)
    rows = lambda a: torch.as_tensor(np.broadcast_to(a, (batch, n)).copy(),  # noqa: E731
                                     device=dev)
    return rows(pat), rows(nb)


def donor_rows(fab, rng, engine: str, R: int = 23, C: int = 23):
    """The JAX probes' donor: an RxC grid from the fixture `fab`
    (fixtures.representative_donor_grid or dense_donor_grid) drawn from
    `rng`, as a one-reference P-slice payload through the host prep into
    DonorRows."""
    from ..models import mb_transcode as mbt
    from ..models import splice_device
    from ..ops.bitio import BitWriter

    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, fab(rng, C, R), 1)
    bw.write_trailing_bits()
    dd = splice_device.prepare_donor_dense_from_slice(bw.getvalue(), 0, C, R,
                                                      1, 2, engine=engine)
    return splice_device.pack_donor_rows(dd, R, C)


def rep_budget(engine: str) -> int:
    """The JAX emit_stage_probe's RBSP budget: bench.py's rows budget (4
    bits per background MB) of a 23x23 representative donor, seed 7."""
    from ..models import splice_device
    from ..utils import fixtures

    dr = donor_rows(fixtures.representative_donor_grid,
                    np.random.default_rng(7), engine)
    return splice_device.splice_rows_rbsp_budget(
        ComposerConfig(1280, 720), 23 * 23, 23, dr.donor_bits, bg_bits_per_mb=4)


def splice_donors(args, dev):
    """The splice donors: `args.donors` seeded representative
    donors through the host prep into the blob wire: (dn, donor_bits,
    has_align)."""
    payloads = [cases.splice_donor_payload(k) for k in range(args.donors)]
    return cases.prepare_splice_donors(payloads, engine=args.engine,
                                       device=dev)


def splice_symbols(cfg, B: int, dev, donors):
    """K1's input on the compact rows splice step at B sessions carrying
    the donors in turn: (patterns, nbits, n_rbsp, has_align)."""
    dn, bits, align = donors
    n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
    pat, nb = cases.splice_symbols(cfg, dn, B, n_rbsp, dev)
    return pat, nb, n_rbsp, bool(align.any())


def scroll_symbols(cfg, B: int, dev, policy: str = "floor"):
    """K1's input on step 0 of the scroll benchmark schedule at B sessions
    (policy "partitioned": the partitioned frames, 4 slots an MB):
    (patterns, nbits, nal_ref_idc, n_rbsp)."""
    from ..models import scroll
    from ..parallel import batch

    schedule = torch.as_tensor(cases.bench_schedule(cfg.height, B, 16),
                               device=dev)
    st = batch.SessionState.create(B, device=dev)
    needs = scroll.needs_waypoint(schedule[0], st.wp_offsets, st.wp_valid,
                                  st.wp_count)
    pat, nb, n_rbsp, idc = scroll.unified_frame_symbols(
        cfg, st.frame_num, schedule[0], st.wp_offsets, st.wp_ltidx,
        st.wp_valid, st.wp_count, needs, boundary_policy=policy)
    return pat, nb, idc, n_rbsp


def dense_ipcm_symbols(cfg, B: int, dev, args):
    """K1's input on the dense step of I_PCM-bearing donors at their
    default budget (K1's cluster plan: four blocks a session):
    (patterns, nbits, n_rbsp)."""
    dn, bits, _align = cases.prepare_dense_donors(
        "ipcm", engine=args.engine, device=dev,
        n=min(args.donors, cases.DENSE_DONORS))
    return cases.dense_symbols(cfg, "ipcm", cases.tile_donors(dn, B), bits,
                               dev)


def table(script: str, dev, rows, **extra) -> dict:
    """Print the script's table as one JSON line (its last) and return it."""
    out = {"script": script, "device": str(dev), "card": card(dev),
           "clock": clock(dev), **extra, "rows": rows}
    print(json.dumps(out), flush=True)
    return out
