"""Sub-stage decomposition of the rows splice step's symbol stage.

Port of scripts/symbols_stage_probe.py.  The pieces of
splice_device.rows_splice_symbols on the blob wire of the compact
program (the 32 seeded representative donors tiled over B sessions at
bench.py's geometry), each alone:

  unblob    blob wire -> donor fields (_unblob)
  stencil   scroll.mv_pred_grid_roles on the scattered donor roles
  skiprun   the composite skip-run scan and its ue() codes
  prologue  the donor rows and _dense_prologue (role scatter, MV
            stencil, skip runs, background symbol slots: K5 on the card)
  bg3       prologue, reading the background symbol grids (the JAX
            package's _bg3, now among K5's outputs)
  grid      K5 alone (ops/grid.composite_grid_batch) on the donor
            fields the prologue reads, prepared once outside the chain
  layout    all of rows_splice_symbols, the shipped stage

stencil and skiprun are plain torch chains of their own, so the table
shows the plain pieces beside the kernel.

Each runs op by op, as the step's `.eager` does (no CUDA graph), and for
each: the time per step of a chain (utils/timing.chained_ms, CUDA
events), the CUDA API launches and device time per call (torch.profiler)
and the host's issue time per call (utils/timing.host_ms): together they
show where the compact step's launches come from.

    python -m h264_scroll_encoder_tpu_torch.scripts.symbols_stage_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from .. import cases
from ..config import ComposerConfig
from ..models import scroll, splice_device
from ..ops import expgolomb
from ..ops import grid as gridops
from ..utils import timing
from . import _probe_common as common

R, C = cases.SPLICE_R, cases.SPLICE_C
R0, C0 = cases.SPLICE_R0, cases.SPLICE_C0
WIRE = (cases.SPLICE_S_ROW, cases.SPLICE_S_FLAT, cases.SPLICE_S_EXC)


def stages(cfg, B: int, dev, n_rbsp: int) -> dict:
    """{name: fn(blob) -> tensors} of the symbol stage's pieces."""
    H, W = cfg.mb_height, cfg.mb_width
    _hp, _hn, zero, _x, _y, coded0 = cases.splice_session_inputs(cfg, B, dev)
    hp, hn = _hp, _hn

    def unblob(blob):
        return tuple(splice_device._unblob(blob, R, C, *WIRE[1:]).values())

    def donor(blob):
        dn = splice_device._donor_rows({"blob": blob}, R, C, *WIRE)
        dn.update(splice_device.edge_roles_to_full(dn, R, C))
        return dn

    def prologue(blob):
        pro = splice_device._dense_prologue(cfg, R0, C0, R, C, 2, zero, zero,
                                            zero, coded0, donor(blob),
                                            compact_x=True)
        return tuple(x for x in pro if x is not None)

    def bg3(blob):
        pro = splice_device._dense_prologue(cfg, R0, C0, R, C, 2, zero, zero,
                                            zero, coded0, donor(blob))
        return pro.bg_p, pro.bg_n

    # K5's inputs from the full batch, prepared once: the chain's
    # perturbed blob does not reach them, and each step launches K5 alone.
    fixed = {}

    def grid_only(blob):
        if not fixed:
            fixed.update(donor(blob))
        return tuple(x for x in gridops.composite_grid_batch(
            R0, C0, R, C, 2, zero, zero, zero, coded0, fixed, compact_x=True)
            if x is not None)

    def layout(blob):
        return splice_device.rows_splice_symbols(
            cfg, C0, R0, R, C, 2, hp, hn, zero, zero, zero, coded0,
            {"blob": blob}, n_rbsp=n_rbsp, compact_x=True, s_row=WIRE[0],
            s_flat=WIRE[1], s_exc=WIRE[2])[:2]

    def stencil(blob):
        dn = donor(blob)

        def scat(vals):
            g = zero.clone()
            g[:, R0:R0 + R, C0:C0 + C] = vals.to(torch.int32).reshape(B, R, C)
            return g

        return scroll.mv_pred_grid_roles(
            scat(dn["a_ref"]), scat(dn["a_ref"]), scat(dn["a_mvx"]),
            scat(dn["a_mvy"]), scat(dn["b_ref"]), scat(dn["b_mvx"]),
            scat(dn["b_mvy"]), scat(dn["d_ref"]), scat(dn["d_mvx"]),
            scat(dn["d_mvy"]))

    def skiprun(blob):
        dn = splice_device._unblob(blob, R, C, *WIRE[1:])
        coded = coded0.clone()
        coded[:, R0:R0 + R, C0:C0 + C] = dn["coded"].reshape(B, R, C)
        coded_f = coded.reshape(B, H * W)
        idx = torch.arange(H * W, dtype=torch.int32,
                           device=dev).expand(B, H * W)
        last = torch.cummax(torch.where(coded_f, idx, -1), dim=1).values
        before = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
        return expgolomb.ue(idx - before - 1)

    return {"unblob": unblob, "stencil": stencil, "skiprun": skiprun,
            "prologue": prologue, "bg3": bg3, "grid": grid_only,
            "layout": layout}


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], donors=True).parse_args(argv)
    dev = common.device_of(args)
    cfg = ComposerConfig(1280, 720)
    dn, bits, _align = common.splice_donors(args, dev)
    n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
    blob = dn["blob"][torch.arange(args.batch, device=dev) % dn["blob"].shape[0]]
    rows = {}
    for name, fn in stages(cfg, args.batch, dev, n_rbsp).items():
        ms = common.chained(fn, blob, args)
        prof = common.launches(lambda: fn(blob))
        if dev.type == "cuda":
            host = timing.host_ms(lambda: fn(blob), 20)
        else:
            t0 = time.perf_counter()
            fn(blob)
            host = (time.perf_counter() - t0) * 1e3
        rows[name] = {"ms": ms, "host_ms": host,
                      "launches": None if prof is None else prof[0],
                      "device_ms": None if prof is None else prof[1]}
        print(f"  {name:9s} {ms:9.5f} ms/step, host {host:.5f} ms per call, "
              + ("launches not measured (no device time)" if prof is None else
                 f"{prof[0]:.1f} launches, {prof[1]:.5f} ms of device time "
                 "per call"), flush=True)
    common.table("symbols_stage_probe", dev, rows, batch=args.batch,
                 n_rbsp=n_rbsp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
