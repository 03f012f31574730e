"""Multi-device dry run: every serving program sharded against unsharded.

The port-side counterpart of the JAX package's `dryrun_multichip` and its
two helpers (`__graft_entry__.py`).  Sessions split over a list of devices
as parallel/batch.shard_batch places them (the "sessions" mesh axis);
each program runs once unsharded on the first device and once sharded,
and every session's NAL bytes, lengths and flags must be equal:

  - the 64x64 scroll step (make_sharded_step);
  - the dense, rows-compact and static-chrome splice steps (each also
    equal to the dense step's bytes);
  - the successive-donor rows step (native MV retarget, short-term-lead
    header), its donor wire built on each block's device;
  - the 1280x720 scroll and hint steps, one session per device;
  - run_frames over a [T, B] schedule;
  - the T-step compacted egress ring (compact_sharded_nal: the one
    cross-device gather);
  - the fresh-donor rows step with a different donor per session.

    python -m h264_scroll_encoder_tpu_torch.parallel.dryrun [--device D]...

On one card the device list may repeat cuda:0; on the CPU it is
["cpu"] * n.  Any difference raises AssertionError.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import ComposerConfig, MAX_WAYPOINTS
from ..models import hints as hints_model
from ..models import mb_transcode as mbt
from ..models import splice_device
from ..models.splice import FrameHints, MotionRegion
from ..ops.bitio import BitWriter
from ..syntax.slice_headers import p_slice_header_symbols
from ..utils import fixtures
from . import batch


def _check(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(f"dryrun_multigpu: {what}")


def valid_bytes(nal, nal_len):
    """The NAL rows with every byte past each session's length zeroed."""
    cols = torch.arange(nal.shape[1], device=nal.device)[None, :]
    return torch.where(cols < nal_len[:, None].to(cols.dtype), nal, 0)


def _same_frames(name: str, unsharded, sharded) -> None:
    """(nal, nal_len, ..., overflow) of the unsharded program against the
    gathered sharded one: equal lengths, valid bytes and every other
    output."""
    home = unsharded[0].device
    sharded = tuple(x.to(home) for x in sharded)
    _check(torch.equal(unsharded[1], sharded[1]), f"{name}: NAL lengths differ")
    _check(torch.equal(valid_bytes(unsharded[0], unsharded[1]),
                       valid_bytes(sharded[0], sharded[1])),
           f"{name}: NAL bytes differ")
    for i, (u, s) in enumerate(zip(unsharded[2:], sharded[2:]), 2):
        _check(torch.equal(u, s), f"{name}: output {i} differs")
    _check(not unsharded[-1].any(), f"{name}: a frame overflowed")


def _bcast(x, B: int):
    return x.unsqueeze(0).expand(B, *x.shape).contiguous()


def _blocks(args, devices) -> list:
    """Each of `args` split over the devices (shard_batch)."""
    return [batch.shard_batch(a, devices) for a in args]


def _wires(wire, payloads, devices) -> list:
    """Each block's share of the donor `payloads` prepared on its own
    device: wire(payloads, device), prepare_donor_rows_serving(...,
    device=)."""
    per = len(payloads) // len(devices)
    shares = [payloads[i * per:(i + 1) * per] for i in range(len(devices))]
    return batch.run_on_blocks(wire, devices, shares, devices)


def _header(cfg, B: int, device, is_reference: bool = False,
            prev_ref_abs_diff: int = 0):
    """P slice header symbols of B sessions at frame_num 3, no waypoints."""
    zl = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32, device=device)
    return p_slice_header_symbols(
        cfg, torch.full((B,), 3, dtype=torch.int32, device=device), 6,
        is_reference, -1, 0, zl, zl.bool(),
        prev_ref_abs_diff=prev_ref_abs_diff)


def _background(cfg, B: int, device):
    zero = torch.zeros((B, cfg.mb_height, cfg.mb_width), dtype=torch.int32,
                       device=device)
    return zero, zero, zero, zero.bool()


def dryrun_multigpu(devices) -> dict:
    """Run every program of the module docstring sharded over `devices`
    and unsharded on devices[0]; raises AssertionError on any difference.
    Returns {program: sessions} of what was compared."""
    devices = [batch.block_device(d) for d in devices]
    n = len(devices)
    report = {}
    report.update(_dryrun_64(devices, n))
    report.update(_dryrun_720p(devices, n))
    report.update(_dryrun_serving_loop(devices, n))
    return report


def _dryrun_64(devices, n: int) -> dict:
    home = devices[0]
    cfg = ComposerConfig(64, 64)
    bsz = 2 * n
    offsets = torch.as_tensor(np.arange(bsz) * 4 % 64, dtype=torch.int32)

    # The scroll step.
    _, out_u = batch.make_batched_step(cfg)(
        batch.SessionState.create(bsz, device=home), offsets.to(home))
    states, outs = batch.make_sharded_step(cfg, devices)(
        batch.shard_batch(batch.SessionState.create(bsz, device=home),
                          devices),
        batch.shard_batch(offsets, devices))
    _same_frames("64x64 scroll step", out_u, batch.gather_batch(outs, home))
    _check(out_u[1].min() > 0, "64x64 scroll step: an empty NAL")
    _check(batch.gather_batch(states, home).frame_num.min() >= 3,
           "64x64 scroll step: frame_num did not advance")

    # The dense splice step on a 2x2 representative donor.
    rng = np.random.default_rng(3)
    donor = fixtures.representative_donor_grid(rng, 2, 2)
    dd = splice_device.prepare_donor_dense(donor, 2)
    dn = {k: _bcast(v, bsz)
          for k, v in splice_device.dense_device_arrays(dd, home).items()}
    args = _header(cfg, bsz, home) + _background(cfg, bsz, home)
    dense = batch.make_batched_splice_step_dense(
        cfg, 1, 1, 2, 2, num_refs=2, has_align=dd.has_align)
    d_u = dense(*args, dn)
    _same_frames("dense splice step", d_u, batch.gather_batch(
        batch.run_on_blocks(dense, devices, *_blocks(args + (dn,), devices)),
        home))
    _check(d_u[1].min() > 0, "dense splice step: an empty NAL")

    # The rows step, compact background and static chrome: the same bytes
    # as the dense step.
    dr = splice_device.pack_donor_rows(dd, 2, 2)
    dnr = {k: _bcast(v, bsz)
           for k, v in splice_device.rows_device_arrays(dr, home).items()}
    programs = {
        "rows compact splice step": batch.make_batched_splice_step_rows(
            cfg, 1, 1, 2, 2, num_refs=2, has_align=dr.has_align,
            compact_x=True),
        "rows static-chrome splice step": batch.make_batched_splice_step_rows(
            cfg, 1, 1, 2, 2, num_refs=2, has_align=dr.has_align,
            n_rbsp=splice_device.splice_rows_rbsp_budget(
                cfg, 4, 2, dr.donor_bits, static_bg=True),
            bg_static_skip=True)}
    for name, step in programs.items():
        r_u = step(*args, dnr)
        _same_frames(name, r_u, batch.gather_batch(
            batch.run_on_blocks(step, devices,
                                *_blocks(args + (dnr,), devices)), home))
        _check(torch.equal(r_u[1], d_u[1])
               and torch.equal(valid_bytes(*r_u[:2])[:, :d_u[0].shape[1]],
                               valid_bytes(*d_u[:2])[:, :r_u[0].shape[1]]),
               f"{name}: bytes differ from the dense step's")

    # The successive-donor rows step: native in-place MV retarget and the
    # short-term-lead header; each block's donor wire built on its device.
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, donor, 1)
    bw.write_trailing_bits()
    payloads = [bw.getvalue()] * bsz

    def successive_wire(payloads, device):
        dn2, _meta = splice_device.prepare_donor_rows_serving(
            payloads, [0] * len(payloads), 2, 2, 1, 3, s_row=64,
            retarget_mvs=True, device=device)
        return dn2

    args2 = (_header(cfg, bsz, home, is_reference=True, prev_ref_abs_diff=1)
             + _background(cfg, bsz, home))
    succ = batch.make_batched_splice_step_rows(
        cfg, 1, 1, 2, 2, num_refs=3, nal_ref_idc=2, has_align=True,
        compact_x=True)
    s_u = succ(*args2, successive_wire(payloads, home))
    _same_frames("successive-donor rows step", s_u, batch.gather_batch(
        batch.run_on_blocks(succ, devices, *_blocks(args2, devices),
                            _wires(successive_wire, payloads, devices)),
        home))
    _check(s_u[1].min() > 0, "successive-donor rows step: an empty NAL")
    return {"64x64 scroll step": bsz, "dense splice step": bsz,
            **{name: bsz for name in programs},
            "successive-donor rows step": bsz}


def _dryrun_720p(devices, n: int) -> dict:
    """The 1280x720 scroll and hint steps, one session per device."""
    home = devices[0]
    cfg = ComposerConfig(1280, 720)
    bsz = n
    offsets = torch.as_tensor(np.arange(bsz) * 16 % 720, dtype=torch.int32)
    _, out_u = batch.make_batched_step(cfg)(
        batch.SessionState.create(bsz, device=home), offsets.to(home))
    _, outs = batch.make_sharded_step(cfg, devices)(
        batch.shard_batch(batch.SessionState.create(bsz, device=home),
                          devices),
        batch.shard_batch(offsets, devices))
    _same_frames("720p scroll step", out_u, batch.gather_batch(outs, home))

    # Static chrome and two motion regions.
    hints = FrameHints(motion_regions=(
        MotionRegion(0, 0, cfg.mb_width, 10, ref_idx=0, mv_y=24),
        MotionRegion(10, 30, 40, 40, ref_idx=1, mv_y=-8)))
    ref, mvx, mvy = hints_model.hint_fields(cfg, hints, home)
    args = (torch.full((bsz,), 3, dtype=torch.int32, device=home),
            _bcast(ref, bsz), _bcast(mvx, bsz), _bcast(mvy, bsz),
            torch.zeros((bsz,), dtype=torch.int32, device=home),
            torch.zeros((bsz, MAX_WAYPOINTS), dtype=torch.int32, device=home),
            torch.zeros((bsz, MAX_WAYPOINTS), dtype=torch.bool, device=home))
    h_u = batch.make_batched_hint_step(cfg, compact_x=True, device=home)(*args)
    # The hint step places its inputs on the device it was made for.
    h_s = batch.run_on_blocks(
        lambda dev, *a: batch.make_batched_hint_step(
            cfg, compact_x=True, device=dev)(*a),
        devices, devices, *_blocks(args, devices))
    _same_frames("720p hint step", h_u, batch.gather_batch(h_s, home))
    return {"720p scroll step": bsz, "720p hint step": bsz}


def _dryrun_serving_loop(devices, n: int) -> dict:
    """run_frames, the T-step compacted egress ring and the fresh-donor
    rows step (a different donor per session), sharded against
    unsharded."""
    home = devices[0]
    cfg = ComposerConfig(64, 64)
    bsz = 2 * n
    T = 4
    offs = torch.as_tensor((np.arange(T)[:, None] * 8
                            + np.arange(bsz)[None, :] * 4) % 64,
                           dtype=torch.int32)

    # 1. run_frames over [T, B], sessions split along B.
    _, outs_u = batch.run_frames(cfg, batch.SessionState.create(bsz,
                                                                device=home),
                                 offs.to(home))
    states = batch.shard_batch(batch.SessionState.create(bsz, device=home),
                               devices)
    offs_blocks = [o.T for o in batch.shard_batch(offs.T, devices)]
    outs_s = batch.run_on_blocks(lambda st, o: batch.run_frames(cfg, st, o)[1],
                                 devices, states, offs_blocks)
    for i, u in enumerate(outs_u):
        s = torch.cat([o[i].to(home) for o in outs_s], dim=1)
        _check(torch.equal(u, s), f"run_frames: output {i} differs")
    _check(not outs_u[-1].any(), "run_frames: a frame overflowed")

    # 2. The T-step compacted egress ring: per step the batch's valid bytes
    # in one buffer, across the blocks.
    cap = bsz * 2048
    step = batch.make_batched_step(cfg, emit_waypoints=False)
    sharded = batch.make_sharded_step(cfg, devices, emit_waypoints=False)
    st_u = batch.SessionState.create(bsz, device=home)
    st_s = batch.shard_batch(batch.SessionState.create(bsz, device=home),
                             devices)
    for t in range(T):
        st_u, (nal, nal_len, _wp, _bits, ovf) = step(st_u, offs[t].to(home))
        p_u, t_u, e_u = batch.compact_batch_nal(nal, nal_len, cap)
        st_s, outs = sharded(st_s, batch.shard_batch(offs[t], devices))
        p_s, t_s, e_s = batch.compact_sharded_nal(
            [o[0] for o in outs], [o[1] for o in outs], cap, home)
        _check(not (ovf.any() or e_u or e_s), f"egress ring step {t}: overflow")
        _check(torch.equal(t_u, t_s) and torch.equal(p_u, p_s),
               f"egress ring step {t}: packed bytes differ")

    # 3. The fresh-donor rows step, one different donor per session.
    rng = np.random.default_rng(11)
    payloads = []
    for _ in range(bsz):
        g = fixtures.representative_donor_grid(rng, 2, 2)
        bw = BitWriter()
        mbt.emit_p_slice_mbs(bw, g, 1)
        bw.write_trailing_bits()
        payloads.append(bw.getvalue())

    def fresh_wire(payloads, device):
        dn, _meta = splice_device.prepare_donor_rows_serving(
            payloads, [0] * len(payloads), 2, 2, 1, 2, s_row=64,
            device=device)
        return dn

    fstep = batch.make_batched_splice_step_rows(
        cfg, 1, 1, 2, 2, num_refs=2, has_align=True, compact_x=True)
    args = _header(cfg, bsz, home) + _background(cfg, bsz, home)
    f_u = fstep(*args, fresh_wire(payloads, home))
    _same_frames("fresh-donor rows step", f_u, batch.gather_batch(
        batch.run_on_blocks(fstep, devices, *_blocks(args, devices),
                            _wires(fresh_wire, payloads, devices)), home))
    return {"run_frames": bsz, "egress ring": bsz * T,
            "fresh-donor rows step": bsz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run every serving program sharded over the devices "
                    "against unsharded; exits non-zero on a difference.")
    ap.add_argument("--device", action="append",
                    help="a device of the list (repeat the flag); default "
                         "every card, or cuda:0 twice on a one-card machine")
    args = ap.parse_args(argv)
    devices = args.device
    if not devices:
        count = torch.cuda.device_count()
        devices = ([f"cuda:{i}" for i in range(count)] if count > 1
                   else ["cuda:0", "cuda:0"])
    report = dryrun_multigpu(devices)
    print(f"dryrun_multigpu over {devices}: sharded == unsharded on "
          f"{report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
