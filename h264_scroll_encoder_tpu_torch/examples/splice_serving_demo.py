"""Batched dynamic-rect splice serving (BASELINE 'dynamic-rect splice').

Port of examples/splice_serving_demo.py.  Division of labour per frame:
  host: parse the donor slice (native C++ CAVLC engine) and flatten it to
        device symbol arrays (row chunks + token metadata);
  device: nC repair in the composite geometry, coeff_token re-encode,
        frame assembly, pack, emulation prevention — batched over
        sessions, K1 once per step.

    python -m h264_scroll_encoder_tpu_torch.examples.splice_serving_demo \
        [--device cuda|cpu] [--out-dir DIR]

--out-dir keeps the step's NALs (nal_<b>.bin) and the verified stream.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def run(device="cuda", *, batch_size: int = 8, out_dir=None,
        log=print) -> list:
    """One rows splice step over `batch_size` sessions of a 12x12-MB donor
    rect at MB (30, 10) of a 1280x720 frame; returns each session's NAL."""
    from ..config import ComposerConfig, MAX_WAYPOINTS
    from ..models import mb_transcode as mbt
    from ..models import splice_device
    from ..ops.bitio import BitWriter
    from ..parallel import batch
    from ..session import ComposerSession
    from ..syntax.slice_headers import p_slice_header_symbols
    from ..utils import fixtures
    from ..verify import verify_stream

    cfg = ComposerConfig(1280, 720)
    R = C = 12                      # 192x192 donor rect
    r0, c0 = 10, 30
    B = batch_size

    # Donor macroblocks (synthetic here; a real deployment feeds the
    # dynamic encoder's output through the native parser each frame).
    rng = np.random.default_rng(1)
    donor = fixtures.random_p_slice_grid(rng, C, R, 1)
    for row in donor:
        for i, mb in enumerate(row):
            if mb is not mbt.SKIP and mb.kind == "ipcm":
                row[i] = fixtures.random_inter_mb(rng, 1)

    # Serving-shaped ingest: the donor arrives as CAVLC slice payload
    # bytes; the native engine parses it, resolves composite nC/tokens,
    # pre-packs chunks and decodes the exact composite edge motion.
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, donor, 1)
    bw.write_trailing_bits()
    payload = bw.getvalue()
    t0 = time.perf_counter()
    dd = splice_device.prepare_donor_dense_from_slice(payload, 0, C, R, 1, 2)
    dr = splice_device.pack_donor_rows(dd, R, C)
    t_prep = time.perf_counter() - t0
    dn = splice_device.rows_device_arrays(dr, device)

    H, W = cfg.mb_height, cfg.mb_width
    zero = torch.zeros((B, H, W), dtype=torch.int32, device=device)
    zl = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32, device=device)
    hp, hn = p_slice_header_symbols(
        cfg, torch.full((B,), 3, dtype=torch.int32, device=device), 6,
        False, -1, 0, zl, zl.bool())

    step = batch.make_batched_splice_step_rows(
        cfg, c0, r0, C, R, num_refs=2, has_align=dr.has_align,
        n_rbsp=splice_device.splice_rbsp_budget(cfg, R * C, dr.donor_bits))
    args = (hp, hn, zero, zero, zero, zero.bool(),
            {k: v.unsqueeze(0).expand(B, *v.shape) for k, v in dn.items()})
    nal, nal_len, _bits, ovf = step(*args)
    if bool(ovf.any()):
        raise AssertionError("a spliced frame overflowed")
    t1 = time.perf_counter()
    nal, nal_len, _bits, ovf = step(*args)
    nal, sizes = nal.cpu().numpy(), nal_len.cpu().numpy()
    dt = time.perf_counter() - t1
    log(f"host donor prep: {t_prep * 1e3:.1f} ms; splice step of {B} "
        f"sessions on {device}: {dt * 1e3:.1f} ms; NAL sizes {sizes.tolist()}")
    nals = [nal[b, : sizes[b]].tobytes() for b in range(B)]

    # Verify one composed frame with the structural oracle.
    s = ComposerSession(cfg, device=device)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    s.frame_num = 3
    s.writer.append_raw(nals[0])
    rep = verify_stream(s.getvalue())
    if not rep.ok:
        raise AssertionError(f"spliced stream: {rep.errors}")
    log("spliced stream verifies OK")
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for b, data in enumerate(nals):
            (out / f"nal_{b}.bin").write_bytes(data)
        (out / "spliced.h264").write_bytes(s.getvalue())
    return nals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out-dir")
    args = ap.parse_args(argv)
    run(args.device, batch_size=args.batch, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
