"""Structural stream verifier — the conformance oracle.

Copied unchanged from h264_scroll_encoder_tpu/verify.py (it has no
framework dependency): the port's own structural oracle, which runs where
jax is absent (the card's machine).

The reference tests by decoding its output with ffmpeg
(SURVEY.md §4: `ffmpeg -v error -i out -f null -` as the pass/fail
oracle, trans_resizer.c:2176-2186).  This module provides the
equivalent check natively, with no decoder installed:

  - Annex-B walk: start codes, forbidden bit, known NAL types
  - SPS/PPS parse (+ geometry extraction)
  - slice-header parse for every slice
  - full CAVLC macroblock-grammar parse of every slice (I and P),
    requiring the payload to end exactly at rbsp_trailing_bits
  - decoder-side MV-field reconstruction of P slices with hardware
    MV-limit checks (|mv_y| <= 512 px, the NVDEC class limit the whole
    waypoint design exists for)

Used by tests and the `verify-stream` CLI.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models import mb_transcode as mbt
from .models import mv_field
from .models.splice import parse_slice_header
from .ops.bitio import BitReader
from .syntax import parse


@dataclasses.dataclass
class VerifyReport:
    ok: bool
    nal_count: int = 0
    frame_count: int = 0
    i_slices: int = 0
    p_slices: int = 0
    skipped_mbs: int = 0
    coded_mbs: int = 0
    max_abs_mv_y_px: float = 0.0
    bytes_per_frame: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)

    def error(self, msg: str) -> None:
        self.ok = False
        self.errors.append(msg)

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)


def verify_stream(data: bytes, *, mv_limit_px: int = 512,
                  strict_trailing: bool = True,
                  strict_mv: bool = False) -> VerifyReport:
    rep = VerifyReport(ok=True)
    sps = pps = None
    mbw = mbh = 0
    pending: list = []

    for unit in parse.iter_nal_units(data):
        rep.nal_count += 1
        t = unit.nal_unit_type
        if t == 7:
            try:
                sps = parse.parse_sps(unit.rbsp)
                mbw, mbh = sps.width // 16, sps.height // 16
            except Exception as e:  # noqa: BLE001
                rep.error(f"SPS parse failed: {e}")
        elif t == 8:
            try:
                pps = parse.parse_pps(unit.rbsp)
            except Exception as e:  # noqa: BLE001
                rep.error(f"PPS parse failed: {e}")
        elif t in (1, 5):
            if sps is None or pps is None:
                rep.error(f"slice NAL #{rep.nal_count} before SPS/PPS")
                continue
            # Group MB-row-aligned slices into frames: first_mb == 0
            # starts a frame, further slices extend it.
            br = BitReader(unit.rbsp)
            try:
                hdr = parse_slice_header(
                    br, is_idr=(t == 5), nal_ref_idc=unit.nal_ref_idc,
                    log2_max_frame_num=sps.log2_max_frame_num,
                    pps_num_ref_idx_l0_default=(
                        pps.num_ref_idx_l0_default_active_minus1 + 1))
            except Exception as e:  # noqa: BLE001
                rep.error(f"slice header parse failed: {e}")
                continue
            if hdr.first_mb == 0:
                _flush_frame(pending, mbw, mbh, rep, mv_limit_px,
                             strict_trailing, strict_mv)
                pending.clear()
            elif not pending:
                rep.error(f"slice with first_mb {hdr.first_mb} without a "
                          f"frame start")
                continue
            pending.append((unit, hdr, br.bit_position))
        elif t in (6, 9):
            pass  # SEI / AUD: tolerated
        else:
            rep.error(f"unexpected NAL type {t}")

    _flush_frame(pending, mbw, mbh, rep, mv_limit_px, strict_trailing,
                 strict_mv)
    if rep.frame_count == 0:
        rep.error("no frames")
    return rep


def _flush_frame(slices, mbw, mbh, rep, mv_limit_px, strict_trailing,
                 strict_mv):
    if not slices:
        return
    rep.frame_count += 1
    rep.bytes_per_frame.append(sum(len(u.data) + 5 for u, _, _ in slices))
    try:
        _verify_frame(slices, mbw, mbh, rep, mv_limit_px, strict_trailing,
                      strict_mv)
    except Exception as e:  # noqa: BLE001
        rep.error(f"frame {rep.frame_count}: {e}")


def _verify_frame(slices, mbw, mbh, rep, mv_limit_px, strict_trailing,
                  strict_mv):
    starts = [hdr.first_mb for _, hdr, _ in slices]
    ends = starts[1:] + [mbw * mbh]
    for (unit, hdr, data_bit), start, end in zip(slices, starts, ends):
        rows = (end - start) // mbw
        if rows <= 0 or start % mbw or (end - start) % mbw:
            rep.error(f"frame {rep.frame_count}: slice at first_mb "
                      f"{start} is not MB-row aligned")
            return
        br = BitReader(unit.rbsp)
        br.skip_bits(data_bit)

        if hdr.is_i:
            rep.i_slices += 1
            mbt.parse_i_slice_mbs(br, mbw, rows)
            rep.coded_mbs += mbw * rows
        elif hdr.is_p:
            rep.p_slices += 1
            grid = mbt.parse_p_slice_mbs(br, mbw, rows, hdr.num_ref_idx_l0)
            skips = sum(1 for row in grid for mb in row if mb is mbt.SKIP)
            rep.skipped_mbs += skips
            rep.coded_mbs += mbw * rows - skips
            # Spatial prediction never crosses slice boundaries, so the
            # MV field reconstructs per slice band.
            field = mv_field.decode_p_slice_mv_field(grid, mbw, rows)
            inter = field.ref >= 0
            if inter.any():
                max_y = np.abs(field.mvy[inter]).max() / 4.0
                rep.max_abs_mv_y_px = max(rep.max_abs_mv_y_px, float(max_y))
                if max_y > mv_limit_px:
                    # Grammar-valid but hardware decoders glitch; the C
                    # composer itself emits these for the B region at
                    # offsets below height-496 (defect documented in
                    # docs/KNOWN_ISSUES_ANALYSIS.md).
                    report = (rep.error if strict_mv else rep.warn)
                    report(f"frame {rep.frame_count}: |mv_y| {max_y:.0f}px "
                           f"exceeds the {mv_limit_px}px hardware decoder "
                           f"limit")
        else:
            rep.error(f"frame {rep.frame_count}: unsupported slice type "
                      f"{hdr.slice_type}")
            return

        remaining = len(unit.rbsp) * 8 - br.bit_position
        if strict_trailing and not 0 < remaining <= 8:
            rep.error(
                f"frame {rep.frame_count}: {remaining} bits after last MB "
                f"(expected 1..8 for rbsp_trailing_bits)")


def nal_diff(ours: bytes, ref: bytes) -> str:
    """NAL-by-NAL comparison report (the BASELINE north star's diff tool:
    'NAL-level diff + conformance decode of every emitted stream')."""
    ours_units = list(parse.iter_nal_units(ours))
    ref_units = list(parse.iter_nal_units(ref))
    lines = [f"ours: {len(ours_units)} NALs, ref: {len(ref_units)} NALs"]
    for i, (a, b) in enumerate(zip(ours_units, ref_units)):
        same = a.data == b.data and a.nal_unit_type == b.nal_unit_type
        if not same:
            first = next((j for j, (x, y) in enumerate(zip(a.data, b.data))
                          if x != y), min(len(a.data), len(b.data)))
            lines.append(
                f"  NAL {i}: type {a.nal_unit_type}/{b.nal_unit_type} "
                f"size {len(a.data)}/{len(b.data)} first-diff@{first}")
    return "\n".join(lines)


def verify_cli(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    ap = argparse.ArgumentParser(
        prog="verify-stream",
        description="Structural conformance check of an H.264 Annex-B "
                    "stream (native ffmpeg-oracle replacement)")
    ap.add_argument("stream")
    ap.add_argument("--mv-limit", type=int, default=512)
    ap.add_argument("--lenient-trailing", action="store_true")
    args = ap.parse_args(argv)

    rep = verify_stream(Path(args.stream).read_bytes(),
                        mv_limit_px=args.mv_limit,
                        strict_trailing=not args.lenient_trailing)
    print(json.dumps({
        "ok": rep.ok,
        "nals": rep.nal_count,
        "frames": rep.frame_count,
        "i_slices": rep.i_slices,
        "p_slices": rep.p_slices,
        "coded_mbs": rep.coded_mbs,
        "skipped_mbs": rep.skipped_mbs,
        "max_abs_mv_y_px": rep.max_abs_mv_y_px,
        "mean_bytes_per_p_frame": (
            round(float(np.mean(rep.bytes_per_frame[2:])), 1)
            if len(rep.bytes_per_frame) > 2 else None),
        "errors": rep.errors[:20],
        "warnings": rep.warnings[:10],
    }))
    return 0 if rep.ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(verify_cli())
