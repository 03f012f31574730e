"""On-card parity probe of the splice emit, and the pack race.

The counterpart of scripts/tpu_parity_probe.py, named for the card.  The
JAX probe checks on the TPU that the splice emit through the Mosaic
kernel is byte-identical with the XLA branch, on representative and dense
donors and on the static-chrome program, then races the Pallas pack
against the XLA merge tree.  Here, on the card:

  1. the splice emit (splice_device.emit_spliced_frame_rows at bench.py's
     geometry, a 23x23-MB donor at MB (30, 10) of a 720p frame, seed 7,
     B sessions) through K1 equals, byte for byte, K1's plain version on
     the same symbols, for a representative and a dense donor;
  2. the static-chrome program emits the same bytes;
  3. K2 (pack_words_place_batch) against its plain version at the scroll
     (7,250 symbols, 3,712-byte budget) and splice (8,483, 5,960) shapes
     of the JAX probe, widths 0-8, seed 1 (utils/timing.chained_ms).

    python -m h264_scroll_encoder_tpu_torch.scripts.gpu_parity_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import cases
from ..config import ComposerConfig
from ..models import splice_device
from ..ops import bitpack_flat, emit_fused
from ..utils import fixtures
from . import _probe_common as common

R = C = 23
R0, C0 = 10, 30


def parity(args, dev) -> dict:
    """{family: NAL bytes of session 0}: K1 == its plain version and the
    static-chrome program == the generic one, for each donor family."""
    cfg = ComposerConfig(1280, 720)
    rng = np.random.default_rng(7)
    inputs = cases.splice_session_inputs(cfg, args.batch, dev)
    out = {}
    for family, fab in (("representative", fixtures.representative_donor_grid),
                        ("dense", fixtures.dense_donor_grid)):
        dr = common.donor_rows(fab, rng, args.engine, R, C)
        dn = {k: v.expand(args.batch, *v.shape).contiguous()
              for k, v in splice_device.rows_device_arrays(dr, dev).items()}
        budget = splice_device.splice_rbsp_budget(cfg, R * C, dr.donor_bits,
                                                  bg_bits_per_mb=16)
        kw = {"has_align": bool(dr.has_align), "n_rbsp": budget}
        nal, nal_len, _bits, ovf = splice_device.emit_spliced_frame_rows(
            cfg, C0, R0, C, R, 2, *inputs, dn, **kw)
        pat, nb, n_rbsp = splice_device.rows_splice_symbols(
            cfg, C0, R0, R, C, 2, *inputs, dn, n_rbsp=budget)
        want = emit_fused.emit_nal_fused_plain(
            pat, nb, 0, n_rbsp, common.CAP, align=kw["has_align"],
            append_tb=True)
        static = splice_device.emit_spliced_frame_rows(
            cfg, C0, R0, C, R, 2, *inputs, dn, bg_static_skip=True, **kw)
        if bool(ovf.any()):
            raise AssertionError(f"{family}: the splice emit overflowed")
        for g, w in zip((nal, nal_len, _bits, ovf), want):
            if not torch.equal(g, w):
                raise AssertionError(f"{family}: K1 != its plain version")
        n = int(nal_len[0])
        if (not torch.equal(static[1], nal_len)
                or not torch.equal(static[0][:, :n], nal[:, :n])):
            raise AssertionError(f"{family}: static-chrome bytes differ")
        out[family] = n
        print(f"{family}: K1 == plain byte-identical ({n} B a session, "
              f"B={args.batch}); static-chrome identical", flush=True)
    return out


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--engine", default="native", choices=("native", "python"))
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = {"parity_bytes": parity(args, dev)}
    for n_sym, n_rbsp, tag in ((7250, 3712, "scroll-2slot"),
                               (8483, 5960, "splice-rep")):
        pat, nb = common.probe_symbols(args.batch, dev, n=n_sym)
        nw = n_rbsp // 4
        rows[tag] = {
            "plain_ms": common.chained(
                lambda p: bitpack_flat.pack_words_place_plain(p, nb, nw),
                pat, args),
            "k2_ms": common.chained(
                lambda p: bitpack_flat.pack_words_place_batch(p, nb, nw),
                pat, args)}
        print(f"{tag}: plain {rows[tag]['plain_ms']:.5f} ms  K2 "
              f"{rows[tag]['k2_ms']:.5f} ms / B={args.batch}", flush=True)
    common.table("gpu_parity_probe", dev, rows, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
