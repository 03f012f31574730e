"""K1 cut off after each stage of its chain, timed (P1).

Port of scripts/emit_stage_probe.py.  The JAX probe times truncated
variants of the fused emit Pallas program; here P1 (ops/probes
`emit_stage_batch`, csrc/probe_kernels.cu) cuts K1 itself after each
stage of its Hopper chain, on K1's block, plan and shared memory:

  launch  an empty body on K1's grid and shared memory
  stage   + the cp.async staging of the symbols
  scan    + the position scan
  pack    + place_run into the words
  ep      + trailing bits, prefix and emulation prevention (no copy-out)
  full    K1

each ending in a write that depends on everything before it.  A stage's
share is its time less the stage before it.  Timing: utils/timing
`chained_ms` (the JAX probes' chain: the input perturbed by the last
step's checksum, outputs checksummed in the chain, CUDA events), and on
the card each stage's device time per call alone (utils/timing
`device_ms`), from which the shares come: the chain's checksum sums each
stage's own outputs, which differ from stage to stage.

Shapes: the JAX probe's own input (8,483 symbols, widths 0-8, seed 1, at
the representative splice budget), then the 720p main paths' shapes:
compact splice at B and 4B, scroll and partitioned frames at B,
and K1's cluster plan: the dense frame of I_PCM-bearing donors at B / 8
(B = 256 by default; 4 blocks a session) and the 5120x3200 hint frame at
B = 1 (16).  On the card each row also has K1's blocks a session, its
symbols per thread and its resident blocks per SM at that shape.

    python -m h264_scroll_encoder_tpu_torch.scripts.emit_stage_probe \
        [--batch B] [--steps S] [--reps R] [--shapes a,b] [--device cpu]
"""

from __future__ import annotations

import sys

from .. import _kernels, cases
from ..config import ComposerConfig
from ..ops import emit_fused, probes
from ..utils import timing
from . import _probe_common as common

SHAPES = ("probe", "splice", "splice_4b", "scroll", "partitioned",
          "dense_ipcm", "hint_5120")


def shape_inputs(names, args, dev) -> dict:
    """{label: (patterns, nbits, nal_ref_idc, n_rbsp, kwargs)} of K1's
    inputs at the named shapes."""
    cfg = ComposerConfig(1280, 720)
    B = args.batch
    out = {}
    if "probe" in names:
        pat, nb = common.probe_symbols(B, dev)
        out[f"probe n=8483 B={B}"] = (pat, nb, 0, common.rep_budget(args.engine),
                                      {"append_tb": True})
    if {"splice", "splice_4b"} & set(names):
        donors = common.splice_donors(args, dev)
        for name, b in (("splice", B), ("splice_4b", 4 * B)):
            if name in names:
                pat, nb, n_rbsp, align = common.splice_symbols(cfg, b, dev,
                                                               donors)
                out[f"splice compact B={b}"] = (pat, nb, 0, n_rbsp, {
                    "align": align, "append_tb": True})
    for name, policy in (("scroll", "floor"), ("partitioned", "partitioned")):
        if name in names:
            pat, nb, idc, n_rbsp = common.scroll_symbols(cfg, B, dev, policy)
            out[f"{name} B={B}"] = (pat, nb, idc, n_rbsp, {"append_tb": True})
    if "dense_ipcm" in names:
        b = max(B // 8, 1)
        pat, nb, n_rbsp = common.dense_ipcm_symbols(cfg, b, dev, args)
        out[f"dense I_PCM B={b} (cluster plan)"] = (pat, nb, 0, n_rbsp, {
            "align": True, "append_tb": True})
    if "hint_5120" in names:
        pat, nb, n_rbsp, _kw = cases.large_emit_inputs(
            dev, names=("hint_5120x3200",))["hint_5120x3200"]
        out["hint 5120x3200 B=1 (cluster plan)"] = (pat, nb, 0, n_rbsp, {
            "append_tb": True})
    return out


def k1_launch(pat, n_rbsp) -> dict:
    """K1's blocks a session, symbols per thread and resident blocks per
    SM at these symbols, on its plan."""
    n = pat.shape[1]
    n_nal = emit_fused.nal_bytes(n_rbsp, common.CAP)
    c, k = emit_fused.launch_geometry(
        lambda: _kernels.emit_plan(pat.element_size(), n,
                                   emit_fused.items_per_thread(n), n_nal),
        n, None)
    return {"k1_cluster": c, "k1_items_per_thread": k,
            "k1_blocks_per_sm": _kernels.blocks_per_sm(
                "h264t_emit_blocks_per_sm", pat.element_size(), k, n_nal, c)}


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0], donors=True)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=f"comma-separated subset of {','.join(SHAPES)}")
    args = ap.parse_args(argv)
    names = [s for s in args.shapes.split(",") if s]
    unknown = set(names) - set(SHAPES)
    if unknown:
        ap.error(f"unknown shapes {sorted(unknown)}")
    dev = common.device_of(args)
    rows = {}
    for label, (pat, nb, idc, n_rbsp, kw) in shape_inputs(names, args,
                                                          dev).items():
        ms = {}
        for stage in probes.EMIT_STAGES:
            ms[stage] = common.chained(
                lambda p, stage=stage: probes.emit_stage_batch(
                    stage, p, nb, idc, n_rbsp, common.CAP, **kw), pat, args)
        row = {"n": pat.shape[1], "n_rbsp": n_rbsp,
               "k": emit_fused.items_per_thread(pat.shape[1]), "ms": ms}
        split = ms
        if dev.type == "cuda":
            # The chain's checksum sums each stage's own outputs (the
            # words of `pack`, the NAL of `full`), so the shares come from
            # the stages' device time per call alone.
            row["device_ms"] = split = {
                stage: timing.device_ms(
                    lambda stage=stage: probes.emit_stage_batch(
                        stage, pat, nb, idc, n_rbsp, common.CAP, **kw))
                for stage in probes.EMIT_STAGES}
            row.update(k1_launch(pat, n_rbsp))
        order = probes.EMIT_STAGES
        row["share_ms"] = shares = {"launch": split["launch"]}
        shares.update({b: split[b] - split[a] for a, b in zip(order, order[1:])})
        rows[label] = row
        print(f"{label}: n={row['n']} n_rbsp={n_rbsp} k={row['k']} chained "
              + " ".join(f"{s} {ms[s]:.5f}" for s in order)
              + " ms/step; shares " + " ".join(
                  f"{s} {shares[s]:+.5f}" for s in order), flush=True)
    common.table("emit_stage_probe", dev, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
