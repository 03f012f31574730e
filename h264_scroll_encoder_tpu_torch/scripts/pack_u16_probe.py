"""P2 (K2 with 8-bit staged widths and 16-bit positions) against K2.

Port of scripts/pack_u16_probe.py.  The JAX probe clones the place
packer with uint16 offsets and move distances and races it against the
shipped kernel at the serving shapes, after a bit-exactness check.  P2
(ops/probes `pack_place_u16_batch`, csrc/probe_kernels.cu) is K2 with its
staging cut from 8 to 5 bytes a symbol and its position scan on one
32-bit sum a thread, whose bits above the 16 that address the kept
65,536 bits are the scan's carry-out.

First the exactness check: the JAX probe's eight cases (widths 0-8, seed
3, the last with 50 symbols of 32 bits; 2,048 words) and one whose total
passes 65,536 bits, P2 against K2 (both, on the card) and K2's plain
version.  Then P2 against K2 on the JAX probe's input (8,483 symbols,
2,048 words) and on the 720p compact splice symbols of the ebsp_exact
retry (K2's main-path input) at B and 4B: the chained time per step
(utils/timing.chained_ms) and, on the card, each kernel's device time per
call alone (utils/timing.device_ms) and resident blocks per SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor).

    python -m h264_scroll_encoder_tpu_torch.scripts.pack_u16_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _kernels
from ..config import ComposerConfig
from ..ops import bitpack, bitpack_flat, emit_fused, probes
from ..utils import timing
from . import _probe_common as common

NUM_WORDS = 2048  # the 8,192-byte serving budget


def exact_cases(n: int = common.PROBE_SYMBOLS):
    """The JAX probe's eight cases (pack_u16_probe.check_exact, seed 3),
    then one whose total passes 65,536 bits: [(patterns, nbits)] int32
    numpy rows [1, n], the symbol stages' widths."""
    rng = np.random.default_rng(3)
    out = []
    for trial in range(8):
        nb = rng.integers(0, 9, size=n).astype(np.int32)
        if trial == 7:
            nb[rng.integers(0, n, 50)] = 32
        pat = rng.integers(0, 2 ** 31, size=n).astype(np.int32) & (
            (1 << np.clip(nb, 0, 31)) - 1)
        out.append((pat[None], nb[None]))
    out.append(hostile_case(n))
    return out


def hostile_case(n: int = common.PROBE_SYMBOLS, seed: int = 9):
    """One session whose bits run past 65,536 (widths 4-16, full 32-bit
    patterns): P2 must drop what lies past 2,048 words, alias nothing
    into them and return the 32-bit total."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(4, 17, size=n).astype(np.int32)
    pat = (rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
           .view(np.int32))
    assert nb.sum() > 65_536
    return pat[None], nb[None]


def check_exact(dev) -> int:
    """P2 equals K2 (and K2's plain version) on every exact case; returns
    the number of cases."""
    cases_ = exact_cases()
    for i, (pat, nb) in enumerate(cases_):
        p, b = (torch.as_tensor(a, device=dev) for a in (pat, nb))
        want = bitpack_flat.pack_words_place_plain(p, b, NUM_WORDS)
        for name, got in (("P2", probes.pack_place_u16_batch(p, b, NUM_WORDS)),
                          ("K2", bitpack_flat.pack_words_place_batch(
                              p, b, NUM_WORDS))):
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} differs from K2's plain "
                                         f"version on exact case {i}")
    return len(cases_)


def inputs(args, dev) -> dict:
    """{label: (patterns, nbits, num_words)} of the race."""
    cfg = ComposerConfig(1280, 720)
    pat, nb = common.probe_symbols(args.batch, dev)
    out = {f"probe n=8483 B={args.batch}": (pat, nb, NUM_WORDS)}
    donors = common.splice_donors(args, dev)
    for b in (args.batch, 4 * args.batch):
        s_pat, s_nb, n_rbsp, _align = common.splice_symbols(cfg, b, dev, donors)
        tb_pat, tb_nb = bitpack.trailing_bits_symbol(
            s_nb.sum(dim=1, dtype=torch.int32))
        out[f"splice exact B={b}"] = (torch.cat([s_pat, tb_pat[:, None]], 1),
                                      torch.cat([s_nb, tb_nb[:, None]], 1),
                                      (n_rbsp + 3) // 4)
    return out


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], donors=True).parse_args(argv)
    dev = common.device_of(args)
    n_exact = check_exact(dev)
    print(f"exactness: {n_exact} cases (the JAX probe's 8, one past 65,536 "
          "bits): P2 == K2 == K2's plain version", flush=True)
    rows = {}
    for label, (pat, nb, nw) in inputs(args, dev).items():
        row = {"n": pat.shape[1], "num_words": nw,
               "k": emit_fused.items_per_thread(pat.shape[1]),
               "k2_ms": common.chained(
                   lambda p: bitpack_flat.pack_words_place_batch(p, nb, nw),
                   pat, args),
               "p2_ms": common.chained(
                   lambda p: probes.pack_place_u16_batch(p, nb, nw), pat, args)}
        if dev.type == "cuda":
            row["k2_device_ms"] = timing.device_ms(
                lambda: bitpack_flat.pack_words_place_batch(pat, nb, nw))
            row["p2_device_ms"] = timing.device_ms(
                lambda: probes.pack_place_u16_batch(pat, nb, nw))
            sym, k = pat.element_size(), row["k"]
            c, k2 = emit_fused.launch_geometry(
                lambda: _kernels.pack_plan(sym, pat.shape[1], k, nw),
                pat.shape[1], None)
            row["k2_blocks_per_sm"] = _kernels.blocks_per_sm(
                "h264t_pack_blocks_per_sm", sym, k2, nw, c)
            row["p2_blocks_per_sm"] = _kernels.blocks_per_sm(
                "h264t_pack_u16_blocks_per_sm", sym, k, nw)
        rows[label] = row
        print(f"{label}: chained K2 {row['k2_ms']:.5f} ms, P2 "
              f"{row['p2_ms']:.5f} ms ({row['p2_ms'] / row['k2_ms'] - 1:+.1%})"
              + (f"; device K2 {row['k2_device_ms']:.5f} ms, P2 "
                 f"{row['p2_device_ms']:.5f} ms; blocks per SM K2 "
                 f"{row['k2_blocks_per_sm']}, P2 {row['p2_blocks_per_sm']}"
                 if dev.type == "cuda" else ""), flush=True)
    common.table("pack_u16_probe", dev, rows, exact_cases=n_exact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
