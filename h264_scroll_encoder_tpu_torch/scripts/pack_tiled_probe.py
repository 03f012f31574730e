"""P3 (K2 with T sessions a block) against K2.

Port of scripts/pack_tiled_probe.py.  The JAX probe tiles T sessions into
one Pallas program instance to amortise a program instance's fixed cost,
and races the tiled kernel against the shipped one at the serving shapes
after a bit-exactness check.  P3 (ops/probes `pack_place_tiled_batch`,
csrc/probe_kernels.cu) runs K2's pack_session for T sessions a block,
each on threads / T threads under its own barrier, with k chosen per T so
that the block fits in shared memory.

First the exactness check: the JAX probe's B = 16 case (widths 0-8, seed
5, 400 zero-width symbols in session 0 and 100 of 32 bits in session 1;
2,048 words) at every T, against K2 (on the card) and K2's plain
version, and the refusal of B % T != 0.  Then T = 1, 2, 4, 8 and 16
against K2 on the JAX probe's input at B and 4B: the chained time per
step and, on the card, the device time per call alone, k and resident
blocks per SM.

    python -m h264_scroll_encoder_tpu_torch.scripts.pack_tiled_probe \
        [--batch B] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _kernels
from ..ops import bitpack_flat, emit_fused, probes
from ..utils import timing
from . import _probe_common as common

NUM_WORDS = 2048


def exact_case(n: int = common.PROBE_SYMBOLS):
    """The JAX probe's check (pack_tiled_probe.check_exact): 16 sessions,
    seed 5: int32 numpy (patterns, nbits) [16, n], the symbol stages'
    widths."""
    rng = np.random.default_rng(5)
    B = 16
    nb = rng.integers(0, 9, size=(B, n)).astype(np.int32)
    nb[0, rng.integers(0, n, 400)] = 0
    nb[1, rng.integers(0, n, 100)] = 32
    pat = rng.integers(0, 2 ** 31, size=(B, n)).astype(np.int32) & (
        (1 << np.clip(nb, 0, 31)) - 1)
    return pat, nb


def check_exact(dev) -> list:
    """P3 at every tile equals K2's plain version (and K2, on the card) on
    the JAX probe's case, and refuses a batch that T does not divide;
    returns the tiles checked."""
    p, b = (torch.as_tensor(a, device=dev) for a in exact_case())
    want = bitpack_flat.pack_words_place_plain(p, b, NUM_WORDS)
    got_k2 = bitpack_flat.pack_words_place_batch(p, b, NUM_WORDS)
    for tile in probes.TILES:
        got = probes.pack_place_tiled_batch(p, b, NUM_WORDS, tile)
        for name, out in ((f"P3 T={tile}", got), ("K2", got_k2)):
            for g, w in zip(out, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} differs from K2's plain "
                                         "version on the exact case")
    try:
        probes.pack_place_tiled_batch(p[:12], b[:12], NUM_WORDS, 8)
    except ValueError:
        pass
    else:
        raise AssertionError("P3 took B = 12 at T = 8")
    return list(probes.TILES)


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    tiles = check_exact(dev)
    print(f"exactness: T = {tiles} x 16 sessions: P3 == K2 == K2's plain "
          "version; B % T != 0 refused", flush=True)
    rows = {}
    for B in (args.batch, 4 * args.batch):
        pat, nb = common.probe_symbols(B, dev)
        row = {"k2_ms": common.chained(
            lambda p: bitpack_flat.pack_words_place_batch(p, nb, NUM_WORDS),
            pat, args), "tiles": {}}
        for tile in probes.TILES:
            if B % tile:
                continue
            t = {"ms": common.chained(
                lambda p, tile=tile: probes.pack_place_tiled_batch(
                    p, nb, NUM_WORDS, tile), pat, args)}
            if dev.type == "cuda":
                t["device_ms"] = timing.device_ms(
                    lambda tile=tile: probes.pack_place_tiled_batch(
                        pat, nb, NUM_WORDS, tile))
                t["k"] = probes.tiled_items(pat, NUM_WORDS, tile)
                t["blocks_per_sm"] = _kernels.blocks_per_sm(
                    "h264t_pack_tiled_blocks_per_sm", tile, pat.element_size(),
                    t["k"], NUM_WORDS)
            row["tiles"][str(tile)] = t
        if dev.type == "cuda":
            row["k2_device_ms"] = timing.device_ms(
                lambda: bitpack_flat.pack_words_place_batch(pat, nb, NUM_WORDS))
            k = emit_fused.items_per_thread(pat.shape[1])
            row["k2_blocks_per_sm"] = _kernels.blocks_per_sm(
                "h264t_pack_blocks_per_sm", pat.element_size(), k, NUM_WORDS, 1)
        rows[f"probe n=8483 B={B}"] = row
        print(f"B={B}: chained K2 {row['k2_ms']:.5f} ms; " + "; ".join(
            f"T={t} {v['ms']:.5f} ms ({v['ms'] / row['k2_ms'] - 1:+.1%})"
            + (f" device {v['device_ms']:.5f} ms k={v['k']} blocks/SM "
               f"{v['blocks_per_sm']}" if "k" in v else "")
            for t, v in row["tiles"].items())
            + (f"; device K2 {row['k2_device_ms']:.5f} ms"
               if "k2_device_ms" in row else ""), flush=True)
    common.table("pack_tiled_probe", dev, rows, exact_tiles=tiles)
    return 0


if __name__ == "__main__":
    sys.exit(main())
