"""CAVLC residual-block codec and nC context machinery (host reference).

Copied unchanged from h264_scroll_encoder_tpu/ops/cavlc.py (it has no
framework dependency), so the port runs where jax is absent.

Behavioral parity targets in the reference's trans-resizer experiment:
  - copy_cavlc_block            (trans_resizer.c:612-755)
  - decode_total_zeros          (:467-508)
  - decode_run_before           (:514-543)
  - read_coeff_token            (:549-606)
  - compute_luma_nC / chroma_nC (:782-873)

Design difference that matters: the reference can only *copy* blocks bit-
verbatim, which is valid there because its padding never changes any
block's nC class.  A true dynamic-rect splice (docs/MASTER_DESIGN.md
stitch algorithm) moves donor macroblocks to new neighbors, which can
change nC and therefore the coeff_token *table* — so this codec decodes
each block into (total_coeff, trailing_ones, nC-independent tail bits) and
re-encodes coeff_token under the repaired nC at emission time.  Everything
after coeff_token (T1 signs, levels, total_zeros, run_before) never
depends on nC and is copied verbatim.

This host implementation is the behavioral reference; the vectorized
device path lives in models/splice.py (nC recompute is a pure stencil over
per-block total_coeff grids).
"""

from __future__ import annotations

import dataclasses

from . import cavlc_tables as T
from .bitio import BitReader, BitWriter


class CAVLCError(ValueError):
    pass


@dataclasses.dataclass
class ResidualBlock:
    """One 4x4 (or chroma-DC 2x2) residual block.

    `tail` is the exact bit string following coeff_token (sign/level/
    total_zeros/run_before bits) — nC-independent, re-emitted verbatim.
    Decoded values are kept for verification and synthesis.
    """
    total_coeff: int
    trailing_ones: int
    tail: str
    levels: tuple      # all levels incl. trailing ones (decode order)
    total_zeros: int
    runs: tuple

    @property
    def empty(self) -> bool:
        return self.total_coeff == 0


EMPTY_BLOCK = ResidualBlock(0, 0, "", (), 0, ())


# ---------------------------------------------------------------------------
# Bit-string helpers over BitReader/BitWriter.
# ---------------------------------------------------------------------------

def _read_prefix_match(br: BitReader, decode_map: dict, what: str,
                       max_len: int = 20) -> tuple:
    """Read a prefix-free code by extending one bit at a time."""
    code = ""
    for _ in range(max_len):
        code += str(br.read_bit())
        if code in decode_map:
            return decode_map[code], code
    raise CAVLCError(f"no {what} code matches '{code}'")


def read_coeff_token(br: BitReader, nC: int) -> tuple:
    """-> (total_coeff, trailing_ones)."""
    cls = T.coeff_token_class(nC)
    if cls == "flc":
        code = br.read_bits(6)
        if code == 3:
            return 0, 0
        return (code >> 2) + 1, code & 3
    (tc, t1), _ = _read_prefix_match(
        br, T.coeff_token_decode_table(cls), f"coeff_token nC={nC}")
    return tc, t1


def write_coeff_token(bw: BitWriter, nC: int, tc: int, t1: int) -> None:
    code = T.coeff_token_code(nC, tc, t1)
    for b in code:
        bw.write_bit(int(b))


def _decode_total_zeros(br: BitReader, total_coeff: int,
                        max_coeff: int) -> int:
    if total_coeff >= max_coeff:
        return 0
    codes = T.total_zeros_codes(total_coeff, max_coeff)
    decode_map = {c: tz for tz, c in enumerate(codes)}
    tz, _ = _read_prefix_match(br, decode_map, "total_zeros")
    return tz


def _decode_run_before(br: BitReader, zeros_left: int) -> int:
    if zeros_left <= 0:
        return 0
    codes = T.run_before_codes(zeros_left)
    max_run = min(zeros_left, len(codes) - 1)
    decode_map = {c: r for r, c in enumerate(codes) if r <= max_run}
    run, _ = _read_prefix_match(br, decode_map, "run_before")
    return run


def read_residual_block(br: BitReader, nC: int,
                        max_coeff: int) -> ResidualBlock:
    """Full 9.2 residual_block_cavlc parse, recording the nC-independent
    tail bits for verbatim re-emission."""
    tc, t1 = read_coeff_token(br, nC)
    if tc == 0:
        return EMPTY_BLOCK

    tail_start = br.bit_position

    # Trailing-one signs.
    t1_levels = []
    for _ in range(t1):
        t1_levels.append(-1 if br.read_bit() else 1)

    # Levels (OpenH264 CavlcGetLevelVal algorithm; trans_resizer.c:640-704).
    levels = list(t1_levels)
    suffix_length = 1 if (tc > 10 and t1 < 3) else 0
    for i in range(tc - t1):
        prefix = 0
        while br.read_bit() == 0 and prefix < 16:
            prefix += 1
        if prefix > 15:
            raise CAVLCError(f"invalid level_prefix {prefix}")
        level_code = prefix << suffix_length
        suffix_size = suffix_length
        if prefix == 14 and suffix_length == 0:
            suffix_size = 4
        elif prefix == 15:
            suffix_size = 12
            if suffix_length == 0:
                level_code += 15
        if suffix_size:
            level_code += br.read_bits(suffix_size)
        if i == 0 and t1 < 3:
            level_code += 2
        level = (level_code // 2 + 1) if level_code % 2 == 0 \
            else -((level_code + 1) // 2)
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    total_zeros = _decode_total_zeros(br, tc, max_coeff)

    runs = []
    zeros_left = total_zeros
    for _ in range(tc - 1):
        if zeros_left <= 0:
            break
        run = _decode_run_before(br, zeros_left)
        runs.append(run)
        zeros_left -= run

    tail_end = br.bit_position
    # Extract the tail verbatim from the source buffer.
    saved = br.bit_position
    br._byte, br._bit = divmod(tail_start, 8)
    tail = "".join(str(br.read_bit()) for _ in range(tail_end - tail_start))
    br._byte, br._bit = divmod(saved, 8)

    return ResidualBlock(tc, t1, tail, tuple(levels), total_zeros,
                         tuple(runs))


def write_residual_block(bw: BitWriter, blk: ResidualBlock, nC: int) -> None:
    """Re-emit a block: coeff_token re-encoded for (possibly new) nC, tail
    copied verbatim.  This is the nC-context repair primitive."""
    write_coeff_token(bw, nC, blk.total_coeff, blk.trailing_ones)
    for b in blk.tail:
        bw.write_bit(int(b))


# ---------------------------------------------------------------------------
# Synthesis: encode a residual block from raw values (the donor-side
# encoder the reference never had — used for fixtures and for re-encoding).
# ---------------------------------------------------------------------------

def encode_residual_block(levels, total_zeros, runs, max_coeff: int,
                          nC: int) -> ResidualBlock:
    """Build a ResidualBlock (with canonical tail bits) from decode-order
    values.  `levels` includes trailing ones first (decode order = highest
    frequency first)."""
    tc = len(levels)
    if tc == 0:
        return EMPTY_BLOCK
    t1 = 0
    while t1 < min(3, tc) and abs(levels[t1]) == 1:
        t1 += 1
    if t1 < 3 and t1 < tc and abs(levels[t1]) < 2:
        raise CAVLCError("first non-T1 level must have |level| >= 2")

    bw = BitWriter()
    for lv in levels[:t1]:
        bw.write_bit(1 if lv < 0 else 0)

    suffix_length = 1 if (tc > 10 and t1 < 3) else 0
    for i, level in enumerate(levels[t1:]):
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if i == 0 and t1 < 3:
            level_code -= 2
        if suffix_length == 0:
            if level_code < 14:
                prefix, suffix = level_code, None
            elif level_code < 30:
                prefix, suffix = 14, (level_code - 14, 4)
            else:
                if level_code - 30 >= 4096:
                    raise CAVLCError("level too large to encode")
                prefix, suffix = 15, (level_code - 30, 12)
        else:
            if level_code < (15 << suffix_length):
                prefix = level_code >> suffix_length
                suffix = (level_code & ((1 << suffix_length) - 1),
                          suffix_length)
            else:
                if level_code - (15 << suffix_length) >= 4096:
                    raise CAVLCError("level too large to encode")
                prefix, suffix = 15, (level_code - (15 << suffix_length), 12)
        for _ in range(prefix):
            bw.write_bit(0)
        bw.write_bit(1)
        if suffix is not None:
            bw.write_bits(*suffix)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if tc < max_coeff:
        codes = T.total_zeros_codes(tc, max_coeff)
        if total_zeros >= len(codes):
            raise CAVLCError("total_zeros out of range")
        for b in codes[total_zeros]:
            bw.write_bit(int(b))

    zeros_left = total_zeros
    for run in runs:
        if zeros_left <= 0:
            raise CAVLCError("run_before with no zeros left")
        codes = T.run_before_codes(zeros_left)
        for b in codes[run]:
            bw.write_bit(int(b))
        zeros_left -= run

    # Serialize tail to a bit string.
    data = bw.getvalue()
    nbits = bw.bit_position
    tail = "".join(format(byte, "08b") for byte in data)[:nbits]
    return ResidualBlock(tc, t1, tail, tuple(levels), total_zeros,
                         tuple(runs))


# ---------------------------------------------------------------------------
# nC context: per-MB total_coeff grids and the neighbor-average rule
# (trans_resizer.c:782-873; H.264 9.2.1).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MBCoeffContext:
    """Per-MB total_coeff values: 16 luma 4x4 (raster order) + 2x4 chroma."""
    luma_tc: list = dataclasses.field(default_factory=lambda: [0] * 16)
    chroma_tc: list = dataclasses.field(
        default_factory=lambda: [[0] * 4, [0] * 4])


def luma_nC(blk_raster: int, cur: MBCoeffContext,
            left: MBCoeffContext | None, top: MBCoeffContext | None) -> int:
    """nC for a luma 4x4 block at raster index 0..15 within the MB."""
    row, col = divmod(blk_raster, 4)
    nA = nB = -1
    if col > 0:
        nA = cur.luma_tc[blk_raster - 1]
    elif left is not None:
        nA = left.luma_tc[row * 4 + 3]
    if row > 0:
        nB = cur.luma_tc[blk_raster - 4]
    elif top is not None:
        nB = top.luma_tc[12 + col]
    if nA >= 0 and nB >= 0:
        return (nA + nB + 1) >> 1
    if nA >= 0:
        return nA
    if nB >= 0:
        return nB
    return 0


def chroma_nC(plane: int, blk: int, cur: MBCoeffContext,
              left: MBCoeffContext | None, top: MBCoeffContext | None) -> int:
    """nC for a chroma AC 4x4 block (2x2 arrangement per plane)."""
    row, col = divmod(blk, 2)
    nA = nB = -1
    if col > 0:
        nA = cur.chroma_tc[plane][blk - 1]
    elif left is not None:
        nA = left.chroma_tc[plane][row * 2 + 1]
    if row > 0:
        nB = cur.chroma_tc[plane][blk - 2]
    elif top is not None:
        nB = top.chroma_tc[plane][2 + col]
    if nA >= 0 and nB >= 0:
        return (nA + nB + 1) >> 1
    if nA >= 0:
        return nA
    if nB >= 0:
        return nB
    return 0
