"""Plain H.264 writers of the benchmark's reference (no torch, no program).

Bits are kept as strings of '0' and '1' and turned into bytes once per
slice, which keeps the reference short and fast enough to run after a
window.  What is here is the syntax the benchmark's frames use (ITU-T
H.264, 7.3.3 slice header, 7.3.4 slice data, 7.3.5 macroblock layer,
9.2 CAVLC residuals, 7.4.1 emulation prevention):

  - Exp-Golomb ue/se/te and fixed-width fields;
  - the composer's P slice header: two long-term atlases and the
    session's waypoints in the reordered list, MMCO self-marking on a
    waypoint frame;
  - P_L0_16x16 macroblocks with CAVLC residuals, whose coeff_token is
    written under the nC of the macroblock's neighbours in the frame it
    is written into (9.2.1), and mb_skip_run over P_Skip macroblocks;
  - RBSP trailing bits, emulation prevention and Annex-B framing.
"""

from __future__ import annotations

import dataclasses

from . import cavlc_tables as T

SLICE_TYPE_P = 0
NAL_TYPE_SLICE = 1


@dataclasses.dataclass(frozen=True)
class Sps:
    """The sequence and picture parameters a slice header depends on."""
    width: int
    height: int
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb: int = 4
    deblocking_filter_control_present_flag: int = 1

    @property
    def mb_width(self) -> int:
        return self.width // 16

    @property
    def mb_height(self) -> int:
        return self.height // 16


class Bits:
    """An MSB-first bit string under construction."""

    def __init__(self):
        self.parts: list[str] = []

    def u(self, value: int, n: int) -> None:
        if n:
            self.parts.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def ue(self, value: int) -> None:
        code = format(value + 1, "b")
        self.parts.append("0" * (len(code) - 1) + code)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def te(self, value: int, num_refs: int) -> None:
        """ref_idx_l0 for a list of num_refs entries (9.1.2: cMax 1 is
        the inverted bit, larger ranges ue, a single entry nothing)."""
        if num_refs == 2:
            self.parts.append("0" if value else "1")
        elif num_refs > 2:
            self.ue(value)

    def raw(self, bits: str) -> None:
        self.parts.append(bits)

    def value(self) -> str:
        return "".join(self.parts)


def rbsp(bits: str) -> bytes:
    """Slice data bits + rbsp_trailing_bits as bytes."""
    bits += "1"
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def emulation_prevention(payload: bytes) -> bytes:
    """7.4.1: a 0x03 before any byte <= 3 that follows two zero bytes."""
    out = bytearray()
    zeros = 0
    for b in payload:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(payload: bytes, nal_ref_idc: int,
             nal_type: int = NAL_TYPE_SLICE) -> bytes:
    """Annex-B NAL: 4-byte start code, header byte, escaped payload."""
    return (b"\x00\x00\x00\x01" + bytes([(nal_ref_idc << 5) | nal_type])
            + emulation_prevention(payload))


def p_slice_header(bits: Bits, sps: Sps, frame_num: int, *,
                   waypoint_ltidx=(), self_mark: int = -1) -> None:
    """The composer's P slice header: the reference list reordered to the
    long-term atlases 0 and 1, then each waypoint's long-term index; a
    frame with `self_mark` >= 0 is a reference frame that marks itself
    long-term index `self_mark` (MMCO 4, 6, 0)."""
    bits.ue(0)                                  # first_mb_in_slice
    bits.ue(SLICE_TYPE_P)
    bits.ue(0)                                  # pic_parameter_set_id
    bits.u(frame_num, sps.log2_max_frame_num)
    if sps.pic_order_cnt_type == 0:
        bits.u(frame_num * 2, sps.log2_max_pic_order_cnt_lsb)
    bits.u(1, 1)                                # num_ref_idx_active_override
    bits.ue(len(waypoint_ltidx) + 1)            # num_ref_idx_l0_active_minus1
    bits.u(1, 1)                                # ref_pic_list_modification
    for lt in (0, 1, *waypoint_ltidx):
        bits.ue(2)                              # long_term_pic_num follows
        bits.ue(lt)
    bits.ue(3)
    if self_mark >= 0:                          # dec_ref_pic_marking
        bits.u(1, 1)
        for v in (4, self_mark + 1, 6, self_mark, 0):
            bits.ue(v)
    bits.se(0)                                  # slice_qp_delta
    if sps.deblocking_filter_control_present_flag:
        bits.ue(1)                              # deblocking filter off


# ---------------------------------------------------------------------------
# CAVLC residual blocks.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    """A residual block: total_coeff and trailing_ones, which coeff_token
    codes under the block's nC, and the bits after coeff_token (signs,
    levels, total_zeros, run_before), which do not depend on nC."""
    total_coeff: int
    trailing_ones: int
    tail: str


EMPTY = Block(0, 0, "")


def encode_block(levels, total_zeros: int, runs, max_coeff: int) -> Block:
    """9.2.2-9.2.4 from decode-order levels (trailing ones first)."""
    tc = len(levels)
    if tc == 0:
        return EMPTY
    t1 = 0
    while t1 < min(3, tc) and abs(levels[t1]) == 1:
        t1 += 1
    bits = Bits()
    for lv in levels[:t1]:
        bits.u(1 if lv < 0 else 0, 1)
    suffix_length = 1 if (tc > 10 and t1 < 3) else 0
    for i, level in enumerate(levels[t1:]):
        code = 2 * level - 2 if level > 0 else -2 * level - 1
        if i == 0 and t1 < 3:
            code -= 2
        if suffix_length == 0:
            if code < 14:
                prefix, suffix = code, None
            elif code < 30:
                prefix, suffix = 14, (code - 14, 4)
            else:
                prefix, suffix = 15, (code - 30, 12)
        elif code < (15 << suffix_length):
            prefix = code >> suffix_length
            suffix = (code & ((1 << suffix_length) - 1), suffix_length)
        else:
            prefix, suffix = 15, (code - (15 << suffix_length), 12)
        bits.raw("0" * prefix + "1")
        if suffix is not None:
            bits.u(*suffix)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1
    if tc < max_coeff:
        bits.raw(T.total_zeros_codes(tc, max_coeff)[total_zeros])
    zeros_left = total_zeros
    for run in runs:
        bits.raw(T.run_before_codes(zeros_left)[run])
        zeros_left -= run
    return Block(tc, t1, bits.value())


def write_block(bits: Bits, blk: Block, nC: int) -> None:
    bits.raw(T.coeff_token_code(nC, blk.total_coeff, blk.trailing_ones))
    bits.raw(blk.tail)


def _nc(n_a: int, n_b: int) -> int:
    """9.2.1: the mean of the available neighbours' total_coeff (-1 for
    one that is not available)."""
    if n_a >= 0 and n_b >= 0:
        return (n_a + n_b + 1) >> 1
    if n_a >= 0:
        return n_a
    return max(n_b, 0)


# ---------------------------------------------------------------------------
# Macroblocks and the P slice data.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InterMb:
    """A P_L0_16x16 macroblock: its MV difference, coded_block_pattern,
    QP delta and residual blocks (16 luma 4x4 in raster order, the two
    DC blocks, the 4 Cb and 4 Cr AC blocks)."""
    mvd: tuple
    cbp: int = 0
    qp_delta: int = 0
    luma: tuple = (EMPTY,) * 16
    cb_dc: Block = EMPTY
    cr_dc: Block = EMPTY
    chroma_ac: tuple = (EMPTY,) * 8


SKIP = None     # a P_Skip macroblock in a grid


class _Counts:
    """total_coeff of each written macroblock's blocks by MB address:
    16 luma 4x4 in raster order, then 4 Cb and 4 Cr AC blocks."""

    def __init__(self):
        self.of: dict = {}

    def nc(self, addr_a, addr_b, cur, raster: int) -> int:
        """nC of luma block `raster` of the current MB, whose counts so
        far are `cur`."""
        row, col = divmod(raster, 4)
        n_a = (cur[raster - 1] if col > 0 else
               self.of[addr_a][row * 4 + 3] if addr_a is not None else -1)
        n_b = (cur[raster - 4] if row > 0 else
               self.of[addr_b][12 + col] if addr_b is not None else -1)
        return _nc(n_a, n_b)

    def chroma_nc(self, addr_a, addr_b, cur, plane: int, blk: int) -> int:
        base = 16 + 4 * plane
        row, col = divmod(blk, 2)
        n_a = (cur[base + blk - 1] if col > 0 else
               self.of[addr_a][base + row * 2 + 1] if addr_a is not None
               else -1)
        n_b = (cur[base + blk - 2] if row > 0 else
               self.of[addr_b][base + 2 + col] if addr_b is not None
               else -1)
        return _nc(n_a, n_b)


def p_slice_data(bits: Bits, grid, num_refs: int, *, nc_of=None) -> None:
    """slice_data() of a P slice over `grid` (rows of InterMb or SKIP):
    mb_skip_run before each coded MB and at the end, each coded MB's
    mb_type P_L0_16x16, ref_idx 0, mvd, cbp and residual.  Each luma
    coeff_token is coded under the nC of the MB's left and upper
    neighbours in this grid, or, where `nc_of(row, col, raster)` is given
    and returns a value, under that one instead."""
    counts = _Counts()
    h, w = len(grid), len(grid[0])
    zero = [0] * 24
    run = 0
    for r in range(h):
        for c in range(w):
            mb = grid[r][c]
            if mb is SKIP:
                counts.of[(r, c)] = zero
                run += 1
                continue
            bits.ue(run)
            run = 0
            bits.ue(0)                          # mb_type P_L0_16x16
            bits.te(0, num_refs)
            bits.se(mb.mvd[0])
            bits.se(mb.mvd[1])
            bits.ue(T.CBP_INTER_INV[mb.cbp])
            cur = [0] * 24
            if mb.cbp:
                bits.se(mb.qp_delta)
                addr_a = (r, c - 1) if c > 0 else None
                addr_b = (r - 1, c) if r > 0 else None
                for i8 in range(4):
                    if not mb.cbp & (1 << i8):
                        continue
                    for i4 in range(4):
                        raster = T.SCAN_TO_RASTER[i8 * 4 + i4]
                        nc = counts.nc(addr_a, addr_b, cur, raster)
                        if nc_of is not None:
                            nc = nc_of(r, c, raster, nc)
                        blk = mb.luma[raster]
                        write_block(bits, blk, nc)
                        cur[raster] = blk.total_coeff
                cbp_chroma = (mb.cbp >> 4) & 3
                if cbp_chroma:
                    write_block(bits, mb.cb_dc, -1)
                    write_block(bits, mb.cr_dc, -1)
                if cbp_chroma == 2:
                    for plane in range(2):
                        for blk_i in range(4):
                            blk = mb.chroma_ac[4 * plane + blk_i]
                            write_block(bits, blk, counts.chroma_nc(
                                addr_a, addr_b, cur, plane, blk_i))
                            cur[16 + 4 * plane + blk_i] = blk.total_coeff
            counts.of[(r, c)] = cur
    if run:
        bits.ue(run)


def luma_ncs(grid) -> dict:
    """{(row, col, raster): nC} of every coded luma block of `grid` as a
    frame of its own: the nC each block's coeff_token was written under
    when the grid was encoded alone."""
    out = {}

    def record(r, c, raster, nc):
        out[(r, c, raster)] = nc
        return nc

    p_slice_data(Bits(), grid, 1, nc_of=record)
    return out
