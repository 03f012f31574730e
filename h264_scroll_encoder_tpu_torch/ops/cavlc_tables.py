"""CAVLC code tables (H.264 spec Tables 9-4, 9-5, 9-7, 9-8, 9-10).

Copied unchanged from h264_scroll_encoder_tpu/ops/cavlc_tables.py (it
has no framework dependency), so the port runs where jax is absent.

These are standard constants — any conformant implementation carries the
same values (the reference embeds them at
experiments/trans-resizer/trans_resizer.c:275-461).  Here they are stored as
code *strings* grouped per VLC class, and compiled once into both decode
(prefix-match) and encode (value->code) directions, because the dynamic-rect
splice must re-encode coeff_token under a repaired nC while the reference
only ever copies bits verbatim.
"""

from __future__ import annotations

import functools

# --------------------------------------------------------------------------
# Table 9-5: coeff_token. Entries: (total_coeff, trailing_ones) -> code.
# Classes: 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8, nC == -1 (chroma DC).
# nC >= 8 uses a fixed 6-bit code handled in code (not a table).
# --------------------------------------------------------------------------

_COEFF_TOKEN_NC0 = """
0 0 1
1 0 000101      1 1 01
2 0 00000111    2 1 000100      2 2 001
3 0 000000111   3 1 00000110    3 2 0000101     3 3 00011
4 0 0000000111  4 1 000000110   4 2 00000101    4 3 000011
5 0 00000000111 5 1 0000000110  5 2 000000101   5 3 0000100
6 0 0000000001111 6 1 00000000110 6 2 0000000101 6 3 00000100
7 0 0000000001011 7 1 0000000001110 7 2 00000000101 7 3 000000100
8 0 0000000001000 8 1 0000000001010 8 2 0000000001101 8 3 0000000100
9 0 00000000001111 9 1 00000000001110 9 2 0000000001001 9 3 00000000100
10 0 00000000001011 10 1 00000000001010 10 2 00000000001101 10 3 0000000001100
11 0 000000000001111 11 1 000000000001110 11 2 00000000001001 11 3 00000000001100
12 0 000000000001011 12 1 000000000001010 12 2 000000000001101 12 3 00000000001000
13 0 0000000000001111 13 1 000000000000001 13 2 000000000001001 13 3 000000000001100
14 0 0000000000001011 14 1 0000000000001110 14 2 0000000000001101 14 3 000000000001000
15 0 0000000000000111 15 1 0000000000001010 15 2 0000000000001001 15 3 0000000000001100
16 0 0000000000000100 16 1 0000000000000110 16 2 0000000000000101 16 3 0000000000001000
"""

_COEFF_TOKEN_NC2 = """
0 0 11
1 0 001011      1 1 10
2 0 000111      2 1 00111       2 2 011
3 0 0000111     3 1 001010      3 2 001001      3 3 0101
4 0 00000111    4 1 000110      4 2 000101      4 3 0100
5 0 00000100    5 1 0000110     5 2 0000101     5 3 00110
6 0 000000111   6 1 00000110    6 2 00000101    6 3 001000
7 0 00000001111 7 1 000000110   7 2 000000101   7 3 000100
8 0 00000001011 8 1 00000001110 8 2 00000001101 8 3 0000100
9 0 000000001111 9 1 00000001010 9 2 00000001001 9 3 000000100
10 0 000000001011 10 1 000000001110 10 2 000000001101 10 3 00000001100
11 0 000000001000 11 1 000000001010 11 2 000000001001 11 3 00000001000
12 0 0000000001111 12 1 0000000001110 12 2 0000000001101 12 3 000000001100
13 0 0000000001011 13 1 0000000001010 13 2 0000000001001 13 3 0000000001100
14 0 0000000000111 14 1 00000000001011 14 2 0000000000110 14 3 0000000001000
15 0 00000000001001 15 1 00000000001000 15 2 00000000001010 15 3 0000000000001
16 0 00000000000111 16 1 00000000000110 16 2 00000000000101 16 3 00000000000100
"""

_COEFF_TOKEN_NC4 = """
0 0 1111
1 0 001111      1 1 1110
2 0 001011      2 1 01111       2 2 1101
3 0 001000      3 1 01100       3 2 01110       3 3 1100
4 0 0001111     4 1 01010       4 2 01011       4 3 1011
5 0 0001011     5 1 01000       5 2 01001       5 3 1010
6 0 0001001     6 1 001110      6 2 001101      6 3 1001
7 0 0001000     7 1 001010      7 2 001001      7 3 1000
8 0 00001111    8 1 0001110     8 2 0001101     8 3 01101
9 0 00001011    9 1 00001110    9 2 0001010     9 3 001100
10 0 000001111  10 1 00001010   10 2 00001101   10 3 0001100
11 0 000001011  11 1 000001110  11 2 00001001   11 3 00001100
12 0 000001000  12 1 000001010  12 2 000001101  12 3 00001000
13 0 0000001101 13 1 000000111  13 2 000001001  13 3 000001100
14 0 0000001001 14 1 0000001100 14 2 0000001011 14 3 0000001010
15 0 0000000101 15 1 0000001000 15 2 0000000111 15 3 0000000110
16 0 0000000001 16 1 0000000100 16 2 0000000011 16 3 0000000010
"""

_COEFF_TOKEN_CHROMA_DC = """
0 0 01
1 0 000111      1 1 1
2 0 000100      2 1 000110      2 2 001
3 0 000011      3 1 0000011     3 2 0000010     3 3 000101
4 0 000010      4 1 00000011    4 2 00000010    4 3 0000000
"""


def _parse_token_table(text: str) -> dict:
    """'tc t1 code ...' text -> {(tc, t1): code_str}."""
    toks = text.split()
    out = {}
    for i in range(0, len(toks), 3):
        tc, t1, code = int(toks[i]), int(toks[i + 1]), toks[i + 2]
        out[(tc, t1)] = code
    return out


@functools.lru_cache(maxsize=None)
def coeff_token_class(nC: int) -> str:
    if nC == -1:
        return "chroma_dc"
    if nC < 2:
        return "nc0"
    if nC < 4:
        return "nc2"
    if nC < 8:
        return "nc4"
    return "flc"


_TOKEN_TABLES = {
    "nc0": _parse_token_table(_COEFF_TOKEN_NC0),
    "nc2": _parse_token_table(_COEFF_TOKEN_NC2),
    "nc4": _parse_token_table(_COEFF_TOKEN_NC4),
    "chroma_dc": _parse_token_table(_COEFF_TOKEN_CHROMA_DC),
}


@functools.lru_cache(maxsize=None)
def coeff_token_decode_table(cls: str) -> dict:
    """{code_str: (tc, t1)} prefix-free decode map."""
    return {code: key for key, code in _TOKEN_TABLES[cls].items()}


def coeff_token_code(nC: int, tc: int, t1: int) -> str:
    """Encode coeff_token as a bit string for the given nC context."""
    cls = coeff_token_class(nC)
    if cls == "flc":
        # nC >= 8: 6-bit fixed code; tc==0 is the special value 3.
        if tc == 0:
            return format(3, "06b")
        return format(((tc - 1) << 2) | t1, "06b")
    return _TOKEN_TABLES[cls][(tc, t1)]


# --------------------------------------------------------------------------
# Tables 9-7 / 9-8: total_zeros.  Row = total_coeff, col = total_zeros.
# Stored as code strings; luma table covers maxNumCoeff 15/16 blocks,
# chroma-DC table covers maxNumCoeff 4.
# --------------------------------------------------------------------------

_TOTAL_ZEROS_4x4 = """
1: 1 011 010 0011 0010 00011 00010 000011 000010 0000011 0000010 00000011 00000010 000000011 000000010 000000001
2: 111 110 101 100 011 0101 0100 0011 0010 00011 00010 000011 000010 000001 000000
3: 0101 111 110 101 0100 0011 100 011 0010 00011 00010 000001 00001 000000
4: 00011 111 0101 0100 110 101 100 0011 011 0010 00010 00001 00000
5: 0101 0100 0011 111 110 101 100 011 0010 00001 0001 00000
6: 000001 00001 111 110 101 100 011 010 0001 001 000000
7: 000001 00001 101 100 011 11 010 0001 001 000000
8: 000001 0001 00001 011 11 10 010 001 000000
9: 000001 000000 0001 11 10 001 01 00001
10: 00001 00000 001 11 10 01 0001
11: 0000 0001 001 010 1 011
12: 0000 0001 01 1 001
13: 000 001 1 01
14: 00 01 1
15: 0 1
"""

_TOTAL_ZEROS_CHROMA_DC = """
1: 1 01 001 000
2: 1 01 00
3: 1 0
"""


def _parse_tz_table(text: str) -> dict:
    out = {}
    for line in text.strip().splitlines():
        head, _, rest = line.partition(":")
        out[int(head)] = rest.split()
    return out


TOTAL_ZEROS_4x4 = _parse_tz_table(_TOTAL_ZEROS_4x4)
TOTAL_ZEROS_CHROMA_DC = _parse_tz_table(_TOTAL_ZEROS_CHROMA_DC)


def total_zeros_codes(total_coeff: int, max_coeff: int) -> list:
    """List of code strings indexed by total_zeros value."""
    if max_coeff == 4:
        return TOTAL_ZEROS_CHROMA_DC[total_coeff]
    return TOTAL_ZEROS_4x4[total_coeff]


# --------------------------------------------------------------------------
# Table 9-10: run_before.  Row key = min(zerosLeft, 7), col = run_before.
# Row 7 extends with '000000001'... for runs 7..14.
# --------------------------------------------------------------------------

_RUN_BEFORE = {
    1: ["1", "0"],
    2: ["1", "01", "00"],
    3: ["11", "10", "01", "00"],
    4: ["11", "10", "01", "001", "000"],
    5: ["11", "10", "011", "010", "001", "000"],
    6: ["11", "000", "001", "011", "010", "101", "100"],
    7: ["111", "110", "101", "100", "011", "010", "001",
        "0001", "00001", "000001", "0000001", "00000001",
        "000000001", "0000000001", "00000000001"],
}


def run_before_codes(zeros_left: int) -> list:
    return _RUN_BEFORE[min(zeros_left, 7)]


# --------------------------------------------------------------------------
# Table 9-4: coded_block_pattern me(v) mappings, codeNum -> CBP.
# --------------------------------------------------------------------------

CBP_INTRA = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
]

CBP_INTER = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
]

# Inverse maps: CBP -> codeNum.
CBP_INTRA_INV = {cbp: code for code, cbp in enumerate(CBP_INTRA)}
CBP_INTER_INV = {cbp: code for code, cbp in enumerate(CBP_INTER)}

# 4x4 sub-block scan order within a macroblock: 8x8 blocks in Z-order,
# 4x4 within each 8x8 in Z-order -> raster indices.
SCAN_TO_RASTER = (0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15)
