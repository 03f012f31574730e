"""Host-side serial bit I/O for session setup, parsing, and testing.

Copied unchanged from h264_scroll_encoder_tpu/ops/bitio.py (it has no
framework dependency), so the port runs where jax is absent.

Behavioral equivalent of the reference BitWriter/BitReader
(src/bitwriter.c, include/bitwriter.h): MSB-first bit order, Exp-Golomb
ue/se, RBSP trailing bits, reads past EOF return 0.  This is *not* the hot
path — per-frame compose/pack runs on-device through ops/bitpack.py — it
serves the once-per-session paths (donor parsing, header assembly) and acts
as the differential oracle for the parallel packer in tests.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """MSB-first bit accumulator over a growable byte buffer."""

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0       # partial byte accumulator (LSB-justified)
        self._nbits = 0     # bits in accumulator, 0..7

    # -- core ---------------------------------------------------------------
    def write_bit(self, bit: int) -> None:
        self._cur = ((self._cur << 1) | (bit & 1)) & 0xFF
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        """Write the low n bits of value, MSB first (n in 1..32)."""
        value &= (1 << n) - 1
        # Fast path: fill the partial byte, then blast whole bytes.
        while n > 0 and self._nbits != 0:
            n -= 1
            self.write_bit((value >> n) & 1)
        if n == 0:
            return
        value &= (1 << n) - 1
        whole, rem = divmod(n, 8)
        if whole:
            self._bytes += (value >> rem).to_bytes(whole, "big")
        if rem:
            tail = value & ((1 << rem) - 1)
            self._cur = tail
            self._nbits = rem

    def write_ue(self, value: int) -> None:
        vp1 = value + 1
        m = vp1.bit_length() - 1
        self.write_bits(vp1, 2 * m + 1)

    def write_se(self, value: int) -> None:
        mapped = 2 * value - 1 if value > 0 else -2 * value
        self.write_ue(mapped)

    def write_te(self, value: int, num_values: int) -> None:
        """Truncated Exp-Golomb (ref_idx): 0/1/ue bits by range."""
        if num_values <= 1:
            return
        if num_values == 2:
            self.write_bit(1 - (value & 1))
        else:
            self.write_ue(value)

    def write_trailing_bits(self) -> None:
        self.write_bit(1)
        while self._nbits != 0:
            self.write_bit(0)

    def align_zero(self) -> None:
        """Zero-pad to the next byte boundary (pcm_alignment_zero_bit)."""
        while self._nbits != 0:
            self.write_bit(0)

    def write_bytes_aligned(self, data) -> None:
        """Bulk byte append; writer must be byte-aligned."""
        assert self._nbits == 0, "write_bytes_aligned requires alignment"
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._bytes += bytes(data)
        else:
            self._bytes += np.asarray(data, np.uint8).tobytes()

    # -- queries ------------------------------------------------------------
    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    @property
    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def getvalue(self) -> bytes:
        """Stream contents; a partial final byte is zero-padded
        (bitwriter_get_size semantics, src/bitwriter.c:124-131)."""
        out = bytes(self._bytes)
        if self._nbits:
            out += bytes([(self._cur << (8 - self._nbits)) & 0xFF])
        return out


class BitReader:
    """MSB-first bit reader; reads past EOF return 0 (src/bitwriter.c:152)."""

    def __init__(self, data):
        self._data = bytes(data)
        self._byte = 0
        self._bit = 0

    def read_bit(self) -> int:
        if self._byte >= len(self._data):
            return 0
        bit = (self._data[self._byte] >> (7 - self._bit)) & 1
        self._bit += 1
        if self._bit == 8:
            self._bit = 0
            self._byte += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_ue(self) -> int:
        lz = 0
        while self.read_bit() == 0 and lz < 32:
            lz += 1
        if lz == 0:
            return 0
        return (1 << lz) - 1 + self.read_bits(lz)

    def read_se(self) -> int:
        ue = self.read_ue()
        return (ue + 1) // 2 if (ue & 1) else -(ue // 2)

    def read_bytes_aligned(self, n: int) -> bytes:
        assert self._bit == 0
        out = self._data[self._byte:self._byte + n]
        self._byte += n
        return out

    def skip_bits(self, n: int) -> None:
        pos = self.bit_position + n
        self._byte, self._bit = divmod(pos, 8)

    def align(self) -> None:
        if self._bit:
            self._bit = 0
            self._byte += 1

    @property
    def bit_position(self) -> int:
        return self._byte * 8 + self._bit

    @property
    def byte_aligned(self) -> bool:
        return self._bit == 0

    @property
    def remaining_bits(self) -> int:
        return max(0, len(self._data) * 8 - self.bit_position)
