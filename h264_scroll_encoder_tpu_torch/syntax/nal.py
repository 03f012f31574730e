"""Annex-B NAL unit assembly (host path).

Copied unchanged from h264_scroll_encoder_tpu/syntax/nal.py (it has no
framework dependency), so the port runs where jax is absent.

Byte-parity target: nal_write_unit (src/nal.c:52-84) — start code, NAL
header byte (forbidden|ref_idc|type), RBSP->EBSP payload.

The device hot path does NAL framing inside the jitted frame pipeline
(models/scroll.py); this host version serves headers/setup frames and tests.
"""

from __future__ import annotations

import numpy as np

from ..ops.ebsp import rbsp_to_ebsp_np


def nal_header_byte(nal_ref_idc: int, nal_type: int) -> int:
    return ((nal_ref_idc & 0x03) << 5) | (nal_type & 0x1F)


def write_nal_unit(rbsp: bytes, nal_ref_idc: int, nal_type: int,
                   long_startcode: bool = True) -> bytes:
    start = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    header = bytes([nal_header_byte(nal_ref_idc, nal_type)])
    ebsp = rbsp_to_ebsp_np(np.frombuffer(rbsp, np.uint8)).tobytes()
    return start + header + ebsp


class AnnexBWriter:
    """Accumulates NAL units into one Annex-B stream (NALWriter equivalent)."""

    def __init__(self):
        self._chunks: list[bytes] = []

    def write_nal_unit(self, rbsp: bytes, nal_ref_idc: int, nal_type: int,
                       long_startcode: bool = True) -> int:
        data = write_nal_unit(rbsp, nal_ref_idc, nal_type, long_startcode)
        self._chunks.append(data)
        return len(data)

    def append_raw(self, data: bytes) -> None:
        """Append pre-framed Annex-B bytes (e.g. device-packed frames)."""
        self._chunks.append(bytes(data))

    def getvalue(self) -> bytes:
        return b"".join(self._chunks)

    @property
    def size(self) -> int:
        return sum(len(c) for c in self._chunks)
