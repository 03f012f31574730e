"""Minimal ISO-BMFF (MP4) muxer for Annex-B H.264 streams.

Port of h264_scroll_encoder_tpu/utils/mp4mux.py (pure host code; its
output is the JAX package's, byte for byte).  The reference leaves muxing
to ffmpeg ("ffmpeg -i out.h264 -c:v copy output.mp4", src/main.c:136-137;
scripts/netflix_scroll.sh adds -movflags faststart).  This is a native
single-video-track progressive MP4 writer: Annex-B NALs are grouped into
access units, converted to AVCC length-prefixed samples, and wrapped in
ftyp + moov (avc1/avcC sample entry, uniform timing, IDR sync table) +
mdat, with moov before mdat (faststart layout).

    python -m h264_scroll_encoder_tpu_torch.utils.mp4mux IN.h264 OUT.mp4
"""

from __future__ import annotations

import struct

import numpy as np

from ..syntax import parse


def _box(kind: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payloads)


def _avcc(sps: bytes, pps: bytes) -> bytes:
    profile, compat, level = sps[1], sps[2], sps[3]
    return _box(
        b"avcC",
        bytes([1, profile, compat, level, 0xFF, 0xE1]),
        struct.pack(">H", len(sps)), sps,
        bytes([1]), struct.pack(">H", len(pps)), pps,
    )


def _avc1(width: int, height: int, sps: bytes, pps: bytes) -> bytes:
    return _box(
        b"avc1",
        bytes(6), struct.pack(">H", 1),            # reserved, data_ref_idx
        bytes(16),                                  # pre_defined/reserved
        struct.pack(">HH", width, height),
        struct.pack(">II", 0x00480000, 0x00480000),  # 72 dpi
        bytes(4), struct.pack(">H", 1),             # reserved, frame_count
        bytes(32),                                  # compressorname
        struct.pack(">H", 0x18), struct.pack(">h", -1),
        _avcc(sps, pps),
    )


def annexb_to_samples(stream: bytes):
    """Group NALs into access units; returns (sps, pps, samples, sync).

    Each slice NAL (type 1/5) closes an access unit; parameter sets are
    hoisted into avcC.  Samples are AVCC (4-byte length prefix per NAL);
    `sync` lists the 1-based sample numbers of the IDR frames.
    """
    sps = pps = None
    samples: list = []
    sync: list = []
    for unit in parse.iter_nal_units(stream):
        t = unit.nal_unit_type
        header = bytes([(unit.nal_ref_idc << 5) | t])
        payload = header + unit.data
        if t == 7:
            sps = sps or payload
        elif t == 8:
            pps = pps or payload
        elif t in (1, 5):
            samples.append(struct.pack(">I", len(payload)) + payload)
            if t == 5:
                sync.append(len(samples))
    if sps is None or pps is None:
        raise ValueError("stream missing SPS/PPS")
    return sps, pps, samples, sync


def mux(stream: bytes, fps: int = 30) -> bytes:
    """Annex-B H.264 -> progressive MP4 bytes (moov-first)."""
    sps_nal, pps_nal, samples, sync = annexb_to_samples(stream)
    info = parse.parse_sps(parse.ebsp_to_rbsp_np(
        np.frombuffer(sps_nal[1:], np.uint8)).tobytes())
    width, height = info.width, info.height

    n = len(samples)
    timescale = fps
    duration = n

    stts = _full_box(b"stts", 0, 0, struct.pack(">I", 1),
                     struct.pack(">II", n, 1))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">I", 1),
                     struct.pack(">III", 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     b"".join(struct.pack(">I", len(s)) for s in samples))
    stss = _full_box(b"stss", 0, 0, struct.pack(">I", len(sync)),
                     b"".join(struct.pack(">I", s) for s in sync))
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1),
                     _avc1(width, height, sps_nal, pps_nal))

    # The mdat offset: everything before it is ftyp + moov.
    def moov_with_offset(chunk_offset: int) -> bytes:
        stco = _full_box(b"stco", 0, 0, struct.pack(">I", 1),
                         struct.pack(">I", chunk_offset))
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stss, stco)
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(
            b"dref", 0, 0, struct.pack(">I", 1),
            _full_box(b"url ", 0, 1)))
        minf = _box(b"minf", vmhd, dinf, stbl)
        mdhd = _full_box(b"mdhd", 0, 0,
                         struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                     0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12),
                         b"VideoHandler\x00")
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        tkhd = _full_box(
            b"tkhd", 0, 7,
            struct.pack(">IIII", 0, 0, 1, 0),
            struct.pack(">I", duration), bytes(8),
            struct.pack(">HHHH", 0, 0, 0, 0),
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000),
            struct.pack(">II", width << 16, height << 16))
        trak = _box(b"trak", tkhd, mdia)
        mvhd = _full_box(
            b"mvhd", 0, 0,
            struct.pack(">IIII", 0, 0, timescale, duration),
            struct.pack(">IH", 0x00010000, 0x0100), bytes(10),
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000),
            bytes(24), struct.pack(">I", 2))
        return _box(b"moov", mvhd, trak)

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isomiso2avc1mp41")
    mdat_payload = b"".join(samples)
    # moov's size does not depend on the offset value (fixed-size stco).
    probe = moov_with_offset(0)
    mdat_offset = len(ftyp) + len(probe) + 8
    moov = moov_with_offset(mdat_offset)
    if len(moov) != len(probe):
        raise AssertionError("moov size changed with the mdat offset")
    return ftyp + moov + _box(b"mdat", mdat_payload)


def mux_cli(argv=None) -> int:
    import argparse
    from pathlib import Path

    ap = argparse.ArgumentParser(
        prog="mux-mp4", description="Wrap an Annex-B H.264 stream in MP4 "
                                    "(native; no ffmpeg needed)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--fps", type=int, default=30)
    args = ap.parse_args(argv)
    data = mux(Path(args.input).read_bytes(), fps=args.fps)
    Path(args.output).write_bytes(data)
    print(f"wrote {len(data)} bytes to {args.output}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(mux_cli())
