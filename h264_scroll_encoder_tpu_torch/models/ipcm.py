"""I_PCM atlas / test-mode frame generation.

Copied unchanged from h264_scroll_encoder_tpu/models/ipcm.py (it has no
framework dependency), so the port runs where jax is absent.

Byte-parity targets: h264_write_ipcm_mb and the I_PCM frame family
(experiments/scroll-encoder/src/h264_encoder.c:730-918): IDR / non-IDR
I-frames as solid color, 3-stripe, or per-MB-row color, plus the raw-YUV
variant the reference declares but never implements
(include/h264_encoder.h:210-217 — grep-verified unimplemented there).

I_PCM layout: mb_type ue(25) [9 bits], pcm_alignment_zero_bits, then 384 raw
bytes (256 Y + 64 Cb + 64 Cr).  After the first macroblock's alignment the
stream is byte-aligned and every subsequent MB is exactly 2 header bytes
(0x0D 0x00 = ue(25) + 7 pad bits) + 384 sample bytes, so frame assembly is a
single numpy concatenation rather than 11M bit-writes per 720p frame.
"""

from __future__ import annotations

import numpy as np

from ..config import (ComposerConfig, NAL_REF_IDC_HIGHEST, NAL_TYPE_IDR,
                      NAL_TYPE_SLICE)
from ..ops.bitio import BitWriter
from ..syntax.nal import write_nal_unit
from ..syntax.slice_headers import (write_idr_slice_header,
                                    write_non_idr_i_slice_header)

# ue(25) = '000011010' (9 bits) followed by 7 alignment zeros when the MB
# starts byte-aligned.
_MB_HEADER_ALIGNED = bytes([0x0D, 0x00])


def mb_samples_solid(y: int, cb: int, cr: int) -> np.ndarray:
    """384 raw I_PCM bytes for a solid-color MB (256 Y + 64 Cb + 64 Cr)."""
    out = np.empty(384, np.uint8)
    out[:256] = y
    out[256:320] = cb
    out[320:384] = cr
    return out


def _ipcm_payload(cfg: ComposerConfig, header_writer, row_colors) -> bytes:
    """Slice RBSP: header + all-I_PCM MBs with per-row colors.

    row_colors: (mb_height, 3) uint8 array of (y, cb, cr) per MB row, or a
    callable (mb_x, mb_y) -> 384-byte sample array for arbitrary content.
    """
    bw = BitWriter()
    header_writer(bw)

    mbw, mbh = cfg.mb_width, cfg.mb_height

    if callable(row_colors):
        samples = np.stack([
            row_colors(x, y) for y in range(mbh) for x in range(mbw)])
    else:
        row_colors = np.asarray(row_colors, np.uint8)
        per_row = np.stack([
            mb_samples_solid(*row_colors[y]) for y in range(mbh)])
        samples = np.repeat(per_row, mbw, axis=0)  # (mbh*mbw, 384) row-major

    # First MB: ue(25) + alignment through the serial writer.
    bw.write_ue(25)
    bw.align_zero()
    bw.write_bytes_aligned(samples[0])

    # Remaining MBs start aligned: bulk-assemble [0x0D 0x00 | 384 bytes].
    n_rest = mbw * mbh - 1
    if n_rest:
        block = np.empty((n_rest, 386), np.uint8)
        block[:, 0] = 0x0D
        block[:, 1] = 0x00
        block[:, 2:] = samples[1:]
        bw.write_bytes_aligned(block.reshape(-1))

    bw.write_trailing_bits()
    return bw.getvalue()


def _yuv_sampler(cfg: ComposerConfig, yuv: np.ndarray):
    """Per-MB sample extractor from a raw YUV420p frame buffer."""
    w, h = cfg.width, cfg.height
    yuv = np.asarray(yuv, np.uint8).reshape(-1)
    expect = w * h + 2 * (w // 2) * (h // 2)
    if yuv.size != expect:
        raise ValueError(f"YUV420p buffer must be {expect} bytes, got {yuv.size}")
    yp = yuv[: w * h].reshape(h, w)
    up = yuv[w * h: w * h + (w // 2) * (h // 2)].reshape(h // 2, w // 2)
    vp = yuv[w * h + (w // 2) * (h // 2):].reshape(h // 2, w // 2)

    def sample(mb_x: int, mb_y: int) -> np.ndarray:
        yy = yp[mb_y * 16:(mb_y + 1) * 16, mb_x * 16:(mb_x + 1) * 16]
        uu = up[mb_y * 8:(mb_y + 1) * 8, mb_x * 8:(mb_x + 1) * 8]
        vv = vp[mb_y * 8:(mb_y + 1) * 8, mb_x * 8:(mb_x + 1) * 8]
        return np.concatenate([yy.reshape(-1), uu.reshape(-1), vv.reshape(-1)])

    return sample


def _solid_rows(cfg: ComposerConfig, y, cb, cr):
    return np.tile(np.array([[y, cb, cr]], np.uint8), (cfg.mb_height, 1))


def _striped_rows(cfg: ComposerConfig, c1, c2, c3):
    """3 horizontal stripes by MB row thirds (h264_encoder.c:817-825)."""
    third = cfg.mb_height // 3
    rows = np.empty((cfg.mb_height, 3), np.uint8)
    for y in range(cfg.mb_height):
        rows[y] = c1 if y < third else (c2 if y < 2 * third else c3)
    return rows


def idr_frame(cfg: ComposerConfig, row_colors) -> bytes:
    """IDR I_PCM frame NAL (long_term_reference_flag=1, frame_num=0)."""
    rbsp = _ipcm_payload(cfg, lambda bw: write_idr_slice_header(bw, cfg),
                         row_colors)
    return write_nal_unit(rbsp, NAL_REF_IDC_HIGHEST, NAL_TYPE_IDR)


def non_idr_i_frame(cfg: ComposerConfig, frame_num: int, row_colors) -> bytes:
    """Non-IDR I_PCM frame NAL (MMCO marks long-term idx 1)."""
    rbsp = _ipcm_payload(
        cfg, lambda bw: write_non_idr_i_slice_header(bw, cfg, frame_num),
        row_colors)
    return write_nal_unit(rbsp, NAL_REF_IDC_HIGHEST, NAL_TYPE_SLICE)


def idr_frame_color(cfg, y, cb, cr):
    return idr_frame(cfg, _solid_rows(cfg, y, cb, cr))


def non_idr_i_frame_color(cfg, frame_num, y, cb, cr):
    return non_idr_i_frame(cfg, frame_num, _solid_rows(cfg, y, cb, cr))


def idr_frame_striped(cfg, c1, c2, c3):
    return idr_frame(cfg, _striped_rows(cfg, c1, c2, c3))


def non_idr_i_frame_striped(cfg, frame_num, c1, c2, c3):
    return non_idr_i_frame(cfg, frame_num, _striped_rows(cfg, c1, c2, c3))


def idr_frame_yuv(cfg, yuv):
    """IDR I_PCM frame from raw YUV420p (implements the API the reference
    declares at include/h264_encoder.h:210-217 but never implements)."""
    return idr_frame(cfg, _yuv_sampler(cfg, yuv))


def non_idr_i_frame_yuv(cfg, frame_num, yuv):
    return non_idr_i_frame(cfg, frame_num, _yuv_sampler(cfg, yuv))
