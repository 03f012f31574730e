"""The port's pixel oracle (pixel_oracle, ops/transform, ops/deblock) vs
the JAX package's, and the pixel checks of tests/test_pixel_oracle.py on
the port's own session streams.

Every stream is decoded by both oracles, which must give equal planes
(exact equality: the decode is integer arithmetic); the port's composed
scroll frames must reconstruct to the intended pixels outside the
floor/nearest policy's seam band, and exactly at MB-aligned offsets.
Sessions run on CPU tensors (the kernels' plain versions).
"""

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import pixel_oracle as jpo
from h264_scroll_encoder_tpu_torch import avref
from h264_scroll_encoder_tpu_torch import pixel_oracle as po
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                         MotionRegion)
from h264_scroll_encoder_tpu_torch.ops import deblock, transform
from h264_scroll_encoder_tpu_torch.session import ComposerSession
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)


def _session(w=64, h=128, **kw):
    s = ComposerSession(ComposerConfig(w, h), device="cpu", **kw)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    return s


def _assert_same_pictures(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(g, plane), getattr(w, plane))


def _stream(kind):
    if kind == "scroll":
        s = _session()
        for off in (0, 5, 16, 23, 100):
            s.write_scroll_frame(off)
    elif kind == "pskip_nearest":
        s = _session(enable_pskip=True, boundary_policy="nearest")
        for off in (4, 37, 64):
            s.write_scroll_frame(off)
    elif kind == "sliced":
        s = _session()
        for off in (0, 23, 64):
            s.write_scroll_frame_sliced(off, rows_per_slice=4)
    elif kind == "hint_splice":
        s = _session(w=160, h=128)
        s.write_hint_frame(FrameHints(motion_regions=(
            MotionRegion(1, 2, 3, 5, ref_idx=0, mv_x=0, mv_y=32),)))
        donor = fixtures.representative_donor_grid(
            np.random.default_rng(5), 4, 3)
        s.write_spliced_frame(FrameHints(motion_regions=(),
                                         dynamic_mb_x=3, dynamic_mb_y=2),
                              donor)
    else:
        raise ValueError(kind)
    return s.getvalue()


@pytest.mark.parametrize("kind", ["scroll", "pskip_nearest", "sliced",
                                  "hint_splice"])
def test_decode_matches_jax(kind):
    data = _stream(kind)
    _assert_same_pictures(po.decode_stream_pixels(data),
                          jpo.decode_stream_pixels(data))


def test_decode_of_x264_stream_matches_jax():
    """A real x264 stream (intra prediction, residuals, the in-loop
    deblocking filter: ops/transform and ops/deblock) decodes to the same
    planes in both oracles, and to libavcodec's."""
    if not avref.available():
        pytest.skip(f"avref unavailable: {avref.missing()}")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:96, :128]
    y = ((xx * 2 + yy) % 256 + rng.integers(0, 40, (96, 128))).astype(np.uint8)
    cb = np.full((48, 64), 110, np.uint8)
    cr = (128 + rng.integers(-20, 20, (48, 64))).astype(np.uint8)
    data = avref.encode_x264([(y, cb, cr), (y[::-1].copy(), cr, cb)], qp=28,
                             keyint=1, refs=1)
    got = po.decode_stream_pixels(data)
    _assert_same_pictures(got, jpo.decode_stream_pixels(data))
    av, nerrors = avref.decode_pictures(data)
    assert nerrors == 0
    _assert_same_pictures(got, av)


def test_transform_and_deblock_tables_match_jax():
    """The numpy copies keep the JAX modules' tables and entry points."""
    from h264_scroll_encoder_tpu.ops import deblock as jdb
    from h264_scroll_encoder_tpu.ops import transform as jxf

    for name in ("_ALPHA", "_BETA"):
        assert getattr(deblock, name) == getattr(jdb, name)
    for qp in (0, 17, 29, 51):
        for cqo in (-12, -2, 0, 5):
            assert transform.chroma_qp(qp, cqo) == jxf.chroma_qp(qp, cqo)
    rng = np.random.default_rng(1)
    for _ in range(8):
        coeffs = rng.integers(-40, 40, 16)
        qp = int(rng.integers(0, 52))
        np.testing.assert_array_equal(transform.residual_4x4(coeffs, qp),
                                      jxf.residual_4x4(coeffs, qp))


def _assert_scroll_frames(data, offsets, height, policy="floor"):
    pics = po.decode_stream_pixels(data)
    assert len(pics) == 2 + len(offsets)
    canvas = po.scroll_canvas(pics[0], pics[1])
    max_band = 0
    for pic, off in zip(pics[2:], offsets):
        intended = po.intended_scroll_luma(canvas, off, height)
        rows = po.luma_mismatch_rows(pic, intended)
        lo, hi = po.seam_band(height, off, policy)
        assert rows.size == 0 or (rows.min() >= lo and rows.max() < hi), (
            off, rows.min(), rows.max(), lo, hi)
        max_band = max(max_band, hi - lo)
        if off % 2 == 0:
            c_lo, c_hi = lo // 2, (hi + 1) // 2
            want = canvas.cb[off // 2: off // 2 + height // 2].astype(int)
            bad = np.nonzero((pic.cb.astype(int) != want).any(axis=1))[0]
            assert bad.size == 0 or (bad.min() >= c_lo - 1
                                     and bad.max() <= c_hi), (off, bad)
    return max_band


@pytest.mark.parametrize("policy,bound", [("floor", 15), ("nearest", 8)])
def test_scroll_pixels_policy(policy, bound):
    """The port's scroll frames equal the intended scroll window outside
    the policy's seam band, which is non-empty off MB multiples."""
    offsets = [0, 5, 16, 23, 37, 64, 100]
    s = _session(boundary_policy=policy)
    for off in offsets:
        s.write_scroll_frame(off)
    band = _assert_scroll_frames(s.getvalue(), offsets, 128, policy)
    assert 0 < band <= bound


def test_mb_aligned_scroll_pixel_exact():
    """Offsets at MB multiples have no seam: every pixel exact."""
    offsets = [0, 16, 48, 96, 112]
    s = _session()
    for off in offsets:
        s.write_scroll_frame(off)
    pics = po.decode_stream_pixels(s.getvalue())
    canvas = po.scroll_canvas(pics[0], pics[1])
    for pic, off in zip(pics[2:], offsets):
        assert po.luma_mismatch_rows(
            pic, po.intended_scroll_luma(canvas, off, 128)).size == 0
        assert (pic.cb == canvas.cb[off // 2: off // 2 + 64]).all()
        assert (pic.cr == canvas.cr[off // 2: off // 2 + 64]).all()
