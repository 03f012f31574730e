"""The fallback frame (MASTER_DESIGN §10) in the port's session, against
the JAX package's, and the port's avref against the JAX package's.

A schedule whose middle frame is unservable composes the same bytes in
both packages (x264 through each package's avref shim on the same system
libavcodec), decodes with 0 libavcodec errors, displays the fallback
frame as a standalone x264 encode of the same pixels, and keeps composing
against it as the fresh atlas; plus the error cases of
tests/test_fallback.py.  Sessions run on CPU tensors (the kernels' plain
versions; the fallback itself runs no kernel).  Every test skips where
`avref.available()` is false (the system libraries are missing).

Tolerance: exact equality of stream bytes and decoded planes.
"""

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import avref as javref
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu.session import ComposerSession as JaxSession
from h264_scroll_encoder_tpu_torch import avref
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                         HintsNotServable,
                                                         MotionRegion)
from h264_scroll_encoder_tpu_torch.session import ComposerSession

torch.set_num_threads(1)

W, H = 128, 96


@pytest.fixture(autouse=True)
def _needs_avref():
    if not avref.available():
        pytest.skip(f"avref unavailable: {avref.missing()}")


def _target_frame(seed=7):
    """The frame the UI wanted to show when hints broke: deterministic
    textured content at the session's dimensions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    y = ((xx * 255) // W + rng.integers(0, 24, (H, W))).astype(np.uint8)
    cb = (128 + (yy[::2, ::2] * 60) // H).astype(np.uint8)
    cr = (128 - (xx[::2, ::2] * 60) // W).astype(np.uint8)
    return y, cb, cr


def _sized_frame(cfg, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (cfg.height, cfg.width)).astype(np.uint8)
    cb = np.full((cfg.height // 2, cfg.width // 2), 100, np.uint8)
    cr = np.full((cfg.height // 2, cfg.width // 2), 150, np.uint8)
    return y, cb, cr


def _port_session(cfg=None):
    s = ComposerSession(cfg or ComposerConfig(W, H), device="cpu")
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    return s


def _schedule(s, hints, region):
    """servable hints, broken hints with the fallback frame, chrome, a
    band shifted 16 px; returns whether each took the fallback."""
    servable = hints(motion_regions=(region(0, 0, W // 16, H // 16,
                                            ref_idx=1),))
    # ref_idx 5 with no waypoints lies outside the active list.
    broken = hints(motion_regions=(region(0, 0, W // 16, H // 16,
                                          ref_idx=5),))
    shifted = hints(motion_regions=(region(0, 0, W // 16, 2, ref_idx=0,
                                           mv_x=0, mv_y=16),))
    return [s.write_hint_frame_or_fallback(servable),
            s.write_hint_frame_or_fallback(broken,
                                           fallback_frame=_target_frame()),
            s.write_hint_frame_or_fallback(hints(motion_regions=())),
            s.write_hint_frame_or_fallback(shifted)]


def test_fallback_midstream_matches_jax_and_is_pixel_correct():
    port = _port_session()
    took = _schedule(port, FrameHints, MotionRegion)
    assert took == [False, True, False, False]
    jax_s = JaxSession(JaxConfig(W, H))
    jax_s.write_parameter_sets()
    jax_s.write_test_atlases(striped=True)
    assert _schedule(jax_s, jsplice.FrameHints, jsplice.MotionRegion) == took
    data = port.getvalue()
    assert data == jax_s.getvalue()

    pics, nerrors = avref.decode_pictures(data)
    assert nerrors == 0
    # display order: atlas A, atlas B, servable, fallback, chrome, shifted
    assert len(pics) == 6
    standalone = avref.encode_x264([_target_frame()], qp=20, keyint=1, refs=1,
                                   extra_params="psy=0:chroma-qp-offset=0")
    ref, _ = avref.decode_pictures(standalone)
    fb = pics[3]
    for plane in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(fb, plane), getattr(ref[0], plane))
        np.testing.assert_array_equal(getattr(pics[4], plane), getattr(fb, plane))
    assert (pics[5].y[:32] == fb.y[16:48]).all()
    assert (pics[5].y[32:] == fb.y[32:]).all()


def test_fallback_requires_pixels():
    sess = _port_session()
    broken = FrameHints(motion_regions=(MotionRegion(0, 0, 2, 2, ref_idx=3),))
    with pytest.raises(HintsNotServable):
        sess.write_hint_frame_or_fallback(broken)


def test_fallback_rejects_wrong_dims():
    sess = _port_session()
    bad = (np.zeros((H // 2, W // 2), np.uint8),
           np.zeros((H // 4, W // 4), np.uint8),
           np.zeros((H // 4, W // 4), np.uint8))
    with pytest.raises(ValueError, match="session is"):
        sess.write_fallback_frame(bad)


def test_fallback_resets_waypoints():
    """The MMCO 4 marking truncates long-term indices >= 2: the session
    forgets its waypoint chain, and its bytes equal the JAX session's."""
    cfg = ComposerConfig(128, 1008)      # tall enough for a waypoint
    sess = _port_session(cfg)
    sess.write_scroll_frame(496)         # a waypoint and a scroll frame
    assert sess.waypoints.count == 1
    sess.write_fallback_frame(_sized_frame(cfg))
    assert sess.waypoints.count == 0
    sess.write_hint_frame(FrameHints(motion_regions=()))
    _, nerrors = avref.decode_pictures(sess.getvalue())
    assert nerrors == 0
    jax_s = JaxSession(JaxConfig(128, 1008))
    jax_s.write_parameter_sets()
    jax_s.write_test_atlases(striped=True)
    jax_s.write_scroll_frame(496)
    jax_s.write_fallback_frame(_sized_frame(cfg))
    jax_s.write_hint_frame(jsplice.FrameHints(motion_regions=()))
    assert sess.getvalue() == jax_s.getvalue()


def test_fallback_chroma_offset_mismatch_raises():
    """x264 told to use another chroma QP offset than the session's PPS
    cannot be compensated in the slice header."""
    sess = _port_session()
    with pytest.raises(ValueError, match="chroma_qp_index_offset"):
        sess.write_fallback_frame(_target_frame(),
                                  x264_params="chroma-qp-offset=3")


def test_avref_matches_jax():
    """The port's shim and the JAX package's: the same x264 bytes and the
    same decoded planes and error counts."""
    frames = [_target_frame(1), _target_frame(2)]
    data = avref.encode_x264(frames, qp=24, keyint=1, refs=1)
    assert data == javref.encode_x264(frames, qp=24, keyint=1, refs=1)
    got, ne = avref.decode_pictures(data)
    want, jne = javref.decode_pictures(data)
    assert ne == jne == 0 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(g, plane), getattr(w, plane))


def test_avref_reports_missing_libraries(monkeypatch):
    """Where the system libraries are missing, available() is False and
    missing() says why; build() raises with that reason."""
    import ctypes.util

    avref.missing.cache_clear()
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    try:
        assert avref.available() is False
        assert "libavcodec" in avref.missing()
        with pytest.raises(RuntimeError, match="libavcodec"):
            avref.build()
    finally:
        avref.missing.cache_clear()
