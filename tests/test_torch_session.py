"""Port vs JAX: the per-session composer — Annex-B/SPS/PPS/slice parsing,
the host slice-header writers, I_PCM atlases, the donor IDR rewrite, the
host splice path, ComposerSession, the composer / scroll-encoder /
splice-demo CLIs and the stream verifier — at the sizes of the JAX
package's own tests (tests/test_cli.py, test_hints.py, test_robustness.py).
The port runs on the CPU (the kernels' plain versions).  Tolerance: none —
streams, bytes, return codes and reports are compared exactly."""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import cli as jcli
from h264_scroll_encoder_tpu import session as jsession
from h264_scroll_encoder_tpu import verify as jverify
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import ipcm as jipcm
from h264_scroll_encoder_tpu.models import rewrite as jrewrite
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu.ops import bitio as jbitio
from h264_scroll_encoder_tpu.syntax import parse as jparse
from h264_scroll_encoder_tpu.syntax import slice_headers as jheaders
from h264_scroll_encoder_tpu.utils import fixtures as jfixtures
from h264_scroll_encoder_tpu_torch import avref, cli, session, verify
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.models import ipcm, rewrite, scroll, splice
from h264_scroll_encoder_tpu_torch.ops import bitio
from h264_scroll_encoder_tpu_torch.syntax import parse, slice_headers
from h264_scroll_encoder_tpu_torch.syntax.nal import write_nal_unit
from h264_scroll_encoder_tpu_torch.syntax.params import generate_sps
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)

CFG_KW = [dict(), dict(pic_order_cnt_type=0, log2_max_pic_order_cnt_lsb=6,
                       deblocking_filter_control_present_flag=0,
                       log2_max_frame_num=5, idr_pic_id=3)]


def _cfgs(w, h, kw):
    return ComposerConfig(w, h, **kw), JaxConfig(w, h, **kw)


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.fixture
def jitted_jax_sliced(monkeypatch):
    """The JAX session calls scroll_frame_sliced without jit (5-30 s a
    frame on the CPU); jit the same function (same bytes) for the test."""
    eager = jscroll.scroll_frame_sliced

    @functools.lru_cache(maxsize=None)
    def compiled(cfg, **kw):
        return jax.jit(functools.partial(eager, cfg, **kw))

    monkeypatch.setattr(jscroll, "scroll_frame_sliced",
                        lambda cfg, *args, **kw: compiled(cfg, **kw)(*args))


def _sessions(w, h, **kw):
    """(port session on the CPU, JAX session) of one configuration."""
    return (session.ComposerSession(ComposerConfig(w, h), device="cpu", **kw),
            jsession.ComposerSession(JaxConfig(w, h), **kw))


# ---------------------------------------------------------------------------
# Parsing.
# ---------------------------------------------------------------------------

def test_iter_nal_units_and_start_codes():
    """Random payloads framed with 3- and 4-byte start codes, zero padding
    between units and a leading zero run."""
    rng = np.random.default_rng(1)
    chunks = [b"\x00\x00"]
    for k in range(40):
        chunks.append(b"\x00\x00\x00\x01" if k % 3 else b"\x00\x00\x01")
        body = rng.integers(0, 256, int(rng.integers(1, 60)), dtype=np.uint8)
        body[body < 4] = 7          # no start code inside a unit
        chunks.append(bytes([int(rng.integers(0, 128))]) + body.tobytes())
        chunks.append(b"\x00" * int(rng.integers(0, 3)))
    data = b"".join(chunks)
    arr = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(parse.find_start_codes(arr),
                                  jparse.find_start_codes(arr))
    got = [_asdict(u) for u in parse.iter_nal_units(data)]
    assert got == [_asdict(u) for u in jparse.iter_nal_units(data)]
    assert len(got) == 40
    assert list(parse.iter_nal_units(b"\x01\x02")) == []


@pytest.mark.parametrize("kw", CFG_KW, ids=["poc2", "poc0"])
def test_parse_parameter_sets_and_idr_header(kw):
    cfg, jcfg = _cfgs(96, 80, kw)
    s = session.ComposerSession(cfg, device="cpu")
    s.write_parameter_sets(level_idc=31)
    s.writer.append_raw(ipcm.idr_frame_color(cfg, 10, 20, 30))
    units = list(parse.iter_nal_units(s.getvalue()))
    assert [u.nal_unit_type for u in units] == [7, 8, 5]
    sps, pps, idr = (u.rbsp for u in units)
    assert _asdict(parse.parse_sps(sps)) == _asdict(jparse.parse_sps(sps))
    assert _asdict(parse.parse_pps(pps)) == _asdict(jparse.parse_pps(pps))
    args = dict(log2_max_frame_num=cfg.log2_max_frame_num,
                pic_order_cnt_type=cfg.pic_order_cnt_type,
                log2_max_pic_order_cnt_lsb=cfg.log2_max_pic_order_cnt_lsb,
                deblocking_filter_control_present_flag=(
                    cfg.deblocking_filter_control_present_flag))
    assert (_asdict(parse.parse_idr_slice_header(idr, **args))
            == _asdict(jparse.parse_idr_slice_header(idr, **args)))


def _sps_rbsp(profile, scaling=0, poc_type=2, interlaced=False):
    bw = bitio.BitWriter()
    bw.write_bits(profile, 8)
    bw.write_bits(0, 8)
    bw.write_bits(40, 8)
    bw.write_ue(0)
    if profile == 100:
        bw.write_ue(3)          # chroma_format_idc 4:4:4
        bw.write_bit(0)
        bw.write_ue(0)
        bw.write_ue(0)
        bw.write_bit(0)
        bw.write_bit(scaling)
    bw.write_ue(0)
    bw.write_ue(poc_type)
    if poc_type == 0:
        bw.write_ue(2)
    bw.write_ue(4)
    bw.write_bit(0)
    bw.write_ue(7)
    bw.write_ue(4)
    bw.write_bit(0 if interlaced else 1)
    if interlaced:
        bw.write_bit(1)
    bw.write_trailing_bits()
    return bw.getvalue()


@pytest.mark.parametrize("rbsp", [
    _sps_rbsp(100), _sps_rbsp(100, scaling=1), _sps_rbsp(66, poc_type=1),
    _sps_rbsp(66, poc_type=0, interlaced=True)],
    ids=["high", "scaling", "poc1", "interlaced"])
def test_parse_sps_profiles_and_rejections(rbsp):
    def outcome(mod):
        try:
            return _asdict(mod.parse_sps(rbsp))
        except mod.UnsupportedStream as e:
            return str(e)
    assert outcome(parse) == outcome(jparse)


def test_parse_pps_slice_groups_rejected():
    bw = bitio.BitWriter()
    for v in (0, 0):
        bw.write_ue(v)
    bw.write_bit(0)
    bw.write_bit(0)
    bw.write_ue(1)              # num_slice_groups_minus1
    bw.write_trailing_bits()
    with pytest.raises(parse.UnsupportedStream):
        parse.parse_pps(bw.getvalue())
    with pytest.raises(jparse.UnsupportedStream):
        jparse.parse_pps(bw.getvalue())


# ---------------------------------------------------------------------------
# Host slice-header writers.
# ---------------------------------------------------------------------------

P_HEADER_CASES = [
    (5, {}), (19, dict(is_reference=True, long_term_idx=4, num_waypoints=2,
                       wp_long_term_idx=[2, 3])),
    (7, dict(is_reference=True, slice_qp_delta=-3)),
    (33, dict(num_waypoints=1, wp_long_term_idx=[2], slice_qp_delta=5,
              prev_ref_abs_diff=3))]


@pytest.mark.parametrize("kw", CFG_KW, ids=["poc2", "poc0"])
def test_header_writers(kw):
    cfg, jcfg = _cfgs(64, 48, kw)

    def bits(fn, c, mod, *args, **kwargs):
        bw = mod.BitWriter()
        fn(bw, c, *args, **kwargs)
        return bw.getvalue(), bw.bit_position

    for frame_num, hkw in P_HEADER_CASES:
        assert (bits(slice_headers.write_p_slice_header, cfg, bitio, frame_num,
                     **hkw)
                == bits(jheaders.write_p_slice_header, jcfg, jbitio, frame_num,
                        **hkw))
    for flag in (0, 1):
        assert (bits(slice_headers.write_idr_slice_header, cfg, bitio, flag)
                == bits(jheaders.write_idr_slice_header, jcfg, jbitio, flag))
    for frame_num in (1, 9):
        assert (bits(slice_headers.write_non_idr_i_slice_header, cfg, bitio,
                     frame_num)
                == bits(jheaders.write_non_idr_i_slice_header, jcfg, jbitio,
                        frame_num))


def test_p_header_writer_equals_symbols():
    """The host writer and the batched symbol stream give the same bits."""
    cfg = ComposerConfig(64, 48)
    bw = bitio.BitWriter()
    slice_headers.write_p_slice_header(bw, cfg, 9, is_reference=True,
                                       long_term_idx=3, num_waypoints=1,
                                       wp_long_term_idx=[2])
    hp, hn = slice_headers.p_slice_header_symbols(
        cfg, torch.tensor([9]), torch.tensor([18]), True, 3, 1,
        torch.tensor([[2] + [0] * 7]), torch.tensor([[True] + [False] * 7]))
    bits = "".join(format(int(p), f"0{int(n)}b")[-int(n):] if n else ""
                   for p, n in zip(hp[0], hn[0]))
    want = "".join(format(b, "08b") for b in bw.getvalue())[:bw.bit_position]
    assert bits == want


# ---------------------------------------------------------------------------
# I_PCM atlases and the donor rewrite.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(64, 48), (96, 80)])
def test_ipcm_frames(w, h):
    cfg, jcfg = _cfgs(w, h, {})
    c = ((81, 90, 240), (145, 54, 34), (41, 240, 110))
    yuv = np.random.default_rng(w).integers(0, 256, w * h * 3 // 2,
                                            dtype=np.uint8)
    for fn, args in (("idr_frame_color", c[0]), ("idr_frame_striped", c),
                     ("idr_frame_yuv", (yuv,))):
        assert getattr(ipcm, fn)(cfg, *args) == getattr(jipcm, fn)(jcfg, *args)
    for fn, args in (("non_idr_i_frame_color", c[1]),
                     ("non_idr_i_frame_striped", c),
                     ("non_idr_i_frame_yuv", (yuv,))):
        assert (getattr(ipcm, fn)(cfg, 3, *args)
                == getattr(jipcm, fn)(jcfg, 3, *args))
    with pytest.raises(ValueError, match="YUV420p"):
        ipcm.idr_frame_yuv(cfg, yuv[:-1])


def _donor(kind: str):
    """(donor IDR RBSP, parse configs (port, JAX)): I_PCM macroblocks under
    a poc-0 config without deblocking control, or CAVLC intra macroblocks
    (fixtures.synthetic_cavlc_stream) under the configuration its SPS and
    PPS declare."""
    if kind == "ipcm":
        cfg, jcfg = _cfgs(64, 48, CFG_KW[1])
        data = ipcm.idr_frame_striped(cfg, (1, 2, 3), (90, 80, 70),
                                      (200, 100, 50))
        return next(parse.iter_nal_units(data)).rbsp, (cfg, jcfg)
    info = session._parse_reference_file(
        fixtures.synthetic_cavlc_stream(64, 48, n_p_frames=0, seed=4))
    sps, pps = info["sps"], info["pps"]
    cfgs = tuple(c.with_sps_params(sps.log2_max_frame_num,
                                   sps.pic_order_cnt_type,
                                   sps.log2_max_pic_order_cnt_lsb)
                 .with_pps_params(pps.num_ref_idx_l0_default_active_minus1,
                                  pps.deblocking_filter_control_present_flag)
                 for c in _cfgs(64, 48, {}))
    return info["idr_rbsp"], cfgs


@pytest.mark.parametrize("kind", ["ipcm", "cavlc"])
@pytest.mark.parametrize("mode", ["splice", "realign", "auto"])
def test_rewrite_donor_idr(kind, mode):
    """Donor IDR -> atlas A (IDR) and atlas B (non-IDR I) under the
    session's write config."""
    rbsp, (parse_cfg, jparse_cfg) = _donor(kind)
    write_cfg, jwrite_cfg = _cfgs(64, 48, {})
    assert (rewrite.rewrite_idr_frame(write_cfg, parse_cfg, rbsp, mode=mode)
            == jrewrite.rewrite_idr_frame(jwrite_cfg, jparse_cfg, rbsp,
                                          mode=mode))
    for kw in (dict(), dict(long_term_idx=0, max_long_term_plus1=1,
                            qp_delta_adjust=-4)):
        assert (rewrite.rewrite_as_non_idr_i_frame(
                    write_cfg, parse_cfg, rbsp, 5, mode=mode, **kw)
                == jrewrite.rewrite_as_non_idr_i_frame(
                    jwrite_cfg, jparse_cfg, rbsp, 5, mode=mode, **kw))


# ---------------------------------------------------------------------------
# The host splice path.
# ---------------------------------------------------------------------------

def _donor_grids(mbt_fixtures, seed=5):
    rng = np.random.default_rng(seed)
    grid = mbt_fixtures.random_p_slice_grid(rng, 4, 4, 1)
    for row in grid:
        for i, mb in enumerate(row):
            if mb is not None and mb.kind == "ipcm":
                row[i] = mbt_fixtures.random_inter_mb(rng, 1)
    return grid


def test_splice_host_path():
    """splice_p_frame + finalize_spliced_frame (with ref maps and MV
    retargeting), donor_mv_targets_from_grid, the I_PCM helpers and the
    slice-header transcode, against JAX."""
    cfg, jcfg = _cfgs(320, 240, {})
    grid, jgrid = _donor_grids(fixtures), _donor_grids(jfixtures)
    targets = splice.donor_mv_targets_from_grid(grid)
    assert targets == jsplice.donor_mv_targets_from_grid(jgrid)
    regions = ((0, 1, 20, 5, 0, 0, 32), (12, 10, 18, 14, 1, -8, 0))
    for ref_map, tgt, jtgt in (((0,), None, None), ((2,), targets, targets)):
        out = []
        for mod, c, g, t, bw_mod, hdr_mod in (
                (splice, cfg, grid, tgt, bitio, slice_headers),
                (jsplice, jcfg, jgrid, jtgt, jbitio, jheaders)):
            hints = mod.FrameHints(motion_regions=tuple(
                mod.MotionRegion(*r) for r in regions),
                dynamic_mb_x=8, dynamic_mb_y=6)
            g2 = mod.splice_p_frame(c, hints, g, 3, donor_ref_map=ref_map,
                                    donor_mv_targets=t)
            out.append(mod.finalize_spliced_frame(
                c, g2, 3, lambda bw, c=c, h=hdr_mod: h.write_p_slice_header(
                    bw, c, 6, num_waypoints=1, wp_long_term_idx=[2])))
        assert out[0] == out[1]
    with pytest.raises(ValueError, match="ref_idx"):
        splice.splice_p_frame(cfg, splice.FrameHints(motion_regions=(
            splice.MotionRegion(0, 0, 2, 2, ref_idx=3),)), None, 3)

    pic = type("Pic", (), {})()
    rng = np.random.default_rng(2)
    pic.y = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    pic.cb = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    pic.cr = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    rows = [[_asdict(mb) for mb in row]
            for row in splice.ipcm_grid_from_picture(pic, 1, 1, 2, 3)]
    assert rows == [[_asdict(mb) for mb in row]
                    for row in jsplice.ipcm_grid_from_picture(pic, 1, 1, 2, 3)]
    for first in (False, True):
        assert (_asdict(splice.ipcm_padding_mb(200, first))
                == _asdict(jsplice.ipcm_padding_mb(200, first)))

    stream = fixtures.synthetic_cavlc_stream(96, 96, n_p_frames=2, seed=9)
    for u in parse.iter_nal_units(stream):
        if u.nal_unit_type not in (1, 5):
            continue
        kw = dict(is_idr=u.nal_unit_type == 5, nal_ref_idc=u.nal_ref_idc,
                  log2_max_frame_num=4, pps_num_ref_idx_l0_default=2)
        h = splice.parse_slice_header(bitio.BitReader(u.rbsp), **kw)
        jh = jsplice.parse_slice_header(jbitio.BitReader(u.rbsp), **kw)
        assert _asdict(h) == _asdict(jh) and h.is_i == jh.is_i
        bw, jbw = bitio.BitWriter(), jbitio.BitWriter()
        splice.write_transcoded_slice_header(bw, h)
        jsplice.write_transcoded_slice_header(jbw, jh)
        assert bw.getvalue() == jbw.getvalue()


# ---------------------------------------------------------------------------
# ComposerSession.
# ---------------------------------------------------------------------------

SCROLL_OFFSETS = (0, 9, 23, 40, 100, 496, 500, 7, 250, 496, 16)


@pytest.mark.parametrize("policy,pskip", [("floor", False), ("nearest", True),
                                          ("partitioned", True)])
def test_session_scroll_streams(policy, pskip):
    """write_scroll_frame (waypoint first where needed) and
    write_scroll_or_waypoint_frame, with a pre-provisioned chain."""
    s, js = _sessions(64, 512, enable_pskip=pskip, boundary_policy=policy)
    for x in (s, js):
        x.write_parameter_sets()
        x.write_test_atlases(striped=policy != "nearest")
        for off in SCROLL_OFFSETS[:6]:
            x.write_scroll_frame(off)
        x.preprovision_waypoints()
        for off in SCROLL_OFFSETS[6:]:
            x.write_scroll_or_waypoint_frame(off)
    assert s.getvalue() == js.getvalue()
    assert (s.frame_num, s.frames_written) == (js.frame_num, js.frames_written)
    assert dataclasses.asdict(s.waypoints) == dataclasses.asdict(js.waypoints)
    assert verify.verify_stream(s.getvalue()).ok


def test_session_mixed_generators(tmp_path, jitted_jax_sliced):
    """Scroll, hint, sliced and spliced frames in one session (test_hints'
    mixed case plus sliced and successive-donor frames), and donor atlases
    through open_donor_session."""
    s, js = _sessions(320, 640)
    grids = (_donor_grids(fixtures), _donor_grids(jfixtures))
    for x, mod, grid in ((s, splice, grids[0]), (js, jsplice, grids[1])):
        x.write_parameter_sets()
        x.write_test_atlases(striped=True)
        x.preprovision_waypoints()
        for off in (0, 8):
            x.write_scroll_or_waypoint_frame(off)
        x.write_hint_frame(mod.FrameHints(motion_regions=(
            mod.MotionRegion(0, 1, 20, 5, ref_idx=2, mv_x=0, mv_y=24),)))
        x.write_scroll_frame_sliced(24, 8)
        sh = mod.FrameHints(motion_regions=(
            mod.MotionRegion(0, 1, 20, 5, ref_idx=0, mv_x=0, mv_y=32),),
            dynamic_mb_x=8, dynamic_mb_y=20)
        x.write_spliced_frame(sh, grid, as_reference=True, donor_slice_qp=30)
        x.write_spliced_frame(sh, grid, donor_refs_previous=True)
        x.write_scroll_or_waypoint_frame(16)
    assert s.getvalue() == js.getvalue()
    rep = verify.verify_stream(s.getvalue())
    assert rep.ok and not rep.warnings, (rep.errors, rep.warnings)
    with pytest.raises(ValueError, match="ref_idx"):
        s.write_hint_frame(splice.FrameHints(motion_regions=(
            splice.MotionRegion(0, 0, 2, 2, ref_idx=5),)))

    cfg = ComposerConfig(64, 512)
    for name, color in (("a", (81, 90, 240)), ("b", (41, 240, 110))):
        d = session.ComposerSession(cfg, device="cpu")
        d.write_parameter_sets()
        d.writer.append_raw(ipcm.idr_frame_color(cfg, *color))
        d.write_to_file(tmp_path / f"{name}.h264")
    a, b = tmp_path / "a.h264", tmp_path / "b.h264"
    ds = session.open_donor_session(a, b, enable_pskip=True, device="cpu")
    jds = jsession.open_donor_session(a, b, enable_pskip=True)
    assert dataclasses.astuple(ds.cfg) == dataclasses.astuple(jds.cfg)
    assert (dataclasses.astuple(ds.parse_cfg)
            == dataclasses.astuple(jds.parse_cfg))
    for x in (ds, jds):
        x.write_parameter_sets()
        x.write_donor_atlases(x._donor_a_rbsp, x._donor_b_rbsp,
                              rewrite_mode="splice")
        x.write_scroll_frame(31)
    assert ds.getvalue() == jds.getvalue()
    ref = session._parse_reference_file(a.read_bytes())
    jref = jsession._parse_reference_file(a.read_bytes())
    assert ref["idr_rbsp"] == jref["idr_rbsp"]
    with pytest.raises(ValueError, match="missing"):
        session._parse_reference_file(b"\x00\x00\x01\x09\x10")


def _lie(fn):
    """fn with every frame flagged as overflowing."""
    def wrapped(*args, **kw):
        nal, nal_len, bits, ovf = fn(*args, **kw)
        return nal, nal_len, bits, torch.ones_like(ovf)
    return wrapped


def test_session_retries_exact_path_then_raises(monkeypatch):
    """A flagged fast-path frame re-emits through the exact path (same
    bytes, tests/test_robustness.py's case); a frame the exact path flags
    too raises OverflowError, as does a sliced one."""
    def stream(lie=False):
        s = session.ComposerSession(ComposerConfig(64, 128), device="cpu")
        if lie:
            s._scroll_fn, s._waypoint_fn = _lie(s._scroll_fn), _lie(s._waypoint_fn)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        for off in (0, 9, 23, 40, 100):
            s.write_scroll_frame(off)
        return s
    assert stream(lie=True).getvalue() == stream().getvalue()

    s, sliced = stream(), stream()
    monkeypatch.setattr(scroll, "scroll_frame", _lie(scroll.scroll_frame))
    s._scroll_fn = _lie(s._scroll_fn)
    with pytest.raises(OverflowError, match="RBSP budget"):
        s.write_scroll_frame(30)
    monkeypatch.setattr(scroll, "scroll_frame_sliced",
                        _lie(scroll.scroll_frame_sliced))
    with pytest.raises(OverflowError, match="sliced"):
        sliced.write_scroll_frame_sliced(30, 4)


def test_session_registry_and_fallback():
    s, js = _sessions(64, 48)
    for off in (0, 496, 992, 500):
        assert s.waypoints.needs_waypoint(off) == js.waypoints.needs_waypoint(off)
    for k in range(8):
        assert s.waypoints.register(496 * (k + 1)) == js.waypoints.register(
            496 * (k + 1))
    with pytest.raises(OverflowError, match="registry full"):
        s.waypoints.register(9 * 496)
    off, lt, valid, count = s.waypoints.as_arrays("cpu")
    assert off.shape == lt.shape == valid.shape == (1, 8)
    assert off.dtype == torch.int32 and valid.dtype == torch.bool
    assert count.tolist() == [8] and off[0, 7] == 8 * 496

    s = session.ComposerSession(ComposerConfig(64, 48), device="cpu")
    planes = (np.full((48, 64), 90, np.uint8), np.full((24, 32), 128, np.uint8),
              np.full((24, 32), 128, np.uint8))
    with pytest.raises(ValueError, match="session is"):
        s.write_fallback_frame(tuple(p[:16] for p in planes))
    good = splice.FrameHints(motion_regions=(splice.MotionRegion(0, 0, 2, 2,
                                                                 mv_y=4),))
    bad = splice.FrameHints(motion_regions=(splice.MotionRegion(0, 0, 9, 2),))
    s.write_parameter_sets()
    s.write_test_atlases()
    assert s.write_hint_frame_or_fallback(good) is False
    with pytest.raises(splice.HintsNotServable):
        s.write_hint_frame_or_fallback(bad)
    if avref.available():
        # The fallback frame (x264 through avref) becomes the fresh atlas.
        assert s.write_hint_frame_or_fallback(bad, fallback_frame=planes)
        assert s.waypoints.count == 0 and s.frames_written == 2
    else:
        with pytest.raises(RuntimeError, match="avref"):
            s.write_hint_frame_or_fallback(bad, fallback_frame=planes)
    assert verify.verify_stream(s.getvalue()).ok


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------

def _both(main_name, args, tmp_path, name="out.h264"):
    """(rc, bytes) of the port's and the JAX package's CLI."""
    out = []
    for mod, extra in ((cli, ["--device", "cpu"]), (jcli, [])):
        path = tmp_path / f"{mod.__name__.split('.')[0]}_{name}"
        rc = getattr(mod, main_name)(args + ["-o", str(path)] + extra)
        out.append((rc, path.read_bytes() if path.exists() else None))
    return out


@pytest.mark.parametrize("args", [
    ["-n", "4", "-w", "64", "-H", "48"],
    ["-n", "5", "-S", "7", "-w", "64", "-H", "48", "--solid",
     "--color-a", "red", "--color-b", "cyan", "--pskip"],
    ["-n", "2", "-S", "31", "-w", "96", "-H", "256", "--pskip",
     "--rows-per-slice", "8"]], ids=["test-mode", "solid-pskip", "sliced"])
def test_scroll_encoder_cli(args, tmp_path, jitted_jax_sliced):
    port, jax_ = _both("scroll_encoder_main", args, tmp_path)
    assert port == jax_ and port[0] == 0
    assert verify.verify_stream(port[1]).ok


def test_scroll_encoder_cli_two_idr_donor(tmp_path):
    cfg = ComposerConfig(64, 48)
    s = session.ComposerSession(cfg, device="cpu")
    s.write_parameter_sets()
    s.writer.append_raw(ipcm.idr_frame_color(cfg, 81, 90, 240))
    s.writer.append_raw(ipcm.idr_frame_striped(cfg, (1, 2, 3), (4, 5, 6),
                                               (7, 8, 9)))
    donor = tmp_path / "two_idr.h264"
    s.write_to_file(donor)
    port, jax_ = _both("scroll_encoder_main", ["-i", str(donor), "-n", "3"],
                       tmp_path)
    assert port == jax_ and port[0] == 0
    one = tmp_path / "one.h264"
    one.write_bytes(donor.read_bytes()[: len(donor.read_bytes()) // 2])
    port, jax_ = _both("scroll_encoder_main", ["-i", str(one)], tmp_path, "x")
    assert port[0] == jax_[0] == 1


def test_composer_cli_roundtrip(tmp_path):
    cfg = ComposerConfig(64, 512)
    for name, color in (("a", (81, 90, 240)), ("b", (41, 240, 110))):
        s = session.ComposerSession(cfg, device="cpu")
        s.write_parameter_sets()
        s.writer.append_raw(ipcm.idr_frame_color(cfg, *color))
        s.write_to_file(tmp_path / f"{name}.h264")
    args = ["--ref-a", str(tmp_path / "a.h264"), "--ref-b",
            str(tmp_path / "b.h264"), "-n", "6", "-s", "124", "--safe-mv"]
    port, jax_ = _both("composer_main", args, tmp_path)
    assert port == jax_ and port[0] == 0
    rep = verify.verify_stream(port[1], strict_mv=True, mv_limit_px=496)
    assert rep.ok, rep.errors
    # `python -m ...cli` dispatch: the program name, or composer by default.
    out = tmp_path / "m.h264"
    assert cli.main(args + ["-o", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == port[1]
    assert cli.main(["scroll-encoder", "-n", "2", "-w", "64", "-H", "48",
                     "-o", str(out), "--device", "cpu"]) == 0


def _cabac_donor(path):
    bw = bitio.BitWriter()
    for v in (0, 0):
        bw.write_ue(v)
    bw.write_bit(1)   # CABAC
    bw.write_bit(0)
    for v in (0, 0, 0):
        bw.write_ue(v)
    bw.write_bit(0)
    bw.write_bits(0, 2)
    for v in (0, 0, 0):
        bw.write_se(v)
    for v in (1, 0, 0):
        bw.write_bit(v)
    bw.write_trailing_bits()
    cfg = ComposerConfig(64, 48)
    path.write_bytes(write_nal_unit(generate_sps(64, 48), 3, 7)
                     + write_nal_unit(bw.getvalue(), 3, 8)
                     + ipcm.idr_frame_color(cfg, 81, 90, 240))


def test_composer_cli_errors(tmp_path):
    garbage = tmp_path / "g.h264"
    garbage.write_bytes(b"\x12\x34" * 300)
    cabac = tmp_path / "cabac.h264"
    _cabac_donor(cabac)
    for args in (["--ref-a", "/nonexistent", "--ref-b", "/nonexistent"],
                 ["--ref-a", str(garbage), "--ref-b", str(garbage)],
                 ["--ref-a", "a", "--ref-b", "b", "-n", "0"],
                 ["--ref-a", str(cabac), "--ref-b", str(cabac), "-n", "2"]):
        assert [rc for rc, _ in _both("composer_main", args, tmp_path)] == [1, 1]


@pytest.mark.parametrize("extra", [[], ["--scroll-region"]])
def test_splice_demo_cli(extra, tmp_path):
    donor = tmp_path / "donor.h264"
    donor.write_bytes(fixtures.synthetic_cavlc_stream(96, 96, n_p_frames=2,
                                                      seed=9))
    args = ["--donor", str(donor), "--width", "320", "--height", "240",
            "--rect-x", "4", "--rect-y", "3"] + extra
    port, jax_ = _both("splice_demo_main", args, tmp_path)
    assert port == jax_ and port[0] == 0


# ---------------------------------------------------------------------------
# The verifier.
# ---------------------------------------------------------------------------

def test_verify_reports_match_jax_under_corruption():
    """verify_stream's whole report on a clean stream and on bit-flipped
    copies (test_robustness's fuzz), nal_diff, and verify_cli's JSON."""
    s = session.ComposerSession(ComposerConfig(64, 128), device="cpu")
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    for off in (0, 9, 23, 40, 100):
        s.write_scroll_frame(off)
    base = s.getvalue()
    rng = np.random.default_rng(13)
    for trial in range(12):
        data = bytearray(base)
        for _ in range(int(rng.integers(0 if trial == 0 else 1, 6))):
            pos = int(rng.integers(6, len(data)))
            data[pos] ^= 1 << int(rng.integers(0, 8))
        for kw in (dict(), dict(strict_trailing=False, strict_mv=True,
                                mv_limit_px=64)):
            assert (_asdict(verify.verify_stream(bytes(data), **kw))
                    == _asdict(jverify.verify_stream(bytes(data), **kw)))
        assert (verify.nal_diff(bytes(data), base)
                == jverify.nal_diff(bytes(data), base))


def test_verify_cli(tmp_path, capsys):
    s = session.ComposerSession(ComposerConfig(64, 48), device="cpu")
    s.write_parameter_sets()
    s.write_test_atlases()
    s.write_scroll_frame(5)
    path = tmp_path / "v.h264"
    s.write_to_file(path)
    for args in ([str(path)], [str(path), "--mv-limit", "1",
                               "--lenient-trailing"]):
        rcs = [verify.verify_cli(args), jverify.verify_cli(args)]
        port, jax_ = capsys.readouterr().out.strip().splitlines()
        assert json.loads(port) == json.loads(jax_) and rcs[0] == rcs[1]
    assert os.path.getsize(path) > 0
