"""Port vs JAX: hint frames, the partitioned seam, sliced frames, the
batched hint step, egress compaction (`compact_batch_nal`) and the hint
validation rules, plus the partitioned, nearest and large-frame entries of
the session golden file.  Seeded numpy inputs go through both packages;
the JAX functions run per session under vmap (staged back end on the CPU)
and the port's on CPU tensors (the kernels' plain versions).
Tolerance: none — bytes, lengths and flags are compared exactly."""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu import cli as jcli
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import hints as jhints
from h264_scroll_encoder_tpu.models import ipcm as jipcm
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu.session import ComposerSession as JaxSession
from h264_scroll_encoder_tpu.utils import fixtures as jfixtures
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import hints, scroll, splice
from h264_scroll_encoder_tpu_torch.ops.bitio import BitReader
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.syntax import parse, slice_headers
from h264_scroll_encoder_tpu_torch.verify import verify_stream

torch.set_num_threads(1)


def _t(a):
    """Inputs in the JAX package's widths (int32)."""
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _j(a, dtype=np.int32):
    return jnp.asarray(np.asarray(a).astype(dtype))


def _same(got, want):
    """Every output equal, exactly (flags, lengths, bits and NAL bytes)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _registry(rng, B, height):
    """Random waypoint registries (count 0..8, offsets at multiples of 496,
    ~10% invalid slots) and offsets, a third of them exact waypoints."""
    count = rng.integers(0, MAX_WAYPOINTS + 1, B)
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    live = slot < count[:, None]
    offs = rng.integers(0, height + 1, B)
    offs[: B // 3] = 496 * rng.integers(0, 3, B // 3)
    return dict(frame_num=rng.integers(0, 40, B), offsets=offs,
                wp_offsets=(slot + 1) * 496 * live, wp_ltidx=(2 + slot) * live,
                wp_valid=live & (rng.random((B, MAX_WAYPOINTS)) < 0.9),
                wp_count=count)


def _jax_args(st):
    return (_j(st["frame_num"]), _j(st["offsets"]), _j(st["wp_offsets"]),
            _j(st["wp_ltidx"]), jnp.asarray(st["wp_valid"]),
            _j(st["wp_count"]))


def _port_args(st):
    return (_t(st["frame_num"]), _t(st["offsets"]), _t(st["wp_offsets"]),
            _t(st["wp_ltidx"]), torch.as_tensor(st["wp_valid"]),
            _t(st["wp_count"]))


# ---------------------------------------------------------------------------
# Hint fields, hint frames and the batched hint step.
# ---------------------------------------------------------------------------

REGIONS = ((0, 0, 8, 6, 0, 0, 10), (2, 2, 5, 4, 1, 0, -4),
           (6, 4, 12, 9, 0, -8, 3), (-2, 5, 3, 30, 1, 2, 0))


def _hints(mod, specs):
    return mod.FrameHints(motion_regions=tuple(mod.MotionRegion(*s)
                                               for s in specs))


def test_hint_fields_occlusion_and_clipping():
    """Later regions win; regions are clipped to the frame; int32 grids on
    the requested device."""
    cfg, jcfg = ComposerConfig(128, 96), JaxConfig(128, 96)
    got = hints.hint_fields(cfg, _hints(splice, REGIONS), device="cpu")
    want = jhints.hint_fields(jcfg, _hints(jsplice, REGIONS))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][3, 3]) == 1 and int(got[2][3, 3]) == -16


@pytest.mark.parametrize("pskip", [True, False])
def test_emit_hint_frame(pskip):
    """One hint frame with two registered waypoints, against JAX."""
    cfg, jcfg = ComposerConfig(320, 240), JaxConfig(320, 240)
    specs = REGIONS + ((10, 10, 20, 15, 3, 0, 40),)
    lt = np.asarray([2, 3] + [0] * 6)
    valid = np.asarray([True, True] + [False] * 6)
    got = hints.emit_hint_frame(cfg, 17, _hints(splice, specs),
                                enable_pskip=pskip, num_waypoints=2,
                                wp_ltidx=lt, wp_valid=valid, device="cpu")
    want = jhints.emit_hint_frame(jcfg, 17, _hints(jsplice, specs),
                                  enable_pskip=pskip, num_waypoints=2,
                                  wp_ltidx=_j(lt), wp_valid=jnp.asarray(valid))
    assert got[0].shape[0] == 1 and not bool(got[3][0])
    _same((x[0] for x in got), want)


@pytest.mark.parametrize("compact_x", [False, True])
def test_batched_hint_step_divergent_num_refs(compact_x):
    """Sessions with 0..8 waypoints (num_refs 2..10: te() is one inverted
    bit at 2, ue() above) and per-session regions, against JAX's step."""
    rng = np.random.default_rng(4 + compact_x)
    cfg, jcfg = ComposerConfig(128, 96), JaxConfig(128, 96)
    B, H, W = 9, 6, 8
    count = np.arange(B) % (MAX_WAYPOINTS + 1)
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    valid = slot < count[:, None]
    ref = np.zeros((B, H, W), np.int32)
    mvx = np.zeros((B, H, W), np.int32)
    mvy = np.zeros((B, H, W), np.int32)
    for b in range(B):
        y0, x0 = rng.integers(0, H - 1), rng.integers(0, W - 1)
        ref[b, y0:, x0:] = rng.integers(0, 2 + count[b])
        mvy[b, y0:, x0:] = 4 * rng.integers(-40, 41)
        if not compact_x:
            mvx[b, y0:, x0:] = 4 * rng.integers(-8, 9)
    args = (rng.integers(0, 30, B).astype(np.int32), ref, mvx, mvy,
            count.astype(np.int32), np.where(valid, 2 + slot, 0).astype(np.int32),
            valid)
    got = batch.make_batched_hint_step(cfg, compact_x=compact_x,
                                       device="cpu")(*args)
    want = jbatch.make_batched_hint_step(jcfg, compact_x=compact_x)(
        *[jnp.asarray(a) for a in args])
    assert not bool(got[3].any())
    _same(got, want)


# ---------------------------------------------------------------------------
# The partitioned seam.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("waypoint,pskip,exact", [
    (False, False, False), (False, True, True), (True, False, True),
    (True, True, False)])
def test_partitioned_frames(waypoint, pskip, exact):
    """scroll_frame / waypoint_frame with boundary_policy="partitioned"
    (4 slots per MB, 16x8 seam rows), random registries, against JAX."""
    rng = np.random.default_rng(20 + 4 * waypoint + 2 * pskip + exact)
    cfg, jcfg = ComposerConfig(64, 1024), JaxConfig(64, 1024)
    st = _registry(rng, 8, 1024)
    st["offsets"][3:] = rng.integers(0, 1024, 5)     # seams at any phase
    jf = jscroll.waypoint_frame if waypoint else jscroll.scroll_frame
    tf = scroll.waypoint_frame if waypoint else scroll.scroll_frame
    kw = dict(boundary_policy="partitioned", enable_pskip=pskip,
              ebsp_exact=exact)
    want = jax.jit(jax.vmap(functools.partial(jf, jcfg, **kw)))(*_jax_args(st))
    got = tf(cfg, *_port_args(st), **kw)
    assert not bool(got[3].any())
    _same(got, want)


def test_partitioned_unified_frame_and_symbols():
    """unified_frame's partitioned path, with per-session waypoint flags,
    against JAX; a seam row of 16x8 partitions (mb_type 1) in the second
    12,288-symbol chunk at 720p."""
    rng = np.random.default_rng(30)
    cfg, jcfg = ComposerConfig(64, 1024), JaxConfig(64, 1024)
    st = _registry(rng, 6, 1024)
    is_wp = rng.random(6) < 0.5
    want = jax.jit(jax.vmap(functools.partial(
        jscroll.unified_frame, jcfg, boundary_policy="partitioned")))(
        *_jax_args(st), jnp.asarray(is_wp))
    got = scroll.unified_frame(cfg, *_port_args(st), torch.as_tensor(is_wp),
                               boundary_policy="partitioned")
    _same(got, want)

    cfg = ComposerConfig(1280, 720)
    z = torch.zeros((4, MAX_WAYPOINTS), dtype=torch.int32)
    offs = torch.as_tensor(cases.SESSION_POLICY_OFFSETS[:4], dtype=torch.int32)
    pat, nb, n_rbsp, _ = scroll.unified_frame_symbols(
        cfg, torch.full((4,), 5, dtype=torch.int32), offs, z, z, z.bool(),
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool),
        boundary_policy="partitioned")
    assert pat.shape[1] > 12288 and n_rbsp == 14496
    seam_row = (cfg.height - offs) // 16          # rows 44, 42, 40, 38
    first_slot = slice_headers.P_HEADER_SLOTS + seam_row * cfg.mb_width * 4
    assert bool((first_slot[:3] > 12288).all())


def test_partitioned_rejects_wide_frames():
    cfg = ComposerConfig(1920, 1088)
    z = torch.zeros((1, MAX_WAYPOINTS), dtype=torch.int32)
    with pytest.raises(ValueError, match="4095"):
        scroll.scroll_frame(cfg, torch.tensor([2], dtype=torch.int32),
                            torch.tensor([7], dtype=torch.int32), z, z,
                            z.bool(), torch.zeros(1, dtype=torch.int32),
                            boundary_policy="partitioned")


# ---------------------------------------------------------------------------
# Sliced frames.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,pskip,exact", [(4, False, False),
                                              (9, True, False),
                                              (9, False, True)])
def test_scroll_frame_sliced(rows, pskip, exact):
    """All bands of all sessions in one back-end call, against JAX's
    vmap over sessions of its per-band vmap; first_mb of each band's
    header; band-local prediction at the band edges."""
    rng = np.random.default_rng(40 + rows + 2 * pskip + exact)
    cfg, jcfg = ComposerConfig(96, 576), JaxConfig(96, 576)   # 36 MB rows
    st = _registry(rng, 5, 576)
    kw = dict(rows_per_slice=rows, enable_pskip=pskip, ebsp_exact=exact)
    want = jax.jit(jax.vmap(functools.partial(
        jscroll.scroll_frame_sliced, jcfg, **kw)))(*_jax_args(st))
    got = scroll.scroll_frame_sliced(cfg, *_port_args(st), **kw)
    K = 36 // rows
    assert got[0].shape[:2] == (5, K) and not bool(got[3].any())
    _same(got, want)
    for k in range(K):
        nal = got[0][1, k].numpy()[: int(got[1][1, k])].tobytes()
        unit = next(parse.iter_nal_units(nal))
        hdr = splice.parse_slice_header(
            BitReader(unit.rbsp), is_idr=False, nal_ref_idc=0,
            log2_max_frame_num=4, pps_num_ref_idx_l0_default=2)
        assert hdr.first_mb == k * rows * cfg.mb_width


def test_sliced_frame_is_one_back_end_call():
    """The K bands of B sessions are the rows of one symbol batch."""
    cfg = ComposerConfig(96, 576)
    z = torch.zeros((3, MAX_WAYPOINTS), dtype=torch.int32)
    pat, nb, n_rbsp = scroll.sliced_frame_symbols(
        cfg, torch.arange(3, dtype=torch.int32),
        torch.tensor([0, 100, 300], dtype=torch.int32), z, z, z.bool(),
        torch.zeros(3, dtype=torch.int32), rows_per_slice=4)
    assert pat.shape[0] == 3 * 9 and nb.shape == pat.shape
    assert n_rbsp == (4 * 6 * 16 // 8 + 96 + 3) // 4 * 4
    with pytest.raises(ValueError, match="divide"):
        scroll.sliced_frame_symbols(cfg, torch.arange(3), torch.zeros(3), z,
                                    z, z.bool(), torch.zeros(3),
                                    rows_per_slice=5)


# ---------------------------------------------------------------------------
# Egress.
# ---------------------------------------------------------------------------

def _compact_both(nal, lens, cap):
    got = batch.compact_batch_nal(torch.as_tensor(nal), torch.as_tensor(lens),
                                  cap)
    want = jax.jit(lambda a, n: jbatch.compact_batch_nal(a, n, cap))(
        jnp.asarray(nal), jnp.asarray(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.uint8 and got[0].shape == (cap,)
    assert int(got[1]) == int(want[1])
    assert bool(got[2]) == bool(want[2])
    return got


@pytest.mark.parametrize("cap", [128, 64, 100, 99, 101, 1])
def test_compact_batch_nal(cap):
    """tests/test_batch.py's case (ragged lengths including zero) at caps
    above, at, one below and one above the total (100), and far below."""
    rng = np.random.default_rng(5)
    nal = rng.integers(1, 255, (7, 50), dtype=np.uint8)
    lens = np.asarray([13, 0, 50, 1, 29, 0, 7], np.int32)
    packed, total, ovf = _compact_both(nal, lens, cap)
    expect = np.concatenate([nal[b, :lens[b]] for b in range(7)])
    assert int(total) == expect.size == 100
    assert bool(ovf) == (cap < 100)
    n = min(cap, 100)
    np.testing.assert_array_equal(packed.numpy()[:n], expect[:n])
    assert not packed.numpy()[n:].any()


def test_compact_batch_nal_random_batches():
    """Random widths (multiples of 4 or not), int64 lengths, zero rows."""
    rng = np.random.default_rng(6)
    for B, N in ((1, 7), (33, 64), (16, 130)):
        nal = rng.integers(0, 256, (B, N), dtype=np.uint8)
        lens = rng.integers(0, N + 1, B)
        lens[rng.random(B) < 0.2] = 0
        total = int(lens.sum())
        for cap in {max(total, 1), max(total - 1, 1)}:
            _compact_both(nal, lens.astype(np.int32), cap)
        got = batch.compact_batch_nal(torch.as_tensor(nal),
                                      torch.as_tensor(lens), total + 4)
        assert int(got[1]) == total and not bool(got[2])


# ---------------------------------------------------------------------------
# Hint validation (MASTER_DESIGN §7.1 helpers, §10 not-servable flag).
# ---------------------------------------------------------------------------

def test_pixel_rect_helpers_match_jax():
    for args in ((96, 48, 352, 352), (100, 50, 360, 360), (0, 0, 400, 400),
                 (1270, 700, 64, 64), (5, 9, 3, 2)):
        for margin in (0, 16, 24):
            assert (splice.align_dynamic_rect(*args, margin)
                    == jsplice.align_dynamic_rect(*args, margin))
            h, size = splice.FrameHints.with_dynamic_pixel_rect(
                *args, margin=margin, frame_width=1280, frame_height=720)
            jh, jsize = jsplice.FrameHints.with_dynamic_pixel_rect(
                *args, margin=margin, frame_width=1280, frame_height=720)
            assert size == jsize
            assert ((h.dynamic_mb_x, h.dynamic_mb_y)
                    == (jh.dynamic_mb_x, jh.dynamic_mb_y))
    reg = splice.MotionRegion.from_pixel_rect(30, 17, 100, 40, mv_y=8)
    assert reg == splice.MotionRegion(1, 1, 9, 4, mv_y=8)


VALIDATE_CASES = [
    ((), None), (((0, 0, 0, 2),), None), (((0, 0, 90, 2),), None),
    (((0, 0, 4, 2, 5),), None), (((0, 0, 4, 2, 0, 0, 600),), None),
    (((0, 0, 4, 2, 0, -497, 0),), None), (((0, 0, 4, 2, 1, 496, -496),), None),
    (((-1, 0, 4, 2),), None), ((), (24, 24)), ((), (25, 24)),
    ((), (60, 10)), (((0, 0, 80, 45, 1),), (10, 10))]


@pytest.mark.parametrize("specs,rect", VALIDATE_CASES)
def test_validate_and_hints_not_servable(specs, rect):
    """FrameHints.validate raises HintsNotServable (a ValueError) exactly
    where the JAX package's does."""
    cfg, jcfg = ComposerConfig(1280, 720), JaxConfig(1280, 720)

    def outcome(mod, c):
        h = mod.FrameHints(motion_regions=tuple(mod.MotionRegion(*s)
                                                for s in specs),
                           dynamic_mb_x=70 if rect == (60, 10) else 5,
                           dynamic_mb_y=2)
        try:
            h.validate(c, 2, dynamic_rect_mb=rect)
        except mod.HintsNotServable as e:
            assert isinstance(e, ValueError)
            return str(e)
        return None

    assert outcome(splice, cfg) == outcome(jsplice, jcfg)


# ---------------------------------------------------------------------------
# The session golden file's other streams, against the JAX package.
# ---------------------------------------------------------------------------

JAX_PKG = types.SimpleNamespace(
    ComposerConfig=JaxConfig, ComposerSession=JaxSession,
    MotionRegion=jsplice.MotionRegion, FrameHints=jsplice.FrameHints,
    fixtures=jfixtures, ipcm=jipcm, cli=jcli)


@pytest.mark.parametrize("names", [("partitioned", "nearest"),
                                   ("hint_1080p", "scroll_4k")],
                         ids=["policies", "large"])
def test_session_golden_streams_are_jax_output(tmp_path, names):
    committed = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    for name, data in cases.session_streams(JAX_PKG, tmp_path, names).items():
        assert cases.stream_digest(data) == committed[name], name


def test_large_frames_verify(tmp_path):
    """The port's 1920x1088 hint frame (wide layout, generic 32-bit
    budget) and 3840x2160 scroll frame pass the port's verifier."""
    streams = cases.session_streams(cases.port_package(), tmp_path,
                                    ("hint_1080p", "scroll_4k"),
                                    device="cpu")
    for name, data in streams.items():
        rep = verify_stream(data)
        assert rep.ok, (name, rep.errors)
        assert rep.p_slices == 1
