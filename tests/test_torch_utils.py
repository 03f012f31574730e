"""Port vs JAX: utils/snapshot (session eviction and restore, both ways
across the packages), utils/mp4mux and utils/trace.  Seeded inputs;
tolerance: exact equality of bytes, JSON and every state field."""

import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu.session import ComposerSession as JaxSession
from h264_scroll_encoder_tpu.syntax import parse as jparse
from h264_scroll_encoder_tpu.utils import mp4mux as jmp4mux
from h264_scroll_encoder_tpu.utils import snapshot as jsnapshot
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.session import ComposerSession
from h264_scroll_encoder_tpu_torch.utils import mp4mux, snapshot
from h264_scroll_encoder_tpu_torch.utils.trace import (BitstreamTrace,
                                                       StageTimer,
                                                       torch_profile)

torch.set_num_threads(1)

TALL = (64, 1024)       # crosses the 496 px waypoint limit
HISTORY = (0, 100, 496, 496, 600, 992, 992, 12)
FIELDS = ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid", "wp_count")
SCHEDULE = np.asarray([[0, 496, 992, 40], [100, 496, 992, 44],
                       [496, 600, 40, 48], [496, 604, 992, 52],
                       [700, 992, 1000, 56], [12, 992, 8, 60],
                       [300, 1000, 496, 64], [24, 4, 496, 68]], np.int32)


def _last_nal(data: bytes) -> bytes:
    return list(jparse.iter_nal_units(data))[-1].data


def _sessions(history=HISTORY):
    j, t = JaxSession(JaxConfig(*TALL)), ComposerSession(ComposerConfig(*TALL),
                                                         device="cpu")
    for s in (j, t):
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        for off in history:
            s.write_scroll_or_waypoint_frame(off)
    return j, t


def test_host_snapshot_json_equals_jax(tmp_path):
    j, t = _sessions()
    assert snapshot.session_state_dict(t) == jsnapshot.session_state_dict(j)
    jsnapshot.save_session(j, tmp_path / "jax.json")
    snapshot.save_session(t, tmp_path / "port.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())["waypoints"][
        "count"] == 2


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_host_snapshot_resumes_across_packages(tmp_path, saver):
    """A session evicted by one package and restored into a fresh session
    of the other continues with the uninterrupted session's bytes."""
    j, t = _sessions()
    path = tmp_path / "sess.json"
    (jsnapshot.save_session(j, path) if saver == "jax"
     else snapshot.save_session(t, path))
    if saver == "jax":
        resumed = ComposerSession(ComposerConfig(*TALL), device="cpu")
        snapshot.restore_session(resumed, path)
    else:
        resumed = JaxSession(JaxConfig(*TALL))
        jsnapshot.restore_session(resumed, path)
    for off in (700, 1000, 1016):
        resumed.write_scroll_or_waypoint_frame(off)
        j.write_scroll_or_waypoint_frame(off)
        assert _last_nal(resumed.getvalue()) == _last_nal(j.getvalue())
    with pytest.raises(ValueError, match="geometry"):
        snapshot.restore_session(
            ComposerSession(ComposerConfig(64, 48), device="cpu"), path)


def _jax_steps(jstate, rows):
    step = jbatch.make_batched_step(JaxConfig(*TALL))
    outs = []
    for offs in rows:
        jstate, o = step(jstate, jnp.asarray(offs))
        outs.append(tuple(np.asarray(x) for x in o))
    return jstate, outs


def _port_steps(tstate, rows):
    step = batch.make_batched_step(ComposerConfig(*TALL))
    outs = []
    for offs in rows:
        tstate, o = step(tstate, torch.as_tensor(offs))
        outs.append(tuple(x.numpy() for x in o))
    return tstate, outs


def _assert_outs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_batch_state_npz_resumes_across_packages(tmp_path, saver):
    """save_batch_state in one package, load_batch_state in the other and
    continue make_batched_step: the continued NALs equal the
    uninterrupted run's; the two packages' npz files are byte-equal."""
    head, tail = SCHEDULE[:4], SCHEDULE[4:]
    jstate, _ = _jax_steps(jbatch.SessionState.create(4, frame_num=5), head)
    tstate, _ = _port_steps(batch.SessionState.create(4, frame_num=5,
                                                      device="cpu"), head)
    jsnapshot.save_batch_state(jstate, tmp_path / "jax.npz")
    snapshot.save_batch_state(tstate, tmp_path / "port.npz")
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "jax.npz").read_bytes()
    with np.load(tmp_path / "port.npz") as z:
        assert {k: z[k].dtype for k in z.files} == {
            "frame_num": np.int32, "wp_offsets": np.int32,
            "wp_ltidx": np.int32, "wp_valid": np.bool_, "wp_count": np.int32}
    _, want = _jax_steps(jstate, tail)
    if saver == "jax":
        restored = snapshot.load_batch_state(tmp_path / "jax.npz",
                                             device="cpu")
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(restored, f).numpy(),
                                          np.asarray(getattr(jstate, f)))
        _, got = _port_steps(restored, tail)
    else:
        _, got = _jax_steps(jsnapshot.load_batch_state(tmp_path / "port.npz"),
                            tail)
    _assert_outs_equal(got, want)


def test_serving_state_npz_equals_jax(tmp_path):
    state = batch.SessionState.create(3, frame_num=7, device="cpu")
    state.wp_offsets[:, 0] = 496
    state.wp_valid[:, 0] = True
    ctx = {"ref_map": [0], "step": 3, "cursor": [1, 2, 3]}
    snapshot.save_serving_state(tmp_path / "port.npz", state, ctx)
    jsnapshot.save_serving_state(
        tmp_path / "jax.npz",
        jbatch.SessionState(**{f: jnp.asarray(a)
                               for f, a in state.to_numpy().items()}), ctx)
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "jax.npz").read_bytes()
    got, got_ctx = snapshot.load_serving_state(tmp_path / "jax.npz",
                                               device="cpu")
    assert got_ctx == ctx
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(state, f))


# -- serving eviction mid-stream (tests/test_batch.py's serving test) ------

SERVE_B, SERVE_T, EVICT = 3, 6, 3
SERVE_R, SERVE_C, SERVE_R0, SERVE_C0 = 4, 5, 4, 6
SERVE_REFS = 3                       # [prev frame | atlas A | atlas B]
CLASS, S_FLAT, S_EXC = 64, 320, 16


def _serving_pool():
    from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
    from h264_scroll_encoder_tpu_torch.ops.bitio import BitWriter
    from h264_scroll_encoder_tpu_torch.utils import fixtures

    rng = np.random.default_rng(77)
    pool = []
    for _ in range(SERVE_B * SERVE_T):
        g = fixtures.representative_donor_grid(rng, SERVE_C, SERVE_R)
        for row in g:
            for i, mb in enumerate(row):
                if mb is not mbt.SKIP and mb.kind == "ipcm":
                    row[i] = fixtures.random_inter_mb(rng, 1)
        bw = BitWriter()
        mbt.emit_p_slice_mbs(bw, g, 1)
        bw.write_trailing_bits()
        pool.append(bw.getvalue())
    return pool


def _fresh_state(B):
    st = batch.SessionState.create(B, frame_num=2, device="cpu")
    # Distinct per-session frame_nums and a live waypoint chain, so the
    # snapshot carries non-trivial state.
    st.frame_num += torch.arange(B, dtype=torch.int32)
    st.wp_offsets[:, 0] = 496
    st.wp_ltidx[:, 0] = 2
    st.wp_valid[:, 0] = True
    st.wp_count += 1
    return st


def _port_serving(pool, state, ctx, t0, t1):
    """The successive-donor rows splice serving loop (fresh donors, native
    MV retarget, blob wire) from step t0 to t1; returns (state, NALs)."""
    from h264_scroll_encoder_tpu_torch.models import splice_device
    from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
        p_slice_header_symbols)

    cfg = ComposerConfig(320, 240)
    B = SERVE_B
    step = batch.make_batched_splice_step_rows(
        cfg, SERVE_C0, SERVE_R0, SERVE_C, SERVE_R, SERVE_REFS, nal_ref_idc=2,
        has_align=True, n_rbsp=splice_device.splice_rbsp_budget(
            cfg, SERVE_R * SERVE_C, SERVE_R * CLASS * 32),
        s_row=CLASS, s_flat=S_FLAT, s_exc=S_EXC)
    zero = torch.zeros((B, cfg.mb_height, cfg.mb_width), dtype=torch.int32)
    nals = []
    for t in range(t0, t1):
        payloads = [pool[(t * B + b) % len(pool)] for b in range(B)]
        dn, _meta = splice_device.prepare_donor_rows_serving(
            payloads, [0] * B, SERVE_R, SERVE_C, 1, SERVE_REFS,
            donor_ref_map=tuple(ctx["ref_map"]), s_row=CLASS,
            retarget_mvs=True, blob_wire=True, s_flat=S_FLAT, s_exc=S_EXC,
            device="cpu")
        fn = state.frame_num % 16
        hp, hn = p_slice_header_symbols(
            cfg, fn, fn * 2, True, -1, state.wp_count, state.wp_ltidx,
            state.wp_valid,
            prev_ref_abs_diff=1)
        nal, nal_len, _, ovf = step(hp, hn, zero, zero, zero, zero.bool(), dn)
        assert not ovf.any()
        nals += [nal[b, : int(nal_len[b])].numpy().tobytes() for b in range(B)]
        state = batch.SessionState(state.frame_num + 1, state.wp_offsets,
                                   state.wp_ltidx, state.wp_valid,
                                   state.wp_count)
    return state, nals


def _jax_serving(pool):
    """tests/test_batch.py's uninterrupted JAX serving run."""
    from h264_scroll_encoder_tpu.models import splice_device as jsd
    from h264_scroll_encoder_tpu.syntax.slice_headers import (
        p_slice_header_symbols as jheader)

    cfg = JaxConfig(320, 240)
    B = SERVE_B
    step = jbatch.make_batched_splice_step_rows(
        cfg, SERVE_C0, SERVE_R0, SERVE_C, SERVE_R, SERVE_REFS, nal_ref_idc=2,
        has_align=True, n_rbsp=jsd.splice_rbsp_budget(
            cfg, SERVE_R * SERVE_C, SERVE_R * CLASS * 32),
        s_row=CLASS, s_flat=S_FLAT, s_exc=S_EXC)
    st = _fresh_state(B).to_numpy()
    zero = jnp.zeros((B, cfg.mb_height, cfg.mb_width), jnp.int32)
    nals = []
    for t in range(SERVE_T):
        payloads = [pool[(t * B + b) % len(pool)] for b in range(B)]
        dn, _meta = jsd.prepare_donor_rows_serving(
            payloads, [0] * B, SERVE_R, SERVE_C, 1, SERVE_REFS,
            donor_ref_map=(0,), s_row=CLASS, retarget_mvs=True,
            blob_wire=True, s_flat=S_FLAT, s_exc=S_EXC)
        hps, hns = zip(*(jheader(
            cfg, jnp.int32(st["frame_num"][b] % 16),
            jnp.int32((st["frame_num"][b] % 16) * 2), is_reference=True,
            long_term_idx=-1, num_waypoints=jnp.int32(st["wp_count"][b]),
            wp_long_term_idx=jnp.asarray(st["wp_ltidx"][b]),
            wp_valid=jnp.asarray(st["wp_valid"][b]), prev_ref_abs_diff=1)
            for b in range(B)))
        nal, nal_len, _, ovf = step(jnp.stack(hps), jnp.stack(hns), zero,
                                    zero, zero, zero.astype(bool), dn)
        assert not np.asarray(ovf).any()
        nal, nal_len = np.asarray(nal), np.asarray(nal_len)
        nals += [nal[b, : nal_len[b]].tobytes() for b in range(B)]
        st["frame_num"] = st["frame_num"] + 1
    return nals


def test_serving_evict_restore_byte_identical(tmp_path):
    """A batched successive-donor splice serving set (320x240, B = 3, six
    steps) is evicted after step 3 with save_serving_state, everything is
    dropped, and the set restored by load_serving_state continues: every
    NAL equals the uninterrupted run's and the JAX package's."""
    pool = _serving_pool()
    ctx0 = {"ref_map": [0], "step": 0, "abs_diff": 1, "s_row": CLASS}
    _, nals_a = _port_serving(pool, _fresh_state(SERVE_B), ctx0, 0, SERVE_T)

    state, nals_b = _port_serving(pool, _fresh_state(SERVE_B), ctx0, 0, EVICT)
    ctx = dict(ctx0, step=EVICT)
    snapshot.save_serving_state(tmp_path / "serving.npz", state, ctx)
    del state
    state2, ctx2 = snapshot.load_serving_state(tmp_path / "serving.npz",
                                               device="cpu")
    assert ctx2 == ctx
    _, nals_c = _port_serving(pool, state2, ctx2, ctx2["step"], SERVE_T)

    assert nals_b == nals_a[: EVICT * SERVE_B]
    assert nals_c == nals_a[EVICT * SERVE_B:], "post-restore NALs diverge"
    assert nals_b + nals_c == _jax_serving(pool)


# -- mp4mux ---------------------------------------------------------------

def _stream():
    s = ComposerSession(ComposerConfig(64, 48), device="cpu")
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    for off in (0, 4, 8, 12, 16):
        s.write_scroll_frame(off)
    return s.getvalue()


def _boxes(mp4: bytes) -> list:
    pos, boxes = 0, []
    while pos < len(mp4):
        size, kind = struct.unpack(">I4s", mp4[pos:pos + 8])
        boxes.append((kind, size))
        pos += size
    assert pos == len(mp4)
    return boxes


@pytest.mark.parametrize("fps", [30, 60])
def test_mux_equals_jax(fps):
    stream = _stream()
    assert mp4mux.annexb_to_samples(stream) == jmp4mux.annexb_to_samples(stream)
    mp4 = mp4mux.mux(stream, fps=fps)
    assert mp4 == jmp4mux.mux(stream, fps=fps)
    sps, pps, samples, sync = mp4mux.annexb_to_samples(stream)
    assert len(samples) == 7 and sync == [1]
    boxes = _boxes(mp4)
    assert [k for k, _ in boxes] == [b"ftyp", b"moov", b"mdat"]
    assert boxes[2][1] - 8 == sum(map(len, samples))


def test_mux_cli_equals_jax(tmp_path):
    stream = _stream()
    (tmp_path / "in.h264").write_bytes(stream)
    assert mp4mux.mux_cli([str(tmp_path / "in.h264"), str(tmp_path / "p.mp4"),
                           "--fps", "25"]) == 0
    jmp4mux.mux_cli([str(tmp_path / "in.h264"), str(tmp_path / "j.mp4"),
                     "--fps", "25"])
    assert (tmp_path / "p.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    with pytest.raises(ValueError, match="SPS/PPS"):
        mp4mux.mux(stream[40:])


# -- trace ----------------------------------------------------------------

def test_stage_timer_and_trace():
    t = StageTimer()
    with t.stage("compose"):
        pass
    t.count("frames", 3)
    rep = t.report()
    assert rep["compose"]["calls"] == 1
    assert rep["counters"]["frames"] == 3
    json.loads(t.report_json())

    a, b = BitstreamTrace(), BitstreamTrace()
    a.mark("sps", 0)
    a.mark("pps", 80)
    b.mark("sps", 0)
    b.mark("pps", 82)
    idx, ours, theirs = a.diff(b)
    assert idx == 1 and ours == ("pps", 80) and theirs == ("pps", 82)
    assert a.diff(a) is None
    b.marks[1] = ("pps", 80)
    b.mark("slice", 120)
    assert a.diff(b) == (2, None, ("slice", 120))


def test_stage_timer_matches_jax():
    from h264_scroll_encoder_tpu.utils.trace import StageTimer as JaxTimer

    timers = (StageTimer(), JaxTimer())
    for tm in timers:
        for name in ("prep", "compose", "compose"):
            with tm.stage(name):
                pass
        tm.count("bytes", 1200)
        tm.count("bytes", 34)
    reports = [tm.report() for tm in timers]
    for r in reports:
        for name in ("prep", "compose"):
            r[name].pop("mean_ms")
            r[name].pop("total_s")
    assert reports[0] == reports[1]


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    with torch_profile(str(tmp_path / "prof")) as prof:
        torch.arange(10).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("aten::sum" in e.key for e in prof.key_averages())
