"""Port vs JAX: the batched scroll step (parallel/batch), run_frames in
both semantics, and continuing a JAX session in the port.  Seeded numpy
schedules; tolerance: exact equality of every output and state field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu_torch.config import (ComposerConfig,
                                                  MAX_WAYPOINTS, MV_LIMIT_PX)
from h264_scroll_encoder_tpu_torch.parallel import batch

torch.set_num_threads(1)

TALL = (64, 1024)       # crosses the 496 px waypoint limit
FIELDS = ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid", "wp_count")


def _tall_schedule():
    """[12, 4] offsets: session 0 walks k * 496 until it needs a 9th
    waypoint (exhaustion), the others diverge (repeats after waypoint
    steps, back-scrolls, seeded random offsets)."""
    rng = np.random.default_rng(4)
    s0 = [k * MV_LIMIT_PX for k in range(1, MAX_WAYPOINTS + 2)] + [100, 200, 4]
    s1 = [0, 100, 496, 496, 600, 992, 992, 1000, 300, 12, 40, 80]
    s2 = list(rng.integers(0, 1025, 12))
    s3 = [992, 40, 992, 992, 496, 496, 0, 8, 16, 1024, 1000, 992]
    return np.stack([s0, s1, s2, s3], axis=1).astype(np.int32)


def _assert_state_equal(tstate, jstate):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)))


def _assert_outputs_equal(touts, jouts):
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_batched_step_divergent_sessions_and_exhaustion():
    jstep = jbatch.make_batched_step(JaxConfig(*TALL))
    tstep = batch.make_batched_step(ComposerConfig(*TALL))
    sched = _tall_schedule()
    jstate = jbatch.SessionState.create(sched.shape[1])
    tstate = batch.SessionState.create(sched.shape[1], device="cpu")
    flagged = False
    for offs in sched:
        jstate, jouts = jstep(jstate, jnp.asarray(offs))
        tstate, touts = tstep(tstate, torch.as_tensor(offs))
        _assert_outputs_equal(touts, jouts)
        _assert_state_equal(tstate, jstate)
        flagged |= bool(touts[4][0])
    assert flagged                                  # the 9th waypoint
    assert int(tstate.wp_count[0]) == MAX_WAYPOINTS


@pytest.mark.parametrize("composer_semantics", [False, True])
def test_run_frames(composer_semantics):
    sched = _tall_schedule()
    jfinal, jouts = jax.jit(lambda s, o: jbatch.run_frames(
        JaxConfig(*TALL), s, o, composer_semantics=composer_semantics))(
        jbatch.SessionState.create(sched.shape[1]), jnp.asarray(sched))
    tfinal, touts = batch.run_frames(
        ComposerConfig(*TALL),
        batch.SessionState.create(sched.shape[1], device="cpu"),
        torch.as_tensor(sched), composer_semantics=composer_semantics)
    _assert_outputs_equal(touts, jouts)
    _assert_state_equal(tfinal, jfinal)
    assert touts[1].any()                           # waypoints emitted


def test_full_width_720p_batch8():
    """The slice at full width: 1280x720, batch 8, 12 steps, seeded
    offsets that land on 496 for some sessions."""
    rng = np.random.default_rng(720)
    sched = rng.integers(0, 721, (12, 8))
    sched[3:5, 0] = 496
    sched[6:8, 5] = 496
    sched = sched.astype(np.int32)
    jstep = jbatch.make_batched_step(JaxConfig(1280, 720))
    tstep = batch.make_batched_step(ComposerConfig(1280, 720))
    jstate = jbatch.SessionState.create(8)
    tstate = batch.SessionState.create(8, device="cpu")
    waypoints = 0
    for offs in sched:
        jstate, jouts = jstep(jstate, jnp.asarray(offs))
        tstate, touts = tstep(tstate, torch.as_tensor(offs))
        assert touts[0].shape == (8, 7328)
        _assert_outputs_equal(touts, jouts)
        assert not touts[4].any()
        waypoints += int(touts[2].sum())
    assert waypoints >= 2


def test_session_state_from_numpy_continues_jax_session():
    cfg_j, cfg_t = JaxConfig(*TALL), ComposerConfig(*TALL)
    sched = _tall_schedule()
    jstep = jbatch.make_batched_step(cfg_j)
    jstate = jbatch.SessionState.create(4, frame_num=5)
    for offs in sched[:6]:
        jstate, _ = jstep(jstate, jnp.asarray(offs))
    tstate = batch.SessionState.from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in FIELDS}, device="cpu")
    for f, a in tstate.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jstate, f)))
        assert a.dtype == np.asarray(getattr(jstate, f)).dtype
    tstep = batch.make_batched_step(cfg_t)
    for offs in sched[6:]:
        jstate, jouts = jstep(jstate, jnp.asarray(offs))
        tstate, touts = tstep(tstate, torch.as_tensor(offs))
        _assert_outputs_equal(touts, jouts)
    _assert_state_equal(tstate, jstate)


@pytest.mark.parametrize("enable_pskip,emit_waypoints",
                         [(True, True), (False, False), (True, False)])
def test_batched_step_options(enable_pskip, emit_waypoints):
    """P_Skip runs (the decoder's skip-MV rule) and the waypoint-free
    step agree with the JAX package too."""
    kw = dict(enable_pskip=enable_pskip, emit_waypoints=emit_waypoints)
    jstep = jbatch.make_batched_step(JaxConfig(*TALL), **kw)
    tstep = batch.make_batched_step(ComposerConfig(*TALL), **kw)
    sched = _tall_schedule()[:6]
    jstate = jbatch.SessionState.create(sched.shape[1])
    tstate = batch.SessionState.create(sched.shape[1], device="cpu")
    for offs in sched:
        jstate, jouts = jstep(jstate, jnp.asarray(offs))
        tstate, touts = tstep(tstate, torch.as_tensor(offs))
        _assert_outputs_equal(touts, jouts)
        _assert_state_equal(tstate, jstate)
    # Without waypoint emission no session registers one.
    assert bool(tstate.wp_count.any()) == emit_waypoints
