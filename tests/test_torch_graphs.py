"""The port's compiled steps (utils/graphs, the counterpart of jax.jit) on
the CPU: the scroll step and run_frames, the hint step, and the session's
frames (scroll and waypoint, their ebsp_exact retries, the sliced frame,
the hint frame).  The rows and dense splice steps are in
test_torch_graphs_splice.py.

A CUDA graph replays the launches of one run on new values in the same
buffers, so a step may hold no host sync, no data-dependent shape and no
per-call value outside its tensor arguments.  Each path is therefore:
  - checked for capture hazards (capture_hazards below: host data copied
    onto the device, reads of device values on the host);
  - traced once with make_fx(tracing_mode="fake"), which fails on host
    syncs and data-dependent shapes as a capture does;
  - replayed on a second seeded input set (other frame numbers, offsets
    and registries, other hints), where the replay must equal the eager
    port and the JAX package's jitted function exactly (NAL bytes,
    lengths, bits, flags and the next state).
Also graphed()'s key, its CPU pass-through and the launch counters'
bookkeeping of replays, on stubs.  Inputs come from numpy seeds.
"""

import functools
import traceback
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode

from h264_scroll_encoder_tpu import session as jsession
from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import hints as jhints
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.models import splice as jsplice
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu_torch import _kernels, session
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import hints
from h264_scroll_encoder_tpu_torch.models.splice import FrameHints, MotionRegion
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.utils import graphs

torch.set_num_threads(1)

TALL = (64, 1024)           # 4 x 64 MBs: offsets reach the 496 px waypoints


_FROM_HOST = {"tensor", "as_tensor", "asarray"}
_TO_HOST = {"item", "tolist", "cpu", "numpy", "__bool__", "__int__",
            "__float__", "__index__"}


class _Hazards(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.host_made = weakref.WeakSet()
        self.found = []

    def _note(self, what):
        here = [f for f in traceback.extract_stack()[:-2]
                if "h264_scroll_encoder_tpu_torch" in f.filename]
        where = here[-1] if here else traceback.extract_stack()[-3]
        self.found.append(f"{what} at {Path(where.filename).name}:"
                          f"{where.lineno}")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        out = func(*args, **kwargs)
        first = args[0] if args else None
        if name in _FROM_HOST and not isinstance(first, torch.Tensor):
            if kwargs.get("device") is not None:
                self._note(f"torch.{name} of host data onto a device")
            elif isinstance(out, torch.Tensor):
                self.host_made.add(out)
        elif isinstance(first, torch.Tensor):
            if (name in ("to", "cuda") and first in self.host_made
                    and (kwargs.get("device") is not None or any(
                        isinstance(a, (str, torch.device)) for a in args[1:]))):
                self._note(f"a host tensor's .{name} onto a device")
            elif name in _TO_HOST and first not in self.host_made:
                self._note(f"Tensor.{name}, a wait for the device")
        return out


def capture_hazards(fn, *args):
    """Runs fn on CPU tensors and lists what a CUDA capture of it would
    refuse or freeze: host data copied onto the device (torch.tensor or
    as_tensor of Python or numpy values with a device, or .to(device) of a
    tensor made so) and reads of a tensor's values on the host (.item(),
    .cpu(), bool(), ...), each with its file and line."""
    with _Hazards() as mode:
        fn(*args)
    return mode.found


def traced(fn, *args):
    """fn's capture hazards (none allowed), then its make_fx trace."""
    assert capture_hazards(fn, *args) == []
    return make_fx(fn, tracing_mode="fake")(*args)


def assert_same(got, *wants):
    """Every leaf of got equal to the same leaf of each want, exactly."""
    g = [np.asarray(x).astype(np.int64) for x in pytree.tree_leaves(got)]
    for want in wants:
        w = [np.asarray(x).astype(np.int64) for x in jax.tree_util.tree_leaves(
            want)] if not isinstance(want, list) else want
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b).astype(np.int64))


def _leaves(x):
    return [np.asarray(v) for v in pytree.tree_leaves(x)]


def _registry(rng, B, height=TALL[1], *, waypoint_first=False):
    """Seeded per-session registries (count 0..8 at multiples of 496 px)
    and offsets, a third of them exact waypoints; with waypoint_first,
    session 0 has an empty registry and must emit the 496 px waypoint."""
    count = rng.integers(0, MAX_WAYPOINTS + 1, B)
    if waypoint_first:
        count[0] = 0
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    live = slot < count[:, None]
    offs = rng.integers(0, height + 1, B)
    offs[: B // 3] = 496 * rng.integers(1, 3, B // 3)
    if waypoint_first:
        offs[0] = 496
    return dict(frame_num=rng.integers(2, 40, B).astype(np.int32),
                wp_offsets=((slot + 1) * 496 * live).astype(np.int32),
                wp_ltidx=((2 + slot) * live).astype(np.int32),
                wp_valid=live, wp_count=count.astype(np.int32),
                offsets=offs.astype(np.int32))


_FIELDS = ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid", "wp_count")


# ---------------------------------------------------------------------------
# The scroll step and run_frames.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enable_pskip", [False, True])
def test_scroll_step_trace_replays_new_inputs(enable_pskip):
    """make_batched_step traced on one batch of sessions, replayed on
    another (frame numbers, registries, offsets): equal to its eager run
    and to the JAX package's jit(vmap) step, the next state included."""
    cfg = ComposerConfig(*TALL)
    step = batch.make_batched_step(cfg, enable_pskip=enable_pskip)
    jstep = jbatch.make_batched_step(JaxConfig(*TALL),
                                     enable_pskip=enable_pskip)
    first, second = (_registry(np.random.default_rng(s), 4,
                               waypoint_first=True) for s in (1, 2))

    def port(r):
        return (batch.SessionState.from_numpy(r, device="cpu"),
                torch.as_tensor(r["offsets"]))

    gm = traced(step.eager, *port(first))
    got = gm(*port(second))
    jstate = jbatch.SessionState(*(jnp.asarray(second[f]) for f in _FIELDS))
    want = jstep(jstate, jnp.asarray(second["offsets"]))
    assert_same(got, _leaves(step.eager(*port(second))), want)
    assert bool(got[1][2].any()), "no session emitted a waypoint"


def test_run_frames_replays_the_traced_step():
    """run_frames' T steps as replays of one trace, against the JAX
    package's run_frames (lax.scan) over the same schedule."""
    cfg = ComposerConfig(*TALL)
    rng = np.random.default_rng(3)
    T, B = 6, 3
    sched = np.cumsum(rng.integers(0, 200, (T, B)), axis=0).astype(np.int32)
    sched[2, 0] = 496
    state = batch.SessionState.create(B, device="cpu")
    gm = traced(batch.make_batched_step(cfg).eager, state,
                torch.as_tensor(sched[0]))
    outs = []
    for t in range(T):
        state, (nal, nal_len, wp, bits, ovf) = gm(state,
                                                  torch.as_tensor(sched[t]))
        outs.append((nal_len, wp, bits, batch._checksum(nal), ovf))
    got = (state, tuple(torch.stack(x) for x in zip(*outs)))
    eager = batch.run_frames(cfg, batch.SessionState.create(B, device="cpu"),
                             sched)
    want = jbatch.run_frames(JaxConfig(*TALL), jbatch.SessionState.create(B),
                             jnp.asarray(sched))
    assert_same(got, _leaves(eager), want)


# ---------------------------------------------------------------------------
# The hint step.
# ---------------------------------------------------------------------------

def _hint_inputs(rng, cfg, B):
    H, W = cfg.mb_height, cfg.mb_width
    r = _registry(rng, B, cfg.height)
    ref = np.zeros((B, H, W), np.int32)
    mv_y = np.zeros((B, H, W), np.int32)
    for b in range(B):
        y0 = int(rng.integers(0, H - 2))
        ref[b, y0:y0 + 2] = rng.integers(0, 2 + r["wp_count"][b])
        mv_y[b, y0:y0 + 2] = 4 * rng.integers(-60, 61)
    return (r["frame_num"], ref, np.zeros_like(ref), mv_y, r["wp_count"],
            r["wp_ltidx"], r["wp_valid"])


@pytest.mark.parametrize("compact_x", [False, True])
def test_hint_step_trace_replays_new_inputs(compact_x):
    cfg = ComposerConfig(64, 96)
    step = batch.make_batched_hint_step(cfg, compact_x=compact_x,
                                        device="cpu")
    jstep = jbatch.make_batched_hint_step(JaxConfig(64, 96),
                                          compact_x=compact_x)
    first, second = (_hint_inputs(np.random.default_rng(s), cfg, 3)
                     for s in (4, 5))
    gm = traced(step.eager, *map(torch.as_tensor, first))
    got = gm(*map(torch.as_tensor, second))
    want = jstep(*map(jnp.asarray, second))
    assert_same(got, _leaves(step(*second)), want)


# ---------------------------------------------------------------------------
# The session's frames.
# ---------------------------------------------------------------------------

def _session_row(rng, height=TALL[1]):
    """One session's packed row (session.FRAME_ROW) and its JAX args."""
    r = _registry(rng, 1, height)
    row = np.concatenate([r["frame_num"], r["offsets"], r["wp_offsets"][0],
                          r["wp_ltidx"][0], r["wp_valid"][0].astype(np.int32),
                          r["wp_count"]]).astype(np.int32)
    jargs = (jnp.int32(r["frame_num"][0]), jnp.int32(r["offsets"][0]),
             jnp.asarray(r["wp_offsets"][0]), jnp.asarray(r["wp_ltidx"][0]),
             jnp.asarray(r["wp_valid"][0]), jnp.int32(r["wp_count"][0]))
    return torch.as_tensor(row), jargs


@pytest.mark.parametrize("kind,policy,exact", [
    ("scroll_frame", "floor", False), ("scroll_frame", "floor", True),
    ("waypoint_frame", "floor", False), ("waypoint_frame", "floor", True),
    ("scroll_frame", "partitioned", False)])
def test_session_frame_trace_replays_new_inputs(kind, policy, exact):
    """session.graphed_frame (the JAX session's _jitted_scroll and
    _jitted_waypoint, with their ebsp_exact retries) traced on one packed
    row and replayed on another."""
    cfg = ComposerConfig(*TALL)
    fn = session.graphed_frame(kind, cfg, False, policy, exact)
    jitted = (jsession._jitted_scroll if kind == "scroll_frame"
              else jsession._jitted_waypoint)
    jfn = jitted(JaxConfig(*TALL), False, policy, ebsp_exact=exact)
    (row1, _), (row2, jargs) = (_session_row(np.random.default_rng(s))
                                for s in (6, 7))
    gm = traced(fn.eager, row1)
    got = gm(row2)
    assert_same(got, _leaves(fn.eager(row2)), [np.asarray(x)[None] for x in
                                               jfn(*jargs)])


def test_session_sliced_frame_trace_replays_new_inputs():
    """session.graphed_sliced_frame traced at one slice height on one row
    and replayed on another, against the JAX scroll_frame_sliced."""
    cfg, rows = ComposerConfig(*TALL), 16
    fn = session.graphed_sliced_frame(cfg, True)
    (row1, _), (row2, jargs) = (_session_row(np.random.default_rng(s))
                                for s in (8, 9))
    gm = traced(lambda row: fn.eager(row, rows), row1)
    got = gm(row2)
    want = jax.jit(functools.partial(
        jscroll.scroll_frame_sliced, JaxConfig(*TALL), rows_per_slice=rows,
        enable_pskip=True))(*jargs)
    assert got[0].shape[:2] == (1, 4)
    assert_same(got, _leaves(fn.eager(row2, rows)),
                [np.asarray(x)[None] for x in want])


def _frame_hints(rng, cfg, count):
    regions = []
    for _ in range(2):
        y0 = int(rng.integers(0, cfg.mb_height - 3))
        x0 = int(rng.integers(0, cfg.mb_width - 2))
        regions.append((x0, y0, x0 + 2, y0 + 3, int(rng.integers(0, 2 + count)),
                        0, int(rng.integers(-40, 41))))
    return regions


def test_session_hint_frame_trace_replays_new_inputs():
    """hints.graphed_hint_frame (the JAX _jitted_hint_frame) traced on one
    frame's packed row and replayed on another frame's hints and
    registry."""
    cfg, jcfg = ComposerConfig(96, 64), JaxConfig(96, 64)
    fn = hints.graphed_hint_frame(cfg, True)
    rows, jwant = [], None
    for seed in (10, 11):
        rng = np.random.default_rng(seed)
        count = int(rng.integers(0, MAX_WAYPOINTS + 1))
        regions = _frame_hints(rng, cfg, count)
        lt = [2 + k if k < count else 0 for k in range(MAX_WAYPOINTS)]
        valid = np.arange(MAX_WAYPOINTS) < count
        frame_num = int(rng.integers(2, 40))
        rows.append(torch.as_tensor(hints.hint_frame_row(
            cfg, frame_num, FrameHints(motion_regions=tuple(
                MotionRegion(*r) for r in regions)), count, lt, valid)))
        jwant = jhints.emit_hint_frame(
            jcfg, frame_num, jsplice.FrameHints(motion_regions=tuple(
                jsplice.MotionRegion(*r) for r in regions)),
            enable_pskip=True, num_waypoints=count,
            wp_ltidx=jnp.asarray(lt, jnp.int32), wp_valid=jnp.asarray(valid))
    gm = traced(fn.eager, rows[0])
    got = gm(rows[1])
    assert_same(got, _leaves(fn.eager(rows[1])),
                [np.asarray(x)[None] for x in jwant])


# ---------------------------------------------------------------------------
# graphed() itself, and the launch counters.
# ---------------------------------------------------------------------------

def test_graphed_key_and_cpu_pass_through():
    """The key holds every non-tensor argument and each tensor leaf's
    shape, dtype, device and strides (dicts flattened); on CPU tensors the
    step runs eagerly and captures nothing."""
    calls = []

    def fn(x, d, *, scale):
        calls.append(scale)
        return x * scale + d["b"].sum()

    g = graphs.graphed(fn, "stub step")
    x, d = torch.arange(6).reshape(2, 3), {"b": torch.ones(2), "a": 3}
    assert torch.equal(g(x, d, scale=2), fn(x, d, scale=2))
    assert g.captures == 0 and not g.graphs and calls == [2, 2]
    assert g.eager is fn

    key = g.key
    base = key(x, d, scale=2)
    assert base == key(x + 1, {"b": torch.zeros(2), "a": 3}, scale=2)
    for other in (key(x, d, scale=3),                         # static arg
                  key(x.reshape(3, 2), d, scale=2),           # shape
                  key(x.to(torch.int32), d, scale=2),         # dtype
                  key(x.t().contiguous().t(), d, scale=2),    # strides
                  key(x, {"b": torch.ones(2), "a": 4}, scale=2),
                  key(x, {"b": torch.ones(3), "a": 3}, scale=2),
                  key(x, {"b": torch.ones(2), "c": 3}, scale=2)):
        assert other != base
    with pytest.raises(TypeError, match="hashable"):
        key(x, {"b": torch.ones(2), "a": {3}}, scale=2)


def test_step_factories_share_one_step_per_configuration():
    """A factory's step is cached on its bound arguments, defaults
    applied, so every caller of one configuration shares its graphs."""
    cfg = ComposerConfig(64, 64)
    step = batch.make_batched_step(cfg)
    assert step is batch.make_batched_step(ComposerConfig(64, 64),
                                           enable_pskip=False,
                                           emit_waypoints=True)
    assert step is not batch.make_batched_step(cfg, enable_pskip=True)
    assert session.graphed_frame("scroll_frame", cfg, False) is \
        session.graphed_frame("scroll_frame", cfg, False, "floor",
                              ebsp_exact=False)
    assert batch.make_batched_splice_step_rows(cfg, 1, 1, 2, 2) is \
        batch.make_batched_splice_step_rows(cfg, 1, 1, 2, 2, 2,
                                            compact_x=False)


def test_graphed_places_numpy_and_scalars_stay_static():
    """A step with a CPU device runs eagerly on numpy arguments; a step
    graphed for a card places numpy leaves there before it keys them."""
    g = graphs.graphed(lambda a, k: torch.as_tensor(a) + k, "stub", "cpu")
    assert torch.equal(g(np.arange(3), 2), torch.tensor([2, 3, 4]))
    assert g.captures == 0
    assert graphs._place(np.arange(3), torch.device("cpu")).dtype == \
        torch.int64
    assert graphs._place(5, torch.device("cpu")) == 5


def test_replays_count_the_captured_launches(monkeypatch):
    """A launch made while a graph is captured goes to the captured tally,
    not to `launches`, with its plan counts; each replay counts the
    graph's share of the tally (count_replay): the launches always, the
    plan counts while the tracer records, so launch_counts() and the
    tracer's counters stay truthful under replay."""
    from h264_scroll_encoder_tpu_torch.utils.trace import TRACER

    k1 = _kernels.Kernel("h264t_stub", [], name="stub kernel")
    k1._fn = lambda *a: 0
    monkeypatch.setattr(_kernels, "KERNELS", _kernels.KERNELS + (k1,))
    capturing = [False]
    monkeypatch.setattr(_kernels, "_capturing", lambda: capturing[0])
    k1.launch()
    assert k1.launches == 1
    before = _kernels.captured_counts()
    capturing[0] = True
    k1.launch(counts={"emit.chunks": 8})
    k1.launch()
    capturing[0] = False
    per_replay = dict(_kernels.captured_counts() - before)
    assert per_replay == {k1: 2, "emit.chunks": 8} and k1.launches == 1
    TRACER.disable()
    TRACER.clear()
    try:
        _kernels.count_replay(per_replay)
        with TRACER.recording():
            for _ in range(2):
                _kernels.count_replay(per_replay)
        counters = TRACER.summary()["counters"]
        assert {k: n for k, n in counters.items() if n} == {"emit.chunks": 16}
    finally:
        TRACER.disable()
        TRACER.clear()
    assert _kernels.launch_counts()["stub kernel"] == 1 + 3 * 2
    k1._fn = lambda *a: 700
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        k1.launch()
    assert k1.launches == 7


def test_capture_hazards_finds_host_copies_and_syncs():
    """capture_hazards names what a capture would refuse or freeze."""
    def bad(x):
        y = x + torch.as_tensor(3, device=x.device)     # host copy
        if bool(y.sum() > 0):                           # host read
            y = y * 2
        return y + torch.as_tensor(1)                   # CPU scalar: fine

    found = capture_hazards(bad, torch.ones(2))
    assert len(found) == 2
    assert "host data onto a device" in found[0]
    assert "__bool__" in found[1]
    assert capture_hazards(lambda x: torch.full((2,), 3) + x,
                           torch.ones(2)) == []
