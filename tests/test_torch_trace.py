"""The composer's tracer (utils/trace.TRACER) at the served paths' layer
boundaries: nothing recorded or annotated while it is off, the span tree
and counters of a session frame and a batched step while it records, the
profiler annotations, the serving demo's report, the buffer's bound; on
the card, the graphs' node counts against known graphs and the profiler.

The CPU tests need no card.  The tests marked `cuda` skip without one;
this file imports no jax, so on the card it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import json

import pytest
import torch

from h264_scroll_encoder_tpu_torch import _kernels
from h264_scroll_encoder_tpu_torch.config import (ComposerConfig,
                                                  MAX_EBSP_INSERTIONS)
from h264_scroll_encoder_tpu_torch.models import scroll
from h264_scroll_encoder_tpu_torch.ops import emit_fused, grid
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.session import ComposerSession
from h264_scroll_encoder_tpu_torch.utils import graphs, trace
from h264_scroll_encoder_tpu_torch.utils.trace import TRACER, StageTimer

# Tall enough that 496 px is a waypoint offset with its reference frame.
TALL = (64, 1024)


@pytest.fixture
def tracer():
    """TRACER cleared and off, before and after the test."""
    TRACER.disable()
    TRACER.clear()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _session(device="cpu", size=TALL):
    s = ComposerSession(ComposerConfig(*size), device=device)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    return s


def _batched(device="cpu", B=4):
    """A batched scroll step and egress on B sessions."""
    cfg = ComposerConfig(*TALL)
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(B, device=device)
    offsets = torch.arange(4, 4 * B + 1, 4, dtype=torch.int32, device=device)
    _state, out = step(state, offsets)
    cap = B * out[0].shape[1]
    batch.compact_batch_nal(out[0], out[1], cap)
    return cap


def _fail(*_a, **_k):
    raise AssertionError("called while the tracer and the profiler are off")


def test_off_records_nothing_and_annotates_nothing(tracer, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _fail)
    monkeypatch.setattr(torch.cuda, "Event", _fail)
    s = _session()
    s.write_scroll_or_waypoint_frame(4)
    s.write_scroll_frame(496)
    _batched()
    assert not tracer.records and not tracer.counters
    assert tracer.dropped == 0
    assert tracer.span("session.frame") is tracer.span("graphs.call")


def test_session_frame_spans_form_one_tree(tracer):
    s = _session()
    s.write_scroll_or_waypoint_frame(4)
    with tracer.recording():
        s.write_scroll_or_waypoint_frame(8)
    assert not tracer.on
    recs = list(tracer.records)
    assert sorted(r.name for r in recs) == [
        "graphs.call", "graphs.key", "session.fetch", "session.frame"]
    assert {r.name for r in recs} <= set(trace.SPANS)
    by = {r.name: r for r in recs}
    top = by["session.frame"]
    assert top.parent is None and {r.root for r in recs} == {top.id}
    assert by["graphs.call"].parent == top.id
    assert by["session.fetch"].parent == top.id
    assert by["graphs.key"].parent == by["graphs.call"].id
    assert len({r.id for r in recs}) == len(recs)
    # Self times add up to the top span's duration; a child lies inside
    # its parent.
    assert sum(r.self_ns for r in recs) == top.host_ns
    assert all(0 <= r.self_ns <= r.host_ns for r in recs)
    for r in recs:
        if r.parent is not None:
            p = next(q for q in recs if q.id == r.parent)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    c = tracer.counters
    assert c["session.frames"] == 1 and c["session.waypoint_frames"] == 0
    assert c["session.exact_retries"] == 0
    assert c["session.bytes"] == len(s.writer._chunks[-1])
    # No device on the CPU path: no device time, no replay counted.
    assert "device_ms" not in tracer.summary()["spans"]["graphs.call"]
    assert "graphs.replays" not in c


def test_frames_get_their_own_ids_and_waypoints_count(tracer):
    s = _session()
    with tracer.recording():
        s.write_scroll_or_waypoint_frame(4)
        s.write_scroll_frame(496)         # a waypoint frame, then a scroll
    tops = [r for r in tracer.records if r.name == "session.frame"]
    assert len(tops) == 2 and tops[0].id != tops[1].id
    for top in tops:
        inner = [r for r in tracer.records if r.root == top.id]
        assert sum(r.self_ns for r in inner) == top.host_ns
    second = [r.name for r in tracer.records if r.root == tops[1].id]
    assert second.count("graphs.call") == 2
    assert second.count("session.fetch") == 2
    c = tracer.counters
    assert c["session.frames"] == 3 and c["session.waypoint_frames"] == 1
    summary = tracer.summary()
    assert summary["spans"]["session.frame"]["calls"] == 2
    assert summary["counters"]["session.exact_retries"] == 0
    assert set(trace.COUNTERS) <= set(summary["counters"])
    rep = json.loads(tracer.report_json())
    assert rep["spans"]["graphs.call"]["calls"] == 3
    assert rep["counters"]["session.frames"] == 3


def test_batched_step_and_egress(tracer):
    with tracer.recording():
        cap = _batched(B=4)
    names = [r.name for r in tracer.records]
    assert names.count("graphs.call") == 1
    assert names.count("batch.compact") == 1
    assert set(names) <= set(trace.SPANS)
    assert all(r.parent is None or r.name == "graphs.key"
               for r in tracer.records)
    assert tracer.counters["batch.compact_positions"] == cap


def test_profiler_annotates_each_span(tracer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    s = _session()
    s.write_scroll_or_waypoint_frame(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.write_scroll_or_waypoint_frame(8)
        _batched()
    assert not tracer.records and not tracer.counters
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"session.frame", "graphs.call", "graphs.key", "session.fetch",
            "batch.compact"} <= names


def test_serving_demo_reports_every_layer(tracer):
    from h264_scroll_encoder_tpu_torch.examples import serving_demo

    lines = []
    serving_demo.run("cpu", width=64, n_sessions=2, n_frames=32,
                     log=lines.append)
    (line,) = [x for x in lines if x.startswith("trace ")]
    rep = json.loads(line[len("trace "):])
    assert set(rep["counters"]) == set(trace.COUNTERS)
    # No CUDA graph and no kernel launch on the CPU; no frame of the demo
    # overflows; the single session's waypoint frame is its last, so every
    # frame is written against an empty registry.
    assert [k for k, v in rep["counters"].items() if v == 0] == [
        k for k in trace.COUNTERS
        if k.startswith("graphs.") or k in (
            "session.exact_retries", "session.waypoints", "emit.chunks",
            "grid.wide_launches")]
    assert rep["counters"]["session.waypoint_frames"] == 1
    assert rep["counters"]["session.frames"] == 32
    assert {"graphs.call", "graphs.key", "session.frame", "session.fetch",
            "batch.compact"} <= set(rep["spans"])


# A 64-px-wide 4K-high session: four waypoints over the 0..2,144 px page.
TALL_4K = (64, 2160)
DEEP_OFFSETS = [8, 496, 504, 992, 1000, 1488, 1984, 2144, 1500, 8]


def test_session_counts_registry_depth_and_fetch_bytes(tracer):
    """`session.waypoints` sums the registry's depth each frame is written
    against, `session.fetch_bytes` is each frame's bounded NAL buffer
    (the 16 bits/MB fast budget) and its length and flag."""
    s = _session(size=TALL_4K)
    depths = []
    with tracer.recording():
        for off in DEEP_OFFSETS:
            depths.append(s.waypoints.count)
            s.write_scroll_or_waypoint_frame(off)
    assert depths == [0, 0, 1, 1, 2, 2, 3, 4, 4, 4]
    c = tracer.counters
    assert c["session.frames"] == len(DEEP_OFFSETS)
    assert c["session.waypoint_frames"] == 4
    assert c["session.waypoints"] == sum(depths)
    n_nal = emit_fused.nal_bytes(
        scroll._n_rbsp(s.cfg.total_mbs, scroll.SCROLL_FAST_RBSP_BITS_PER_MB),
        MAX_EBSP_INSERTIONS)
    assert c["session.fetch_bytes"] == len(DEEP_OFFSETS) * (n_nal + 5)
    assert c["session.bytes"] == sum(len(x) for x in
                                     s.writer._chunks[-len(DEEP_OFFSETS):])
    assert {"emit.chunks", "grid.wide_launches"}.isdisjoint(c)


def test_no_counter_moves_while_off(tracer):
    """The same frames with the tracer off: no counter, no span."""
    s = _session(size=TALL_4K)
    for off in DEEP_OFFSETS:
        s.write_scroll_or_waypoint_frame(off)
    assert s.waypoints.count == 4
    assert not tracer.counters and not tracer.records


class _FakeEntry:
    """A kernel library entry that launches nothing and succeeds."""

    def __call__(self, *_a):
        return 0


@pytest.mark.parametrize("capturing", [False, True])
def test_launch_counts_go_to_the_tracer_or_the_capture(tracer, monkeypatch,
                                                       capturing):
    """A launch's plan counts reach the tracer while it records, nothing
    while it is off, and the captured tally (which utils/graphs counts on
    each replay), beside the launch itself, while a graph is captured."""
    k = _kernels.Kernel("h264t_none", [])
    k._fn = _FakeEntry()
    monkeypatch.setattr(_kernels, "_capturing", lambda: capturing)
    counts = {"emit.chunks": 8, "grid.wide_launches": 1}
    before = _kernels.captured_counts()
    k.launch(counts=counts)
    with tracer.recording():
        k.launch(counts=counts)
        k.launch()
    added = _kernels.captured_counts() - before
    if capturing:
        assert k.launches == 0
        assert dict(added) == {k: 3, "emit.chunks": 16,
                               "grid.wide_launches": 2}
        assert not tracer.counters
    else:
        assert k.launches == 3
        assert not added
        assert dict(tracer.counters) == counts


@pytest.mark.parametrize("n,c,k,chunks", [
    (97240, 1, 24, 8),      # a 3840x2160 scroll frame (wide layout)
    (7240, 1, 15, 1),       # a 1280x720 scroll frame
    (129640, 8, 33, 8),     # a 4K hint frame on a cluster of 8
    (129640, 2, 33, 8),     # the same on a forced cluster of 2
])
def test_staged_chunks_follow_the_launch_geometry(n, c, k, chunks):
    if c == 1:
        assert emit_fused.items_per_thread(n) == k
    else:
        assert emit_fused.cluster_items_per_thread(n, c) == k
    assert emit_fused.staged_chunks(n, c, k) == chunks


def test_wide_launches_count_past_the_narrow_layout():
    assert grid._wide_count(grid.NARROW_MAX_MBS) is None
    assert grid._wide_count(45 * 80) is None
    assert grid._wide_count(135 * 240) == {"grid.wide_launches": 1}


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 4)
    t = StageTimer()
    with t.recording():
        for _ in range(10):
            with t.span("graphs.call"):
                with t.span("graphs.key"):
                    pass
    assert len(t.records) == 4 and t.dropped == 16
    assert t.summary()["dropped"] == 16
    t.clear()
    assert not t.records and t.dropped == 0
    # A fresh timer records no span until enabled, and reports as before.
    t = StageTimer()
    with t.span("graphs.call"):
        pass
    assert not t.records and "spans" not in t.report()


# ---------------------------------------------------------------------------
# On the card: node counts read from the captured CUDA graph.
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs and the kernel "
                    "library have no CPU mode")
    return torch.device("cuda", 0)


def _device_ops(prof_events, window):
    """Kernels, copies and fills inside the `window` annotation."""
    w = next(e for e in prof_events if e.get("name") == window
             and e.get("cat") == "user_annotation")
    return [e for e in prof_events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and w["ts"] <= e["ts"] <= w["ts"] + w["dur"]]


@pytest.mark.cuda
def test_three_elementwise_ops_are_three_nodes(dev, tracer):
    g = graphs.graphed(lambda x: ((x + 1) * 2) - 3, "three ops")
    x = torch.ones(1024, device=dev)
    g(x)                                 # eager, then the capture
    (stats,) = g.stats()
    assert stats["nodes"] == 3
    cap = next(iter(g.graphs.values()))
    assert _kernels.graph_nodes(cap.graph.raw_cuda_graph()) == {
        "kernel": 3, "memcpy": 0, "memset": 0, "other": 0}
    with tracer.recording():
        y = g(x + 1)                     # ((2 + 1) * 2) - 3
    assert torch.equal(y, torch.full_like(x, 3.0))
    c = tracer.counters
    assert c["graphs.replays"] == 1 and c["graphs.nodes"] == 3
    assert c["graphs.input_bytes"] == 4096 and c["graphs.output_bytes"] == 4096
    call = tracer.summary()["spans"]["graphs.call"]
    assert call["device_ms"] > 0


@pytest.mark.cuda
def test_session_frame_nodes_are_the_profilers_device_ops(dev, tracer,
                                                          tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    s = _session(dev, (1280, 720))
    s.write_scroll_or_waypoint_frame(4)
    s.write_scroll_or_waypoint_frame(8)
    (cap,) = s._scroll_fn.graphs.values()
    kinds = _kernels.graph_nodes(cap.graph.raw_cuda_graph())
    assert kinds["other"] == 0 and 100 < cap.nodes < 200
    counts = []
    for i in range(3):               # the profiler can drop a window's ops
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cap.graph.replay()       # events a trace starts on can be lost
            torch.cuda.synchronize()
            with record_function("one replay"):
                cap.graph.replay()
                torch.cuda.synchronize()
        path = tmp_path / f"trace{i}.json"
        prof.export_chrome_trace(str(path))
        ops = _device_ops(json.loads(path.read_text())["traceEvents"],
                          "one replay")
        counts.append(len(ops))
    assert max(counts) == cap.nodes, (counts, kinds)
    # The frame's spans, annotated under the profiler, and recorded.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracer.recording():
            s.write_scroll_or_waypoint_frame(12)
    path = tmp_path / "frame.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"session.frame", "graphs.call", "graphs.key", "graphs.inputs",
            "graphs.replay", "graphs.outputs", "session.fetch"} <= names
    c = tracer.counters
    assert c["graphs.replays"] == 1 and c["graphs.nodes"] == cap.nodes
    spans = tracer.summary()["spans"]
    assert spans["graphs.call"]["device_ms"] > 0
