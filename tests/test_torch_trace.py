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
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
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
    # No CUDA graph on the CPU; no frame of the demo overflows.
    assert [k for k, v in rep["counters"].items() if v == 0] == [
        k for k in trace.COUNTERS
        if k.startswith("graphs.") or k == "session.exact_retries"]
    assert rep["counters"]["session.waypoint_frames"] == 1
    assert rep["counters"]["session.frames"] == 32
    assert {"graphs.call", "graphs.key", "session.frame", "session.fetch",
            "batch.compact"} <= set(rep["spans"])


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
    assert kinds["other"] == 0 and cap.nodes > 1000
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
