"""portbench/program_spans.py on the CPU: the idle time of a traced window
put down to the program's innermost span, with the same totals as the
yardstick's reduction; the readings of a tracer summary; one small
measurement of each cell."""

import pytest

from portbench import harness, program_spans, yardstick
from portbench_cases import CELLS, SEED


def _ann(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _kernel(ts, dur, cat="kernel"):
    return {"cat": cat, "name": "k", "ts": ts, "dur": dur}


HARNESS = [_ann(yardstick.WINDOW_SPAN, 0, 100), _ann("step", 0, 50),
           _ann("egress", 50, 40),
           _kernel(10, 20), _kernel(20, 20), _kernel(70, 10, "gpu_memcpy"),
           _kernel(200, 10)]
# Program spans nested in the harness spans and in each other.
PROGRAM = [_ann("graphs.call", 5, 40), _ann("graphs.key", 5, 2),
           _ann("graphs.replay", 8, 4), _ann("batch.compact", 55, 25)]


def test_idle_goes_to_the_innermost_program_span():
    events = HARNESS + PROGRAM
    coarse = yardstick.summarize_trace(events, harness.SPANS)
    assert coarse == yardstick.summarize_trace(HARNESS, harness.SPANS)
    fine = program_spans.idle_by_span(events, harness.SPANS)
    # Idle pieces [0, 10), [40, 70), [80, 100): [0, 5) step, [5, 7)
    # graphs.key, [7, 8) graphs.call, [8, 10) graphs.replay, [40, 45)
    # graphs.call, [45, 50) step, [50, 55) egress, [55, 70) batch.compact,
    # [80, 90) egress, [90, 100) between_spans.
    assert fine == pytest.approx({
        "step": 10e-6, "graphs.key": 2e-6, "graphs.call": 6e-6,
        "graphs.replay": 2e-6, "egress": 15e-6, "batch.compact": 15e-6,
        "between_spans": 10e-6})
    assert sum(fine.values()) == pytest.approx(
        sum(coarse.idle_by_span.values()))
    assert coarse.window_s == pytest.approx(100e-6)
    assert coarse.busy_s == pytest.approx(40e-6)
    # Without program spans the attribution is the yardstick's.
    assert program_spans.idle_by_span(HARNESS, harness.SPANS) == \
        pytest.approx(coarse.idle_by_span)
    assert program_spans.idle_by_span(HARNESS[1:], harness.SPANS) is None


def test_a_program_span_over_a_whole_harness_span_takes_its_idle():
    # graphs.call spans all of `step`; a program span outside every
    # harness span takes nothing.
    events = HARNESS + [_ann("graphs.call", 0, 50),
                        _ann("session.fetch", 92, 6)]
    fine = program_spans.idle_by_span(events, harness.SPANS)
    assert fine == pytest.approx({"graphs.call": 20e-6, "egress": 30e-6,
                                  "between_spans": 10e-6})


def test_readings_of_a_summary():
    summary = {
        "spans": {"graphs.call": {"calls": 4, "host_us": 30.0,
                                  "self_us": 10.0, "device_ms": 1.5},
                  "batch.compact": {"calls": 4, "host_us": 50.0,
                                    "self_us": 50.0, "device_ms": 0.5},
                  "session.frame": {"calls": 4, "host_us": 90.0,
                                    "self_us": 20.0}},
        "counters": {"graphs.replays": 4, "graphs.nodes": 4400,
                     "graphs.input_bytes": 2_000_000,
                     "graphs.output_bytes": 6_000_000},
        "dropped": 0}
    assert program_spans.readings(summary) == {
        "graph_nodes": 1100.0, "graph_copy_mb": 2.0, "graph_host_us": 30.0,
        "graph_device_ms": 1.5, "compact_device_ms": 0.5,
        "session_self_us": 20.0}
    assert set(program_spans.readings(None).values()) == {None}
    cpu = {"spans": {"graphs.call": {"calls": 1, "host_us": 3.0,
                                     "self_us": 1.0}},
           "counters": {"graphs.replays": 0}, "dropped": 0}
    got = program_spans.readings(cpu)
    assert got["graph_host_us"] == 3.0
    assert got["graph_nodes"] is None and got["graph_device_ms"] is None


@pytest.mark.parametrize("cell", CELLS)
def test_measure_a_cell_on_the_cpu(cell):
    out = program_spans.measure(cell, SEED, steps=2, rounds=1, device="cpu",
                                batch=4)
    r = out["readings"]
    assert r["graph_host_us"] > 0
    assert r["graph_nodes"] is None and r["graph_device_ms"] is None
    spans = out["summary"]["spans"]
    if cell == "scroll.session_b1":
        assert r["session_self_us"] > 0 and r["compact_device_ms"] is None
        assert spans["session.frame"]["calls"] == spans["graphs.call"]["calls"]
        assert out["summary"]["counters"]["session.frames"] > 0
    else:
        assert r["session_self_us"] is None
        assert spans["batch.compact"]["calls"] == spans["graphs.call"]["calls"]
        assert out["summary"]["counters"]["batch.compact_positions"] > 0
    assert len(out["step_ms_tracer_on"]) == 2
