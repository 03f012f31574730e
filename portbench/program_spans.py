"""The program's own spans and counters (the composer's tracer,
`h264_scroll_encoder_tpu_torch.utils.trace.TRACER`), read for one cell.

  segment(drv, t, steps)   `steps` more steps of a loop with the tracer
                           recording (no profiler, no harness span),
                           then a synchronise: the tracer's summary.
  readings(summary)        the per-layer readings of such a summary, by
                           name (None where a reading does not exist,
                           such as node counts on the CPU).
  idle_by_span(events, harness_spans)
                           the idle time of a traced window (the same
                           window, busy time and idle total as
                           yardstick.summarize_trace), each idle piece
                           inside a harness span put down to the
                           innermost program span that covers it.

Run alone, it measures one cell on the card and prints one JSON line:

    python3 portbench/program_spans.py --workload <cell> --seed <n>

the mean host time a step with the tracer off and on, in turns (three
rounds of off, on, on, off, 200 steps each); a synchronised window with
CUDA events around each step's graph call, as a traced run of
portbench/run.py has it; the tracer's segment and its readings.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h264_scroll_encoder_tpu_torch.utils.trace import SPANS, TRACER  # noqa: E402
from portbench import drive, harness, yardstick  # noqa: E402


def segment(drv, t: int, steps: int):
    """(the tracer's summary over `steps` steps from step t; the next
    step)."""
    TRACER.clear()
    with TRACER.recording():
        for i in range(steps):
            drv.step(t + i, drive.no_span)
        drv.sync()
    summary = TRACER.summary()
    TRACER.clear()
    return summary, t + steps


def readings(summary) -> dict:
    """{metric name: value or None} of a tracer summary."""
    names = ("graph_nodes", "graph_copy_mb", "graph_host_us",
             "graph_device_ms", "compact_device_ms", "session_self_us")
    if not summary:
        return dict.fromkeys(names)
    spans, c = summary["spans"], summary["counters"]
    replays = c.get("graphs.replays", 0)

    def span(name, key):
        return spans.get(name, {}).get(key)

    copied = c.get("graphs.input_bytes", 0) + c.get("graphs.output_bytes", 0)
    return {
        "graph_nodes": c.get("graphs.nodes", 0) / replays if replays else None,
        "graph_copy_mb": copied / replays / 1e6 if replays else None,
        "graph_host_us": span("graphs.call", "host_us"),
        "graph_device_ms": span("graphs.call", "device_ms"),
        "compact_device_ms": span("batch.compact", "device_ms"),
        "session_self_us": span("session.frame", "self_us"),
    }


def _innermost(spans, outer):
    """The pieces of the nested (start, end, name) spans that lie inside a
    span named in `outer`, each named by the innermost span covering it:
    [(start, end, name)], sorted and not overlapping (of two spans over
    the same interval, the one not in `outer` is the inner)."""
    edges = sorted({x for a, b, _ in spans for x in (a, b)})
    by_start = sorted(spans)
    pieces, active, j = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while j < len(by_start) and by_start[j][0] <= a:
            active.append(by_start[j])
            j += 1
        active = [s for s in active if s[1] > a]
        if any(s[2] in outer for s in active):
            inner = max(active, key=lambda s: (s[0], -s[1], s[2] not in outer))
            pieces.append((a, b, inner[2]))
    return pieces


def idle_by_span(events, harness_spans, program_spans=SPANS):
    """{name: idle seconds} of the WINDOW_SPAN annotation's idle time:
    yardstick.summarize_trace's attribution to the harness spans, with
    each piece inside a harness span put down to the innermost program
    span covering it (what none covers keeps the harness span's name;
    idle time outside every harness span is "between_spans"); None where
    summarize_trace gives None."""
    names = set(harness_spans) | set(program_spans)

    def named(e):
        return e.get("cat") == "user_annotation" and e.get("name") in names

    spans = [(e["ts"], e["ts"] + e["dur"], e["name"])
             for e in events if named(e)]
    flat = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
            for a, b, n in _innermost(spans, set(harness_spans))]
    fine = yardstick.summarize_trace(
        [e for e in events if not named(e)] + flat, names)
    return fine.idle_by_span if fine else None


def _mean_step_ms(drv, t: int, steps: int, on: bool):
    """(mean host ms a step over `steps` steps, tracer on or off; the next
    step)."""
    ctx = TRACER.recording() if on else contextlib.nullcontext()
    a = time.perf_counter()
    with ctx:
        for i in range(steps):
            drv.step(t + i, drive.no_span)
        drv.sync()
    ms = (time.perf_counter() - a) * 1e3 / steps
    TRACER.clear()
    return ms, t + steps


def measure(name: str, seed: int, steps: int = 200, rounds: int = 3,
            device="cuda", batch=None) -> dict:
    _, cell, config, traffic = harness.load_cell(name)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    drv = drive.make(config, traffic, seed, device, batch=batch)
    drv.setup(harness.Workers())
    drv.sync()
    t = drv.warm
    off, on = [], []
    for _ in range(rounds):
        for flag in (False, True, True, False):
            ms, t = _mean_step_ms(drv, t, steps, flag)
            (on if flag else off).append(ms)
    # A traced run's synchronised window: CUDA events around the step's
    # graph call (step_device_ms, session_device_ms).
    spans = harness.Spans(drv.sync)
    drv.timed = True
    for i in range(traffic["trace_steps"]):
        drv.step(t + i, spans)
    t += traffic["trace_steps"]
    device_s = drv.device_seconds()
    drv.timed = False
    summary, t = segment(drv, t, traffic["trace_steps"])
    drv.close()
    return {
        "cell": name, "seed": seed, "card": harness._card(device),
        "steps_per_segment": steps,
        "step_ms_tracer_off": off, "step_ms_tracer_on": on,
        "tracer_cost_pct": 100.0 * (statistics.median(on)
                                    / statistics.median(off) - 1),
        "events_device_ms": (1e3 * sum(device_s) / len(device_s)
                             if device_s else None),
        "readings": readings(summary), "summary": summary,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/program_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
