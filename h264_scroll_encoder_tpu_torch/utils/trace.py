"""Observability: per-stage timers, bitstream-position traces, metrics.

Port of h264_scroll_encoder_tpu/utils/trace.py.  The reference's only
observability is printf progress every 50/100 frames (src/main.c:125-127)
and stderr bit-position traces in trans-resizer (trans_resizer.c:1267-1309
— per-row consumed-vs-written bit accounting as inline invariant checks).
Here:

  - `StageTimer`: wall-clock per pipeline stage with call counts and
    counters (frames, bytes).  Device work is asynchronous: a stage closes
    on the caller's own host fetch (bytes copied back, a synchronise)
    inside it, as in the JAX package.
  - `BitstreamTrace`: the parity-debugging mode — record (name, bit
    position) marks while emitting on the host path and diff two traces
    to localize the first diverging syntax element.
  - `torch_profile`: context manager around torch.profiler (CPU activity,
    plus CUDA where a card is present) that writes a Chrome trace.

`StageTimer` is also the composer's tracer: `TRACER`, the module-level
instance, holds the spans and counters that the served paths record at
their layer boundaries (SPANS, COUNTERS: compiled steps in utils/graphs,
the session's frames, egress in parallel/batch).  A span site does work
only in two cases:

  - while the tracer records (`TRACER.enable()` / `disable()`, or `with
    TRACER.recording():`), each span keeps its name, host start and end,
    its parent and the id of the top-level span it runs under, in a
    bounded buffer; a span asked to time the device records one pair of
    CUDA events, resolved only by `summary()`; counters count;
  - while a torch.profiler session records, each span is also a
    `record_function` of the same name, so the composer's layers sit in
    the profiler's trace on the clock of the device's kernels and copies.

Otherwise a span site costs a flag check and the profiler query and
returns a shared null span: no `record_function`, no event, no record.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch

# The composer's spans and counters, by layer.  Spans: a compiled step's
# call (its key and placement, the copies into its static inputs, the
# replay's launch, the clones of its outputs) and capture; a session
# frame and its fetch to the host; egress's compaction.
SPANS = ("graphs.call", "graphs.key", "graphs.inputs", "graphs.replay",
         "graphs.outputs", "graphs.capture", "session.frame",
         "session.fetch", "batch.compact")
COUNTERS = ("graphs.replays", "graphs.captures", "graphs.nodes",
            "graphs.input_bytes", "graphs.output_bytes", "session.frames",
            "session.waypoint_frames", "session.exact_retries",
            "session.bytes", "batch.compact_positions")
# Spans kept in memory by a recording tracer; the oldest go first.
MAX_SPANS = 65536

_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1000 if self.calls else 0.0


class SpanRecord:
    """One span: its name, id, parent span's id (None at the top), the id
    of the top-level span it runs under, host start and end
    (perf_counter_ns), the part of it its child spans cover, and its CUDA
    events (start, end) where it timed the device."""
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "child_ns", "events")

    def __init__(self, name, span_id, parent):
        self.name = name
        self.id = span_id
        self.parent = None if parent is None else parent.id
        self.root = span_id if parent is None else parent.root
        self.child_ns = 0
        self.events = None
        self.start_ns = time.perf_counter_ns()

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns

    def device_ms(self):
        """The device time between its events, or None (waits for them)."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _NullSpan:
    """What a span site returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def time_device(self, device) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Annotation(_NullSpan):
    """A span while only a torch.profiler session records."""
    __slots__ = ("fn",)

    def __init__(self, name):
        self.fn = torch.profiler.record_function(name)

    def __enter__(self):
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        return False


class _Span:
    """A span while the tracer records (and a profiler annotation while a
    profiler records too)."""
    __slots__ = ("timer", "name", "rec", "device", "fn")

    def __init__(self, timer, name):
        self.timer, self.name = timer, name
        self.device = self.fn = None

    def __enter__(self):
        if _profiler_enabled():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        stack = self.timer._stack()
        self.rec = SpanRecord(self.name, next(self.timer._ids),
                              stack[-1] if stack else None)
        stack.append(self.rec)
        return self

    def time_device(self, device) -> None:
        """Times the device from here to the span's end: one CUDA event on
        the current stream of `device` now and one at the end (none on
        the CPU, or while that stream is captured into a graph)."""
        device = torch.device(device)
        if device.type != "cuda" or self.rec.events is not None:
            return
        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                return
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self.rec.events = (start, None)
        self.device = device

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            with torch.cuda.device(self.device):
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            rec.events = (rec.events[0], end)
        rec.end_ns = time.perf_counter_ns()
        stack = self.timer._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += rec.end_ns - rec.start_ns
        self.timer._keep(rec)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


class StageTimer:
    """Accumulates wall time per named stage; host-fetch to close async.

    Also a tracer (module docstring): `span` records a span while the
    timer records (`enable`, `recording`) and annotates the profiler's
    trace while a profiler records; `summary` and `report` give what was
    recorded.  A timer starts without recording spans."""

    def __init__(self, counter_names=()):
        self.stages = defaultdict(StageStats)
        self.counters = defaultdict(int)
        self.counter_names = tuple(counter_names)
        self.on = False
        self.records = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st = self.stages[name]
            st.calls += 1
            st.total_s += time.perf_counter() - t0

    def count(self, name: str, value: int = 1) -> None:
        self.counters[name] += value

    # -- spans -------------------------------------------------------------

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    @contextlib.contextmanager
    def recording(self):
        """Records spans and counters inside the block."""
        was, self.on = self.on, True
        try:
            yield self
        finally:
            self.on = was

    def span(self, name: str):
        """A context manager for one span of `name`; the object it gives
        has `time_device(device)`.  Costs a flag check and the profiler
        query while nothing records."""
        if self.on:
            return _Span(self, name)
        if _profiler_enabled():
            return _Annotation(name)
        return _NULL_SPAN

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec) -> None:
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)

    def clear(self) -> None:
        """Forgets every stage, counter and span."""
        self.stages.clear()
        self.counters.clear()
        self.records.clear()
        self.dropped = 0

    def summary(self) -> dict:
        """The spans kept, by name (calls; mean host, self and, where the
        span timed the device, device time), the counters and the spans
        dropped from the buffer.  Waits for the spans' CUDA events."""
        by_name: dict = {}
        for rec in self.records:
            by_name.setdefault(rec.name, []).append(rec)
        spans = {}
        for name, recs in by_name.items():
            n = len(recs)
            row = {"calls": n,
                   "host_us": sum(r.host_ns for r in recs) / n / 1e3,
                   "self_us": sum(r.self_ns for r in recs) / n / 1e3}
            dev = [r.device_ms() for r in recs if r.events is not None]
            if dev:
                row["device_ms"] = sum(dev) / len(dev)
            spans[name] = row
        return {"spans": spans, "counters": self._counters(),
                "dropped": self.dropped}

    def _counters(self) -> dict:
        return {**dict.fromkeys(self.counter_names, 0), **self.counters}

    def report(self) -> dict:
        out = {name: {"calls": st.calls, "mean_ms": round(st.mean_ms, 3),
                      "total_s": round(st.total_s, 3)}
               for name, st in self.stages.items()}
        out["counters"] = self._counters()
        if self.records:
            out["spans"] = {
                name: {k: round(v, 3) for k, v in row.items()}
                for name, row in self.summary()["spans"].items()}
        return out

    def report_json(self) -> str:
        return json.dumps(self.report())


class BitstreamTrace:
    """Record (label, bit_position) marks during host emission.

    Attach to a BitWriter-producing path; `diff` against another trace
    pinpoints the first syntax element where two encoders diverge — the
    NAL-level analog of the reference's per-row bit accounting.
    """

    def __init__(self):
        self.marks: list = []

    def mark(self, label: str, bit_position: int) -> None:
        self.marks.append((label, bit_position))

    def diff(self, other: "BitstreamTrace"):
        """First (index, ours, theirs) mismatch or None."""
        for i, (a, b) in enumerate(zip(self.marks, other.marks)):
            if a != b:
                return i, a, b
        if len(self.marks) != len(other.marks):
            n = min(len(self.marks), len(other.marks))
            return (n, self.marks[n] if n < len(self.marks) else None,
                    other.marks[n] if n < len(other.marks) else None)
        return None


@contextlib.contextmanager
def torch_profile(log_dir: str):
    """Trace the body with torch.profiler — CPU activity, and CUDA activity
    where a card is present — and write it as a Chrome trace to
    `log_dir`/trace.json (open it in chrome://tracing or Perfetto).
    Yields the profiler, whose key_averages() sum the trace by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The composer's tracer (module docstring).
TRACER = StageTimer(COUNTERS)
