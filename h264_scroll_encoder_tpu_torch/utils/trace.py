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
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1000 if self.calls else 0.0


class StageTimer:
    """Accumulates wall time per named stage; host-fetch to close async."""

    def __init__(self):
        self.stages = defaultdict(StageStats)
        self.counters = defaultdict(int)

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

    def report(self) -> dict:
        out = {name: {"calls": st.calls, "mean_ms": round(st.mean_ms, 3),
                      "total_s": round(st.total_s, 3)}
               for name, st in self.stages.items()}
        out["counters"] = dict(self.counters)
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
