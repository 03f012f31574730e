"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

The cell, its configuration and its traffic mix are found by name
(BENCHMARK.json, configs/, traffic/); each metric, end-to-end or per
layer, is read from the run's Record by `metrics/<name>.py`.  Adding a
configuration, a mix or a metric adds files and entries only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import drive, yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the process may not hold once the window has
# closed: JAX and the JAX package the port was made from (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "h264_scroll_encoder_tpu")
SPANS = ("donor_pick", "step", "egress", "session_frame")


def load_cell(name: str, root: Path = ROOT):
    """(manifest, cell, configuration, traffic) of the cell `name`."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, traffic


def cell_metrics(manifest: dict, cell: str, section: str) -> list:
    return [m for m in manifest[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    """metrics/<name>.py's read(record)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers take it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    spans_s: dict = dataclasses.field(default_factory=dict)
    device_s: list = dataclasses.field(default_factory=list)
    trace: yardstick.TraceSummary | None = None
    bound_bytes: dict = dataclasses.field(default_factory=dict)

    def span_mean_ms(self, name: str):
        xs = self.spans_s.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None


class Spans:
    """Host spans of a traced run, each a profiler annotation of the same
    name.  With `sync` each span ends on a device synchronise and its
    seconds are kept; without, it only marks the profiler's timeline and
    leaves the loop as the untraced run has it."""

    def __init__(self, sync=None):
        self.sync = sync
        self.times: dict = {}

    @contextlib.contextmanager
    def __call__(self, name):
        with torch.profiler.record_function(name):
            a = time.perf_counter()
            yield
            if self.sync is not None:
                self.sync()
                self.times.setdefault(name, []).append(
                    time.perf_counter() - a)


class Workers:
    """Host worker processes (numpy and the reference only).  Each map
    starts up to 8 `worker.py` processes, hands each a share of the items
    over its standard input, reads the answers from its standard output,
    and waits for every one to end before it returns, on every path out
    of it.  Plain pipes, no multiprocessing: nothing (such as its
    resource tracker) outlives the map."""

    def map(self, fn, items) -> list:
        items = list(items)
        n = min(8, os.cpu_count() or 1, len(items))
        procs, shares = [], []
        try:
            for _ in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "worker.py")],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE))
            for i, p in enumerate(procs):
                p.stdin.write(pickle.dumps((fn, items[i::n])))
                p.stdin.close()
            for p in procs:
                data = p.stdout.read()
                if p.wait() != 0:
                    raise RuntimeError(f"a worker of {fn.__name__} exited "
                                       f"with {p.returncode}")
                shares.append(pickle.loads(data))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                with contextlib.suppress(OSError):
                    p.stdin.close()
                p.stdout.close()
        out = [None] * len(items)
        for i, share in enumerate(shares):
            out[i::n] = share
        return out


def _profile(drv, t: int, steps: int):
    """`steps` more steps under torch.profiler, reduced to a
    TraceSummary (None where the trace holds no device op)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if drv.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans = Spans()
    with profile(activities=acts) as prof:
        for i in range(2):          # events a trace starts on can be lost
            drv.step(t + i, drive.no_span)
        drv.sync()
        with record_function(yardstick.WINDOW_SPAN):
            for i in range(2, 2 + steps):
                drv.step(t + i, spans)
            drv.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return yardstick.summarize_trace(events, SPANS), t + 2 + steps


def _card(device) -> dict:
    if device.type != "cuda":
        return {}
    out = {"name": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["power_limit"] = f"not read ({e})"
    return out


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", batch: int | None = None, control: bool = False,
        traffic_override: dict | None = None, t0: float | None = None):
    """One run: (result dict or None, exit code, lines for stderr)."""
    t0 = time.perf_counter() if t0 is None else t0
    t_entry = time.perf_counter()
    manifest, cell, config, traffic = load_cell(name)
    traffic = {**traffic, **(traffic_override or {})}
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    drv = drive.make(config, traffic, seed, device, batch=batch,
                     control=control)
    rec = Record(bound_bytes=drv.bound_bytes())
    drv.setup(Workers())
    drv.sync()
    # What set-up made lives to the end: out of the collector's way.
    gc.collect()
    gc.freeze()
    rec.setup_s = time.perf_counter() - t0

    spans = Spans(drv.sync) if trace else None
    drv.timed = trace
    t = drv.warm
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        drv.step(t, spans or drive.no_span)
        b = time.perf_counter()
        rec.latencies_s.append(b - a)
        t += 1
        if b - start >= seconds:
            break
    rec.window_s = b - start
    rec.frames = len(rec.latencies_s) * drv.frames_per_step
    drv.finish()
    if trace:
        rec.spans_s = spans.times
        rec.device_s = drv.device_seconds()
        drv.timed = False
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    if trace:
        rec.trace, t = _profile(drv, t, traffic["trace_steps"])
    drv.close()

    checks = drive.Checks()
    drv.check(Workers(), checks)
    lines = checks.lines()
    bad = forbidden_modules()
    if bad:
        return None, 3, [f"forbidden modules loaded: {bad}"]

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(manifest, name, section):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": mem_peak}
    result = {"correct": checks.correct, "attempted": rec.frames,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(),
                               "idle_gaps": rec.trace.top_gaps()}
    result["run"] = {"seed": seed, "steps": len(rec.latencies_s),
                     "window_s": rec.window_s, "control": control,
                     "exact_retries": getattr(drv, "retries", 0),
                     "setup_parts_s": {"start": t_entry - t0,
                                       **drv.setup_parts_s},
                     **_card(device)}
    result["checks"] = checks.as_dict()
    return result, 0, lines
