"""CUDA-event timing on the card, for chip_smoke.py and kernel_ab.py.

Two measurements of a function that launches device work:

  call_ms    CUDA events around one call on an idle card: the host's time
             to issue the call plus the device's time to run it, which is
             what one caller waits for.
  device_ms  `launches` calls queued behind a sleep kernel long enough
             for the host to issue them all, so the device runs them back
             to back: the device time per call.  Only for functions that
             never wait on the device themselves.
  host_ms    the host's time to issue one call, over many calls issued
             back to back: what a host-bound step pays for it.
"""

from __future__ import annotations

import statistics
import time

import torch


def call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one fn() in ms, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sleep_cycles_per_ms() -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the device time per call of `launches` calls
    of fn() run back to back, in ms."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # The sleep covers twice the host's issue time, so the start event
    # fires after the last call is queued.
    cycles = int(_sleep_cycles_per_ms() * (2 * issue_ms + 1.0))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def host_ms(fn, calls: int = 200) -> float:
    """Host wall time per call of `calls` calls of fn() issued back to
    back, in ms (the device's work is waited for after the clock stops)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms
