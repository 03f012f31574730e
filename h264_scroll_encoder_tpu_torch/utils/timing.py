"""CUDA-event timing on the card, for kernel_ab.py and the scripts.

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
  chained_ms the JAX probes' method (scripts/emit_stage_probe.py `timed`,
             a lax.scan chain) with CUDA events: each step perturbs its
             input by the previous step's checksum, on the device, so no
             step can be hoisted or skipped; the chain is queued behind a
             sleep kernel, as device_ms is, so the device runs it back to
             back and the time per step is device time; best of 3.

and `profile_launches` / `profile_step`, the CUDA API launches, device
kernels and device time per call that torch.profiler records.
"""

from __future__ import annotations

import math
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


def chained_ms(fn, x, steps: int = 8, reps: int = 3) -> float:
    """Best of `reps` chains of `steps` calls fn(xp), in ms per step.

    xp is a copy of the [B, ...] tensor x.  Before each step column 0 of
    xp is XORed, in place and on the device, with the parity of the
    running checksum; after it every tensor fn returns is summed into the
    checksum.  Nothing waits on the device inside a chain.  On a CUDA
    tensor each timed chain is queued behind a sleep kernel that covers
    twice the host's time to issue a chain, and CUDA events time it from
    the sleep's end: the device time of `steps` steps run back to back
    (a chain that waits on the device itself, or overflows the launch
    queue, adds the host's gaps).  On a CPU tensor the host clock times
    it, which is no device time.  Two chains run first: a warm-up, and
    one whose issue time sizes the sleep."""
    xp = x.clone()
    chk = torch.zeros((), dtype=torch.int64, device=x.device)

    def chain():
        nonlocal chk
        for _ in range(steps):
            xp[:, 0] ^= (chk & 1).to(xp.dtype)
            out = fn(xp)
            for o in out if isinstance(out, (tuple, list)) else (out,):
                chk = chk + o.sum(dtype=torch.int64)

    chain()
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int(_sleep_cycles_per_ms() * (2 * issue_ms + 1.0))
    best = math.inf
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            chain()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            chain()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / steps)
    return best


# CUDA runtime calls that put work on a stream: kernel launches, graph
# launches, copies and fills.
_API_LAUNCHES = ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def profile_step(fn, calls: int):
    """fn's launches and device work per call over `calls` calls under
    torch.profiler, or None when the profiler records no device time (a
    CPU run, or a profiler that cannot see the card):

      api_launches    CUDA runtime calls that queue work (kernel and graph
                      launches, copies, fills) per call;
      api_by_kind     those calls by name (cudaLaunchKernel,
                      cudaGraphLaunch, cudaMemcpyAsync, ...), per call;
      kernels         device kernels per call (a graph's count each);
      device_ms       device time per call, kernels and copies;
      kernel_counts   {device kernel name: runs in all `calls` calls}.

    One call runs first as the profiler's warm-up, unrecorded (the first
    kernels a trace starts on can go unrecorded), and the device is
    synchronised after each call.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            if cuda:
                torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    api = {e.key: e.count / calls for e in events
           if e.key.startswith(_API_LAUNCHES)}
    # Device-side events only (a CPU op's self device time repeats its
    # kernels' time), without the profiler's own step ranges, which span
    # each whole call on the device's timeline.
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    dev_us = sum(e.self_device_time_total for e in dev)
    if dev_us <= 0:
        return None
    kernels = {e.key: e.count for e in dev
               if not e.key.startswith(("Memcpy", "Memset"))}
    return {"api_launches": sum(api.values()), "api_by_kind": api,
            "kernels": sum(kernels.values()) / calls,
            "device_ms": dev_us / 1e3 / calls, "kernel_counts": kernels}


def profile_launches(fn, calls: int):
    """(CUDA API launches per call, device ms per call) of profile_step, or
    None without device time."""
    got = profile_step(fn, calls)
    return None if got is None else (got["api_launches"], got["device_ms"])
