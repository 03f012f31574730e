"""Compiled steps: the port's counterpart of `jax.jit`.

The JAX package runs every step and session frame as one compiled XLA
program (`jax.jit(jax.vmap(...))` in parallel/batch.py, `_jitted_scroll`
and `_jitted_waypoint` in session.py, `_jitted_hint_frame` in
models/hints.py).  Here a step is captured once as a CUDA graph and
replayed: one `cudaGraphLaunch` in place of the hundreds of small
launches that Python would dispatch one by one.

`graphed(fn, name)` returns a `Graphed`, a callable with fn's signature:

  - On CUDA tensors, each call is keyed by its non-tensor arguments (as
    JAX's static arguments) and by the shape, dtype, device and strides
    of every tensor leaf (dicts, tuples and lists are flattened by
    torch.utils._pytree).  The first call of a key runs fn eagerly, which
    is its warm-up (the kernel library's first load, the kernels' launch
    plans and shared-memory opt-ins happen there, outside any capture),
    returns that result and then captures fn on a side stream, the way
    JAX traces a new key; `captures` counts how often that happened.
    Every later call of the key copies the caller's tensors into the
    graph's static inputs, replays the graph and returns clones of its
    outputs, so the caller owns them as a JAX caller does (step t's
    outputs survive step t+1).
  - On CPU tensors (or none), fn runs eagerly: the plain version, as
    every kernel wrapper does.
  - A capture that fails raises GraphCaptureError naming the step; a
    graphed step never falls back to eager on the card.
  - `.eager` is fn itself, for stage profiles and A/B comparisons.

Each graph keeps a private memory pool (its intermediates and static
outputs) for as long as it lives; `Capture.pool_bytes` reports it and
`Graphed.reset()` frees a step's graphs.  `Capture.nodes` is the
graph's node count (kernels, copies, fills), read once from the
captured CUDA graph before it is instantiated.  The kernels' launch counters
stay truthful: a launch recorded while a graph is captured counts on each
replay instead (_kernels.Kernel).

Under the composer's tracer (utils/trace) a call is the span
`graphs.call` (device-timed from its input copies to its output clones)
over `graphs.key`, `graphs.inputs`, `graphs.replay` and
`graphs.outputs`; a capture is `graphs.capture`.  While the tracer
records, a replay counts `graphs.replays`, `graphs.nodes` (its graph's
nodes), `graphs.input_bytes` and `graphs.output_bytes` (bytes copied in
and cloned out), and a capture `graphs.captures`.

`step_factory` caches a step factory as the JAX package's lru_cache'd
factories are: one step, and so one set of graphs, per configuration.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import _kernels
from .trace import TRACER


class GraphCaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph (a host sync, a
    data-dependent shape, or an unsafe CUDA call inside it)."""


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device, x.stride())
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a non-tensor argument of a graphed step must be "
                        f"hashable (it is part of the key), not "
                        f"{type(x).__name__}") from None
    return (type(x), x)


def _key(spec, leaves):
    return spec, tuple(_leaf_key(x) for x in leaves)


def _static_like(x: torch.Tensor) -> torch.Tensor:
    """A buffer holding x's values, with x's strides where x's layout is
    dense (an expanded x gets a contiguous buffer)."""
    return torch.empty_like(x, memory_format=torch.preserve_format).copy_(x)


def _cuda_device(leaves):
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return x.device
    return None


def _place(x, dev: torch.device):
    """A tensor or numpy leaf on the step's device (jax.jit places its
    array arguments so); any other leaf as it is."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=dev)
    return x


@dataclasses.dataclass
class Capture:
    """One key's graph: its static inputs and outputs, the kernel launches
    each replay makes, its nodes, and what the capture cost."""
    graph: "torch.cuda.CUDAGraph"
    device: torch.device
    static_in: list            # the call's leaves, tensors as static buffers
    static_out: object         # fn's outputs in the graph's memory pool
    launches: dict             # {Kernel: launches per replay}
    capture_ms: float
    pool_bytes: int
    nodes: int                 # the graph's nodes: kernels, copies, fills
    out_bytes: int             # bytes a replay's output clones copy

    def run(self, leaves):
        tr = TRACER
        with torch.cuda.device(self.device):
            with tr.span("graphs.inputs"):
                copied = []
                for buf, x in zip(self.static_in, leaves):
                    if isinstance(x, torch.Tensor) and x is not buf:
                        buf.copy_(x)
                        copied.append(buf)
            with tr.span("graphs.replay"):
                self.graph.replay()
            _kernels.count_replay(self.launches)
            with tr.span("graphs.outputs"):
                out = pytree.tree_map(
                    lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    self.static_out)
        if tr.on:
            tr.count("graphs.replays")
            tr.count("graphs.nodes", self.nodes)
            tr.count("graphs.input_bytes", sum(b.nbytes for b in copied))
            tr.count("graphs.output_bytes", self.out_bytes)
        return out


class Graphed:
    """fn captured once per key as a CUDA graph and replayed (see the
    module docstring); `eager` is fn, `captures` the captures made,
    `graphs` the live captures by key.  The step runs on the device of its
    first CUDA tensor, or on `device` when that is given (a step whose
    arguments may all be numpy); tensor and numpy leaves are placed there
    before the key is taken."""

    def __init__(self, fn, name: str, device=None):
        self.eager = fn
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.captures = 0
        self.graphs: dict = {}
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        with TRACER.span("graphs.call") as call:
            with TRACER.span("graphs.key"):
                leaves, spec = pytree.tree_flatten((args, kwargs))
                dev = self.device or _cuda_device(leaves)
                if dev is not None and dev.type == "cuda":
                    if dev.index is None:
                        dev = torch.device("cuda",
                                           torch.cuda.current_device())
                    leaves = [_place(x, dev) for x in leaves]
                    key = _key(spec, leaves)
            if dev is None or dev.type != "cuda":
                return self.eager(*args, **kwargs)
            call.time_device(dev)
            with self._lock:
                cap = self.graphs.get(key)
                if cap is not None:
                    return cap.run(leaves)
                args, kwargs = pytree.tree_unflatten(leaves, spec)
                with torch.cuda.device(dev):
                    out = self.eager(*args, **kwargs)
                with TRACER.span("graphs.capture"):
                    self.graphs[key] = self._capture(dev, leaves, spec)
                self.captures += 1
                if TRACER.on:
                    TRACER.count("graphs.captures")
                return out

    def key(self, *args, **kwargs):
        """The cache key of a call with these arguments, on the devices
        they are on."""
        return _key(*reversed(pytree.tree_flatten((args, kwargs))))

    def _capture(self, dev, leaves, spec) -> Capture:
        with torch.cuda.device(dev):
            static_in = [_static_like(x) if isinstance(x, torch.Tensor) else x
                         for x in leaves]
            args, kwargs = pytree.tree_unflatten(static_in, spec)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = _kernels.captured_counts()
            # keep_graph: the captured cudaGraph_t stays readable (its
            # nodes are counted) until instantiate() builds the exec.
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph):
                    static_out = self.eager(*args, **kwargs)
            except Exception as e:
                raise GraphCaptureError(
                    f"{self.name}: CUDA graph capture failed: {e}") from e
            nodes = sum(_kernels.graph_nodes(graph.raw_cuda_graph()).values())
            graph.instantiate()
            torch.cuda.synchronize(dev)
            capture_ms = (time.perf_counter() - t0) * 1e3
            after = _kernels.captured_counts()
            launches = {k: after[k] - before.get(k, 0) for k in after
                        if after[k] != before.get(k, 0)}
            out_bytes = sum(t.nbytes for t in pytree.tree_leaves(static_out)
                            if isinstance(t, torch.Tensor))
            return Capture(graph, dev, static_in, static_out, launches,
                           capture_ms,
                           torch.cuda.memory_reserved(dev) - reserved,
                           nodes, out_bytes)

    def reset(self) -> None:
        """Drop every capture (their memory pools go back to the caching
        allocator once no output refers to them); the next call of a key
        captures again."""
        with self._lock:
            self.graphs.clear()

    def stats(self) -> list[dict]:
        """Per live capture: capture ms, pool bytes, the graph's nodes and
        the kernel launches of one replay."""
        return [{"capture_ms": c.capture_ms, "pool_bytes": c.pool_bytes,
                 "nodes": c.nodes,
                 "launches": {k.name: n for k, n in c.launches.items()}}
                for c in self.graphs.values()]


def step_factory(factory):
    """A step factory cached as the JAX package's lru_cache'd factories
    are, keyed on its arguments bound to its signature with the defaults
    applied: make(cfg) and make(cfg, flag=default) return the same step,
    so they share its graphs."""
    sig = inspect.signature(factory)
    cached = functools.lru_cache(maxsize=None)(factory)

    @functools.wraps(factory)
    def make(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return cached(*bound.args, **bound.kwargs)
    return make


def graphed(fn, name: str, device=None) -> Graphed:
    """fn as a step that is captured once per key and replayed on the card
    (module docstring); on the CPU it runs fn."""
    return Graphed(fn, name, device)
