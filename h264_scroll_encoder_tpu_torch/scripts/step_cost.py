"""Memory-traffic census of the rows splice step and the scroll step.

Port of scripts/step_cost.py, which reads XLA's cost_analysis ("bytes
accessed") and a shape census of the compiled step.  PyTorch compiles
nothing, so the counterpart counts a step as it runs op by op (its
`.eager`, not its CUDA graph, which the dispatcher does not see into):
every aten op of one step is seen through the dispatcher with the shapes
and dtypes of its tensor arguments and results.  The steps are the
compact rows step (the 32 seeded representative donors on the blob
wire at bench.py's geometry, B sessions) and the 720p scroll step (make_batched_step, step 0 of the
benchmark schedule, B fresh sessions); for each

  - the bytes each op reads (its tensor arguments, each once, a
    broadcast view at most its storage) and writes (its tensor results),
    summed over the step, and the ops by bytes (views and allocations
    count as ops that move nothing);
  - those bytes by dtype, and the ops that move the most int64 bytes
    (the symbol stages compute in the JAX package's 32-bit widths, so
    int64 is left to index arguments and local unsigned widenings);
  - the largest tensors the step makes;
  - the peak device memory of the step (torch.cuda.max_memory_allocated
    after reset_peak_memory_stats; on the card only);
  - the least time those bytes take at the card's 3.35 TB/s, against the
    step's own time (utils/timing.chained_ms), which bounds the share of
    the step that memory traffic could explain.

The hand-written kernels run through ctypes, which the dispatcher does
not see: on the card K1's bytes are counted apart, from the arguments of
its wrapper (the symbols read once as their dtype; NAL and results
written), and so are K5's and K6's (the grid stage: ops/grid's
composite_grid_bytes and scroll_grid_bytes).  On the CPU their plain
versions' ops are in the census.

    python -m h264_scroll_encoder_tpu_torch.scripts.step_cost \
        [--batch B] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import cases
from ..config import ComposerConfig
from ..ops import emit_fused, grid
from ..parallel import batch as batch_mod
from . import _probe_common as common
from .step_xprof import compact_step

# H100 SXM device memory bandwidth (NVIDIA's data sheet), bytes per ms.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
TOP = 12  # ops and tensors listed


def _bytes(t) -> int:
    """Bytes an op must read of tensor t: its elements, or its storage
    where that is smaller (an expanded or broadcast view)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class Census(TorchDispatchMode):
    """Bytes read and written by each aten op, by dtype, and the largest
    results."""

    def __init__(self):
        super().__init__()
        self.read = defaultdict(int)
        self.written = defaultdict(int)
        self.count = defaultdict(int)
        self.by_dtype = defaultdict(int)
        self.int64_by_op = defaultdict(int)
        self.largest = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        ins = [t for t in tree_flatten((args, kwargs or {}))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.count[name] += 1
        if name in cases._NO_WORK_OPS:  # views and allocations move nothing
            return out
        moved = ([(t, _bytes(t)) for t in ins]
                 + [(t, t.numel() * t.element_size()) for t in outs])
        self.read[name] += sum(b for _, b in moved[:len(ins)])
        self.written[name] += sum(b for _, b in moved[len(ins):])
        for t, b in moved:
            self.by_dtype[str(t.dtype).replace("torch.", "")] += b
            if t.dtype == torch.int64:
                self.int64_by_op[name] += b
        for t in outs:
            self.largest.append((t.numel() * t.element_size(), name,
                                 tuple(t.shape), str(t.dtype)))
        return out

    @property
    def total(self) -> int:
        return sum(self.read.values()) + sum(self.written.values())

    def int64_share(self) -> float:
        return self.by_dtype.get("int64", 0) / max(self.total, 1)

    def top_int64(self, k: int = 5) -> list:
        """The ops that move the most int64 bytes: [(op, bytes)]."""
        return sorted(self.int64_by_op.items(), key=lambda kv: -kv[1])[:k]


def scroll_step(args, dev):
    """(fn running one 720p scroll step op by op, its argument tuple)."""
    cfg = ComposerConfig(1280, 720)
    step = batch_mod.make_batched_step(cfg)
    state = batch_mod.SessionState.create(args.batch, device=dev)
    offsets = torch.as_tensor(cases.bench_schedule(cfg.height, args.batch, 1)[0],
                              device=dev)
    return step.eager, (state, offsets)


def _census(name, step, inputs, args, dev) -> dict:
    """One step's census row (module docstring)."""
    step(*inputs)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    census, seen = Census(), {"grid": 0}
    real = emit_fused.emit_nal_fused_batch
    real_grid = (grid.composite_grid_batch, grid.scroll_grid_batch)

    def spy(patterns, nbits, *a, **kw):
        seen["symbols"] = patterns
        return real(patterns, nbits, *a, **kw)

    def composite_spy(r0, c0, R, C, *a, **kw):
        out = real_grid[0](r0, c0, R, C, *a, **kw)
        seen["grid"] += grid.composite_grid_bytes(r0, c0, R, C, *a, out)
        return out

    def scroll_spy(*a, **kw):
        out = real_grid[1](*a, **kw)
        seen["grid"] += grid.scroll_grid_bytes(*a, out)
        return out

    emit_fused.emit_nal_fused_batch = spy
    grid.composite_grid_batch, grid.scroll_grid_batch = (composite_spy,
                                                         scroll_spy)
    try:
        with census:
            out = step(*inputs)
    finally:
        emit_fused.emit_nal_fused_batch = real
        grid.composite_grid_batch, grid.scroll_grid_batch = real_grid
    nal, nal_len = out[1][:2] if name == "scroll" else out[:2]
    peak = (torch.cuda.max_memory_allocated(dev) - base) if cuda else None
    # K1 (ctypes, on the card): its symbols read once; NAL, lengths, bits
    # and flags written.
    sym = seen["symbols"]
    aten = census.total
    k1 = (2 * sym.numel() * sym.element_size() + nal.numel()
          + 9 * nal_len.numel()) if cuda else 0
    grid_bytes = seen["grid"] if cuda else 0
    if name == "scroll":
        state, offs = inputs
        step_ms = common.chained(
            lambda w: step(dataclasses.replace(state, wp_offsets=w), offs)[1],
            state.wp_offsets, args)
    else:
        step_ms = common.chained(lambda h: step(h, *inputs[1:]), inputs[0],
                                 args)
    total = aten + k1 + grid_bytes
    by_op = sorted(census.count,
                   key=lambda k: -(census.read[k] + census.written[k]))
    row = {
        "aten_ops": sum(census.count.values()),
        "aten_bytes": aten, "k1_bytes": k1, "grid_bytes": grid_bytes,
        "by_dtype": dict(sorted(census.by_dtype.items(),
                                key=lambda kv: -kv[1])),
        "int64_share": census.int64_share(),
        "int64_ops": [{"op": k, "bytes": b} for k, b in census.top_int64()],
        "symbols_dtype": str(sym.dtype),
        "bound_ms": total / HBM_BYTES_PER_MS, "step_ms": step_ms,
        "bound_share": total / HBM_BYTES_PER_MS / step_ms,
        "peak_bytes": peak,
        "ops": [{"op": k, "count": census.count[k], "read": census.read[k],
                 "written": census.written[k]} for k in by_op[:TOP]],
        "largest": [{"bytes": b, "op": op, "shape": list(s), "dtype": d}
                    for b, op, s, d in sorted(census.largest,
                                              reverse=True)[:TOP]],
    }
    print(f"{name} B={args.batch}: {row['aten_ops']} aten ops move {aten} B "
          f"(+ K1's {k1} B and K5/K6's {grid_bytes} B on the card); at "
          f"3.35 TB/s {row['bound_ms']:.5f} ms "
          f"against the step's {step_ms:.5f} ms ({row['bound_share']:.1%}); "
          f"peak {peak if peak is not None else 'not measured (cpu)'} B "
          f"above the inputs; K1 reads {tuple(sym.shape)} {sym.dtype} "
          f"symbols, NAL buffer {tuple(nal.shape)}", flush=True)
    print("  by dtype: " + ", ".join(
        f"{d} {b} B ({b / max(aten, 1):.1%})"
        for d, b in row["by_dtype"].items()), flush=True)
    print("  most int64 bytes: " + ", ".join(
        f"{o['op']} {o['bytes']} B" for o in row["int64_ops"]), flush=True)
    for op in row["ops"]:
        print(f"  {op['op']:24s} x{op['count']:<5d} read {op['read']:>11d} B "
              f"written {op['written']:>11d} B", flush=True)
    return row


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0], donors=True)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = {name: _census(name, *make(args, dev), args, dev)
            for name, make in (("rows", compact_step), ("scroll", scroll_step))}
    common.table("step_cost", dev, rows, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
