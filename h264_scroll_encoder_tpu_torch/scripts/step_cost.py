"""Memory-traffic census of the rows splice step.

Port of scripts/step_cost.py, which reads XLA's cost_analysis ("bytes
accessed") and a shape census of the compiled step.  PyTorch compiles
nothing, so the counterpart counts the step as it runs op by op (its
`.eager`, not its CUDA graph, which the dispatcher does not see into):
every aten op of one compact rows step (chip_smoke.py's phase 5 step at
bench.py's geometry, B sessions) is seen through the dispatcher with the
shapes and dtypes of its tensor arguments and results, and

  - the bytes each op reads (its tensor arguments, each once, a
    broadcast view at most its storage) and writes (its tensor results),
    summed over the step, and the ops by bytes (views and allocations
    count as ops that move nothing);
  - the largest tensors the step makes;
  - the peak device memory of the step (torch.cuda.max_memory_allocated
    after reset_peak_memory_stats; on the card only);
  - the least time those bytes take at the card's 3.35 TB/s, against the
    step's own time (utils/timing.chained_ms), which bounds the share of
    the step that memory traffic could explain.

The hand-written kernels run through ctypes, which the dispatcher does
not see: on the card K1's bytes are counted apart, from the arguments of
its wrapper (the symbols read once as their dtype; NAL and results
written).  On the CPU its plain version's ops are in the census.

    python -m h264_scroll_encoder_tpu_torch.scripts.step_cost \
        [--batch B] [--device cpu]
"""

from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import cases
from ..ops import emit_fused
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
    """Bytes read and written by each aten op, and the largest results."""

    def __init__(self):
        super().__init__()
        self.read = defaultdict(int)
        self.written = defaultdict(int)
        self.count = defaultdict(int)
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
        self.read[name] += sum(_bytes(t) for t in ins)
        self.written[name] += sum(t.numel() * t.element_size() for t in outs)
        for t in outs:
            self.largest.append((t.numel() * t.element_size(), name,
                                 tuple(t.shape), str(t.dtype)))
        return out


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], donors=True).parse_args(argv)
    dev = common.device_of(args)
    step, inputs = compact_step(args, dev)
    step(*inputs)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    census, seen = Census(), {}
    real = emit_fused.emit_nal_fused_batch

    def spy(patterns, nbits, *a, **kw):
        seen["symbols"] = patterns
        return real(patterns, nbits, *a, **kw)

    emit_fused.emit_nal_fused_batch = spy
    try:
        with census:
            nal, nal_len, _bits, _ovf = step(*inputs)
    finally:
        emit_fused.emit_nal_fused_batch = real
    peak = (torch.cuda.max_memory_allocated(dev) - base) if cuda else None
    # K1 (ctypes, on the card): its symbols read once; NAL, lengths, bits
    # and flags written.
    sym = seen["symbols"]
    aten = sum(census.read.values()) + sum(census.written.values())
    k1 = (2 * sym.numel() * sym.element_size() + nal.numel()
          + 9 * nal_len.numel()) if cuda else 0
    step_ms = common.chained(lambda h: step(h, *inputs[1:]), inputs[0], args)
    total = aten + k1
    by_op = sorted(census.count, key=lambda k: -(census.read[k] + census.written[k]))
    rows = {
        "aten_ops": sum(census.count.values()),
        "aten_bytes": aten, "k1_bytes": k1,
        "bound_ms": total / HBM_BYTES_PER_MS, "step_ms": step_ms,
        "bound_share": total / HBM_BYTES_PER_MS / step_ms,
        "peak_bytes": peak,
        "ops": [{"op": k, "count": census.count[k], "read": census.read[k],
                 "written": census.written[k]} for k in by_op[:TOP]],
        "largest": [{"bytes": b, "op": op, "shape": list(s), "dtype": d}
                    for b, op, s, d in sorted(census.largest,
                                              reverse=True)[:TOP]],
    }
    print(f"B={args.batch}: {rows['aten_ops']} aten ops move {aten} B "
          f"(+ K1's {k1} B on the card); at 3.35 TB/s {rows['bound_ms']:.5f} ms "
          f"against the step's {step_ms:.5f} ms ({rows['bound_share']:.1%}); "
          f"peak {peak if peak is not None else 'not measured (cpu)'} B "
          f"above the inputs; K1 reads {tuple(sym.shape)} symbols, NAL "
          f"buffer {tuple(nal.shape)}", flush=True)
    for op in rows["ops"]:
        print(f"  {op['op']:24s} x{op['count']:<5d} read {op['read']:>11d} B "
              f"written {op['written']:>11d} B", flush=True)
    common.table("step_cost", dev, rows, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
