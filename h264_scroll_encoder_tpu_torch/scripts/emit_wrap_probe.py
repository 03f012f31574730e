"""The host's cost of each piece of K1's wrapper.

Port of scripts/emit_wrap_probe.py.  The JAX probe prices the XLA pad and
relayout around the fused emit kernel by timing each piece alone and the
kernel fed inputs already laid out (`full3d`).  K1's wrapper
(ops/emit_fused.emit_nal_fused_batch) does no relayout: it reads the
symbols in place.  What it does costs host time, which a host-bound step
pays per call, so each piece is timed here as the host's issue time per
call (utils/timing.host_ms: calls issued back to back):

  check        check_symbols and the two row-stride reads
  plan         items_per_thread and _kernels.emit_plan (a cached query)
  alloc        the four outputs (NAL, lengths and bits, overflow)
  context      torch.cuda.device(dev) and the current stream's handle
  ctypes       the bare h264t_emit_fused call with its arguments, on
               outputs allocated once: the floor, K1 alone (`full3d`)
  bookkeeping  Kernel.launch around that call (error check, counter)
  wrapper      emit_nal_fused_batch, all of it

with the device time per call of the floor and of the wrapper beside
them (calls queued back to back).  The wrapper runs eagerly, as the
steps' `.eager` runs it; inside a step's CUDA graph (utils/graphs) none
of this host time recurs on a replay.  On the CPU the wrapper runs the plain
version and the pieces that need the card are not measured.

    python -m h264_scroll_encoder_tpu_torch.scripts.emit_wrap_probe \
        [--batch B] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from .. import _kernels
from ..ops import emit_fused
from ..utils import timing
from . import _probe_common as common

CALLS = 200  # calls issued back to back per piece


def _host_ms(fn, calls: int, dev) -> float:
    if dev.type == "cuda":
        return timing.host_ms(fn, calls)
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.device_of(args)
    B, cap = args.batch, common.CAP
    pat, nb = common.probe_symbols(B, dev)
    n_rbsp = 8192
    n = pat.shape[1]
    n_nal = emit_fused.nal_bytes(n_rbsp, cap)
    kw = {"append_tb": True}

    def check():
        emit_fused.check_symbols(pat, nb)
        return emit_fused.row_stride(pat), emit_fused.row_stride(nb)

    def alloc():
        return (torch.empty((B, n_nal), dtype=torch.uint8, device=dev),
                torch.empty((2, B), dtype=torch.int32, device=dev),
                torch.empty((B,), dtype=torch.bool, device=dev))

    pieces = {"check": check, "alloc": alloc,
              "wrapper": lambda: emit_fused.emit_nal_fused_batch(
                  pat, nb, 0, n_rbsp, cap, **kw)}
    device_ms = {}
    if dev.type == "cuda":
        k = emit_fused.items_per_thread(n)
        cluster = _kernels.emit_plan(pat.element_size(), n, k, n_nal)
        nal, meta, ovf = alloc()
        stream = torch.cuda.current_stream(dev).cuda_stream
        args_k1 = (pat.data_ptr(), nb.data_ptr(), pat.element_size(),
                   emit_fused.row_stride(pat), emit_fused.row_stride(nb), None,
                   0, 0, B, n, k, n_nal, n_rbsp, cap, 0, 1, cluster,
                   nal.data_ptr(), meta[0].data_ptr(), meta[1].data_ptr(),
                   ovf.data_ptr(), stream)
        _kernels.EMIT_FUSED.launch(*args_k1)  # binds the entry point
        bare = _kernels.EMIT_FUSED._fn

        def ctypes_call():
            err = bare(*args_k1)
            if err:
                raise RuntimeError(f"h264t_emit_fused failed: {err}")

        def context():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream(dev).cuda_stream

        pieces.update({
            "plan": lambda: _kernels.emit_plan(
                pat.element_size(), n, emit_fused.items_per_thread(n), n_nal),
            "context": context, "ctypes": ctypes_call,
            "bookkeeping": lambda: _kernels.EMIT_FUSED.launch(*args_k1)})
        device_ms = {"ctypes": timing.device_ms(ctypes_call),
                     "wrapper": timing.device_ms(pieces["wrapper"])}
    rows = {}
    for name in ("check", "plan", "alloc", "context", "ctypes", "bookkeeping",
                 "wrapper"):
        if name not in pieces:
            rows[name] = {"host_ms": None}
            continue
        rows[name] = {"host_ms": _host_ms(pieces[name], CALLS, dev)}
        if name in device_ms:
            rows[name]["device_ms"] = device_ms[name]
    for name, row in rows.items():
        h = row["host_ms"]
        print(f"  {name:12s} " + ("not measured (no card)" if h is None else
                                  f"{h:.5f} ms host per call")
              + (f", device {row['device_ms']:.5f} ms" if "device_ms" in row
                 else ""), flush=True)
    if rows["ctypes"]["host_ms"] is not None:
        over = rows["wrapper"]["host_ms"] - rows["ctypes"]["host_ms"]
        print(f"  wrapper over the bare call: {over:.5f} ms host per call")
    common.table("emit_wrap_probe", dev, rows, n=n, n_rbsp=n_rbsp, batch=B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
