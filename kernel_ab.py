"""Same-process A/B timing of the kernel wrappers of two trees on one card.

    python3 kernel_ab.py --parent DIR [--large | --grid | --egress]

DIR holds another commit of this repository, unpacked (for example
`git archive <commit> | tar -x -C _parent`; `_parent/` is gitignored).
Its `h264_scroll_encoder_tpu_torch` package is loaded beside this tree's
under another name and builds its own kernels.  Both are driven through
the public wrappers only, on the same int32 inputs (the symbol stages'
widths) at the 720p compact splice shapes (32 seeded representative donors tiled over B sessions):

  K1  ops.emit_fused.emit_nal_fused_batch       B = 1, 256 and 1,024
  K2  ops.bitpack_flat.pack_words_place_batch   B = 256, the ebsp_exact input
  K3  ops.ebsp_flat.rbsp_to_nal_batch           B = 256, K2's frames
  K4  ops.bitpack_flat.pack_words_batch         B = 256, as K2
  K7  syntax.slice_headers.p_slice_header_symbols
                                                B = 1, 256 and 1,024,
                                                cases.header_case's
                                                headers at the 720p config

and, with --large, K1 and K2 on the shapes past one block's shared memory
(cases.large_emit_inputs and large_pack_inputs of this tree: the 3840x2160
and 5120x3200 hint frames at B = 1, the 720p dense frame of I_PCM donors
at B = 32 and 256, the exact retry at 4096x2160 and 5120x3200), whichever
plan each tree takes there, and K1 on the frames one block stages in
several chunks (cases.multichunk_emit_inputs, B = 1).  With --grid, the
grid-stage kernels instead, on the main paths' inputs of this tree's
cases, each tree on its own plan:

  K5  ops.grid.composite_grid_batch   720p rows compact B = 1, 256 and
                                      1,024; dense B = 256
  K6  ops.grid.scroll_grid_batch      cases.scroll_grid_inputs: the 720p
                                      scroll and hint steps (B = 256), a
                                      session's scroll frame and the
                                      1920x1088 to 5120x3200 hint frames
                                      (B = 1)

after printing what `nvcc -Xptxas -v` says of this tree's
csrc/grid_kernels.cu (registers, stack, spills); then this tree's K5 and
K6 at every band plan forced on each of those shapes, beside the plan's
own choice (plan_sweep).  With --egress, egress instead, on the
benchmark's rows (the cap the whole buffer, B * N, as its egress gives):

  K8  parallel.batch.compact_batch_nal  the pooled splice rows (K1 on the
                                        32 donors at B = 1,024 and the
                                        10,240 B RBSP budget) and the
                                        scroll step's rows (B = 256)

where a parent before K8 runs the plain version on the card (the
profiler's kernel column then reads 0; its work column is the call's);
then this tree's K8 at every tile of COMPACT_TILES forced on each of those
rows, beside the plan's own tile (tile_sweep).

For each, the two trees' outputs are held equal; then each is measured in
turns (parent, tree, tree, parent; the median of each pair): with
utils/timing the wrapper's device time per call of calls queued back to
back, one call, and the host's issue time per call; with torch.profiler
the device time per call of the hand-written kernel alone (the device
kernels whose name holds the kernel's) and of all the call's device work.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import threading
from pathlib import Path

import torch

N_DONORS = 32
MODULES = ("_kernels", "ops.emit_fused", "ops.bitpack_flat", "ops.ebsp_flat",
           "ops.grid", "parallel.batch", "syntax.slice_headers")


def load_tree(root: Path, name: str) -> dict:
    """The port package under `root`, imported as `name`: {module: module}."""
    pkg = root / "h264_scroll_encoder_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    return {m: importlib.import_module(f"{name}.{m}") for m in MODULES}


def profiled_ms(fn, kernel: str, calls: int = 20):
    """(device ms per call of the kernels named `kernel`, of all device
    work) over `calls` calls of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    own = sum(e.self_device_time_total for e in dev if kernel in e.key)
    work = sum(e.self_device_time_total for e in dev)
    return own / 1e3 / calls, work / 1e3 / calls


def emit_cells(cases, cfg, dn, bits, has_align, dev, *, large: bool):
    """K1-K4's cells at the 720p compact splice shapes (and, with
    `large`, K1's and K2's past one block), and {n_rbsp, n_nal}."""
    from h264_scroll_encoder_tpu_torch.ops import bitpack, emit_fused

    cap = cases.CAP
    n_rbsp = cases.splice_budget(cfg, int(bits.max()), static_bg=False)
    n_nal = emit_fused.nal_bytes(n_rbsp, cap)
    k1_kw = dict(align=bool(has_align.any()), append_tb=True)

    cells = []  # (label, kernel name, wrapper, module, args, kwargs)
    for B in (1, 256, 1024):
        sym = cases.splice_symbols(cfg, dn, B, n_rbsp, dev)
        cells.append((f"K1 B={B}", "emit_fused_kernel", "emit_nal_fused_batch",
                      "ops.emit_fused", (*sym, 0, n_rbsp, cap), k1_kw))
        if B == 256:
            pat, nb = sym
    tb_pat, tb_nb = bitpack.trailing_bits_symbol(nb.sum(dim=1, dtype=torch.int32))
    e_pat = torch.cat([pat, tb_pat[:, None]], dim=1)
    e_nb = torch.cat([nb, tb_nb[:, None]], dim=1)
    n_words = (n_rbsp + 3) // 4
    words, total = bitpack.pack_words(e_pat, e_nb, n_words)
    rbsp = bitpack.words_to_bytes(words)[:, :n_rbsp].to(torch.uint8)
    # K3 takes int64 lengths.
    k3_args = (rbsp, (total // 8).to(torch.int64), 0x01, n_nal, cap)
    cells += [("K2 B=256", "pack_place_kernel", "pack_words_place_batch",
               "ops.bitpack_flat", (e_pat, e_nb, n_words), {}),
              ("K3 B=256", "ebsp_nal_kernel", "rbsp_to_nal_batch",
               "ops.ebsp_flat", k3_args, {}),
              ("K4 B=256", "pack_place_kernel", "pack_words_batch",
               "ops.bitpack_flat", (e_pat, e_nb, n_words), {})]
    if large:
        # The profiler matches "emit_fused" and "pack_place": the one-block
        # kernels and the cluster ones alike.
        for name, (pat, nb, rbsp, kw) in {**cases.large_emit_inputs(dev),
                                          **cases.multichunk_emit_inputs(dev)}.items():
            for b in ((32, 256) if pat.shape[0] > 1 else (1,)):
                rows = torch.arange(b, device=dev) % pat.shape[0]
                cells.append((f"K1 {name} B={b}", "emit_fused",
                              "emit_nal_fused_batch", "ops.emit_fused",
                              (pat[rows], nb[rows], 0, rbsp, cap),
                              dict(append_tb=True, **kw)))
        for name, a in cases.large_pack_inputs(dev).items():
            cells.append((f"K2 {name} B=1", "pack_place",
                          "pack_words_place_batch", "ops.bitpack_flat", a, {}))
    return cells, {"n_rbsp": n_rbsp, "n_nal": n_nal}


def header_cells(cases, dev):
    """K7's cells: cases.header_case's P slice headers under the 720p
    configuration HEADER_CONFIGS[0] at B = 1, 256 and 1,024."""
    cfg, qp = cases.header_config(0)
    return [(f"K7 B={B}", "p_slice_header_kernel", "p_slice_header_symbols",
             "syntax.slice_headers", (cfg,),
             dict(slice_qp_delta=qp,
                  **cases.header_tensors(cases.header_case(B, 7), dev)))
            for B in (1, 256, 1024)]


def grid_cells(cases, cfg, dn, dev):
    """K5's and K6's cells: the 720p rows and dense splice steps' inputs
    and cases.scroll_grid_inputs, each tree on its own plan (the profiler
    matches "grid_kernel", both trees' name)."""
    dense_dn, _bits, _align = cases.prepare_dense_donors(
        "representative", engine="native", device=dev)
    cells = []
    for label, d, B, rows in (("K5 rows B=1", dn, 1, True),
                              ("K5 rows B=256", dn, 256, True),
                              ("K5 rows B=1024", dn, 1024, True),
                              ("K5 dense B=256", dense_dn, 256, False)):
        a, kw = cases.composite_grid_inputs(cfg, d, B, dev, rows=rows)
        cells.append((label, "grid_kernel", "composite_grid_batch", "ops.grid",
                      a, kw))
    for name, (a, kw) in cases.scroll_grid_inputs(dev).items():
        cells.append((f"K6 {name} B={a[0].shape[0]}", "grid_kernel",
                       "scroll_grid_batch", "ops.grid", a, kw))
    return cells


def egress_cells(cases, cfg, dn, has_align, dev):
    """K8's cells: the pooled splice cell's NAL rows and the scroll
    cell's, each compacted into the whole buffer."""
    from h264_scroll_encoder_tpu_torch.parallel import batch

    pooled = cases.pooled_egress_rows(cfg, dn, bool(has_align.any()), dev)
    sched = torch.as_tensor(cases.bench_schedule(720, 256, 2), device=dev)
    step = batch.make_batched_step(cfg)
    _state, out = step(batch.SessionState.create(256, device=dev), sched[1])
    return [(label, "compact_nal", "compact_batch_nal", "parallel.batch",
             (nal, nal_len, nal.numel()), {})
            for label, (nal, nal_len) in (("K8 pooled B=1024", pooled),
                                          ("K8 scroll B=256", out[:2]))]


def plan_sweep(tree, cells, timing) -> dict:
    """This tree's K5 and K6 at every band plan forced (the wrappers'
    `parts=`) that fits a block, on every grid cell: device ms per call
    beside the plan's own choice, the fastest P and how much slower the
    plan's P is than it (kGridBlockMbs is what the plan's cost weighs)."""
    grid, kernels = tree["ops.grid"], tree["_kernels"]
    out = {}
    for label, _kernel, wrapper, _module, args, kw in cells:
        fn = getattr(grid, wrapper)
        kind = (grid.GRID_COMPOSITE if wrapper == "composite_grid_batch"
                else grid.GRID_SCROLL)
        g = args[5] if kind == grid.GRID_COMPOSITE else args[0]
        B, h, w = g.shape
        ms = {p: timing.device_ms(lambda p=p: fn(*args, parts=p, **kw))
              for p in grid.allowed_parts(h, w)
              if kernels.grid_capacity(h * w, w, p, kind) > 0}
        plan = kernels.grid_plan(h * w, w, B, kind)
        best = min(ms, key=ms.get)
        row = {"plan": plan, "fastest": best,
               "plan_over_fastest": ms[plan] / ms[best],
               **{f"P={p}": t for p, t in ms.items()}}
        out[label] = row
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
    return out


COMPACT_TILES = (2048, 4096, 8192, 16384, 32768, 65536)


def tile_sweep(tree, cells, timing) -> dict:
    """This tree's K8 at every tile of COMPACT_TILES forced
    (`_compact_nal_kernel`'s `tile=`) on every egress cell, in two passes
    (up, then down): device ms per call of each pass beside the plan's own
    tile (compact_tile), the fastest tile and how much slower the plan's
    is than it."""
    batch = tree["parallel.batch"]
    out = {}
    for label, _kernel, _wrapper, _module, (nal, nal_len, cap), _kw in cells:
        ms = {t: [] for t in COMPACT_TILES}
        for order in (COMPACT_TILES, COMPACT_TILES[::-1]):
            for t in order:
                ms[t].append(timing.device_ms(
                    lambda t=t: batch._compact_nal_kernel(nal, nal_len, cap,
                                                          tile=t)))
        med = {t: statistics.median(v) for t, v in ms.items()}
        plan = batch.compact_tile(cap, batch._sms(nal.device.index))
        best = min(med, key=med.get)
        row = {"plan": plan, "fastest": best,
               "plan_over_fastest": med[plan] / med[best],
               **{f"tile={t}": v for t, v in ms.items()}}
        out[label] = row
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--large", action="store_true",
                    help="also K1 and K2 on the shapes past one block")
    ap.add_argument("--grid", action="store_true",
                    help="K5 and K6 instead of K1-K4 and K7")
    ap.add_argument("--egress", action="store_true",
                    help="K8 instead of K1-K4 and K7")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    from h264_scroll_encoder_tpu_torch import cases, native_bridge
    from h264_scroll_encoder_tpu_torch.config import ComposerConfig
    from h264_scroll_encoder_tpu_torch.utils import timing

    trees = {"parent": load_tree(args.parent.resolve(), "_ab_parent"),
             "tree": load_tree(Path(__file__).resolve().parent, "_ab_tree")}
    builds = [threading.Thread(target=t["_kernels"].build) for t in trees.values()]
    builds.append(threading.Thread(target=native_bridge.build))
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    for t in trees.values():
        t["_kernels"].build()  # raises here if its build failed
    native_bridge.load_library()

    dev = torch.device("cuda", 0)
    cfg = ComposerConfig(1280, 720)
    payloads = [cases.splice_donor_payload(k) for k in range(N_DONORS)]
    dn, bits, has_align = cases.prepare_splice_donors(payloads, engine="native",
                                                      device=dev)
    if args.grid:
        from h264_scroll_encoder_tpu_torch import _kernels

        print(_kernels.ptxas_report("grid_kernels.cu"), flush=True)
        cells, extra = grid_cells(cases, cfg, dn, dev), {}
    elif args.egress:
        cells, extra = egress_cells(cases, cfg, dn, has_align, dev), {}
    else:
        cells, extra = emit_cells(cases, cfg, dn, bits, has_align, dev,
                                  large=args.large)
        cells += header_cells(cases, dev)

    def measure(fn, kernel):
        own, work = profiled_ms(fn, kernel)
        return {"device_ms": timing.device_ms(fn), "call_ms": timing.call_ms(fn, 20),
                "host_ms": timing.host_ms(fn), "kernel_ms": own, "work_ms": work}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    results = {"card": smi, **extra}
    for label, kernel, wrapper, module, a, kw in cells:
        fns = {side: (lambda f=getattr(t[module], wrapper): f(*a, **kw))
               for side, t in trees.items()}
        outs = {side: fn() for side, fn in fns.items()}
        torch.cuda.synchronize()
        for x, y in zip(outs["parent"], outs["tree"]):
            if x is None or y is None:
                if (x is None) != (y is None):
                    raise AssertionError(
                        f"{label}: the two trees' outputs differ")
                continue
            # Words as uint32 values: a parent may return them as int64.
            if not torch.equal(x.to(torch.int64) & 0xFFFFFFFF,
                               y.to(torch.int64) & 0xFFFFFFFF):
                raise AssertionError(f"{label}: the two trees' outputs differ")
        p1, t1, t2, p2 = (measure(fns[s], kernel)
                          for s in ("parent", "tree", "tree", "parent"))
        row = {side: {k: statistics.median([x[k], y[k]]) for k in x}
               for side, (x, y) in (("parent", (p1, p2)), ("tree", (t1, t2)))}
        results[label] = row
        print(f"{label}: " + "; ".join(
            f"{k} {row['parent'][k]:.5f} -> {row['tree'][k]:.5f}"
            for k in row["parent"]), flush=True)
    if args.grid:
        results["plans"] = plan_sweep(trees["tree"], cells, timing)
    if args.egress:
        results["tiles"] = tile_sweep(trees["tree"], cells, timing)
    print(smi)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
