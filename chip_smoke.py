"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. Require CUDA; print the torch, CUDA, nvcc and card versions.
  2. Build the kernels (K1 h264t_emit_fused, K2 h264t_pack_place) from
     h264_scroll_encoder_tpu_torch/csrc/*.cu with nvcc.
  3. Hold each kernel against its plain PyTorch version on CUDA tensors,
     exactly (tolerance: none — outputs are integers and bytes): the
     byte-stream, overflow, alignment and zero-run-window cases of the
     tests, and real 1280x720 symbol batches at B = 256.
  4. Drive the main path — `parallel.batch.make_batched_step` at 1280x720
     — over the benchmark's 32-frame schedule at B = 256, then the golden
     batch-8 schedule and one `ebsp_exact` (K2) frame per session, whose
     digests must equal golden/scroll_720p.json (the JAX package's
     output).  Launch counters are reset just before and read just after.
  5. Print the kernel table (one JSON line), the card's name and power
     limit, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
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


def _max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel output {g.dtype}{tuple(g.shape)} vs "
                                 f"plain {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()) if g.numel() else 0)
    return err


def main() -> int:
    # -- 1. CUDA and versions ----------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from h264_scroll_encoder_tpu_torch import _kernels, cases
    from h264_scroll_encoder_tpu_torch.config import ComposerConfig
    from h264_scroll_encoder_tpu_torch.models import scroll
    from h264_scroll_encoder_tpu_torch.ops import bitpack, bitpack_flat, emit_fused
    from h264_scroll_encoder_tpu_torch.parallel import batch

    dev = torch.device("cuda", 0)
    smi = _smi()
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, nvcc: "
         f"{nvcc.stdout.strip().splitlines()[-1]}")
    _log(f"card: {smi}")

    # -- 2. Build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _kernels.build()
    _log(f"phase 2: built {lib.name} in {time.perf_counter() - t0:.2f} s")

    # -- 3. Kernels vs plain versions on the card ----------------------------
    def cu(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.int64)
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

    k1_err = 0
    k2_err = 0

    def check_k1(name, pat, nb, idc, n_rbsp, cap, **kw):
        nonlocal k1_err
        got = emit_fused.emit_nal_fused_batch(cu(pat), cu(nb), idc, n_rbsp,
                                              cap, **kw)
        want = emit_fused.emit_nal_fused_plain(cu(pat), cu(nb), idc, n_rbsp,
                                               cap, **kw)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"K1 {name}: kernel != plain (max err {err})")
        k1_err = max(k1_err, err)
        return got

    def check_k2(name, pat, nb, num_words):
        nonlocal k2_err
        got = bitpack_flat.pack_words_place_batch(cu(pat), cu(nb), num_words)
        want = bitpack_flat.pack_words_place_plain(cu(pat), cu(nb), num_words)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"K2 {name}: kernel != plain (max err {err})")
        k2_err = max(k2_err, err)

    cap = cases.CAP
    pat, nb = cases.byte_stream_cases()
    for align in (False, True):
        for tb in (False, True):
            check_k1(f"bytes align={align} tb={tb}", pat, nb, 2,
                     cases.N_RBSP, cap, align=align, append_tb=tb)
    p1, n1 = cases.overflow_case()
    ovf = check_k1("overflow", p1[None], n1[None], 0, cases.N_RBSP, cap)[3]
    if not bool(ovf[0]):
        raise AssertionError("K1 did not flag the over-cap stream")
    pat, nb, _runs = cases.window_sweep_cases()
    # Cap 64: the zero-run window, not the insertion count, decides.
    check_k1("window sweep", pat, nb, 0, cases.N_RBSP, 64)
    pat, nb = cases.align_cases()
    check_k1("align+tb", pat, nb, 3, cases.N_RBSP, cap, align=True,
             append_tb=True)
    check_k1("align", pat, nb, 3, cases.N_RBSP, cap, align=True)
    got = check_k1("sentinel without align", pat, nb, 3, cases.N_RBSP, cap,
                   append_tb=True)
    has_sentinel = torch.as_tensor((nb < 0).any(axis=1), device=dev)
    if not bool(torch.all(got[3][has_sentinel])):
        raise AssertionError("K1 did not flag sentinels without align")
    for n, nw in ((1024, 300), (64, 80), (200, 64), (8483, 1490)):
        p2, n2 = cases.pack_cases(n, 8, n, nw)
        check_k2(f"pack n={n}", p2, n2, nw)

    # Real 720p symbols at B = 256: step 0 of the benchmark schedule.
    cfg = ComposerConfig(1280, 720)
    B = 256
    schedule = torch.as_tensor(cases.bench_schedule(cfg.height, B), device=dev)
    state = batch.SessionState.create(B, device=dev)
    needs = scroll.needs_waypoint(schedule[0], state.wp_offsets,
                                  state.wp_valid, state.wp_count)
    sym_pat, sym_nb, n_rbsp, idc = scroll.unified_frame_symbols(
        cfg, state.frame_num, schedule[0], state.wp_offsets, state.wp_ltidx,
        state.wp_valid, state.wp_count, needs)
    got = check_k1("720p B=256", sym_pat, sym_nb, idc, n_rbsp, cap,
                   append_tb=True)
    if bool(got[3].any()):
        raise AssertionError("720p symbols overflowed the bounded path")
    # K2's 720p input: the same symbols plus the trailing-bits symbol, into
    # the exact path's buffer (finish_slice with ebsp_exact=True).
    tb_pat, tb_nb = bitpack.trailing_bits_symbol(sym_nb.sum(dim=1))
    exact_pat = torch.cat([sym_pat, tb_pat[:, None]], dim=1)
    exact_nb = torch.cat([sym_nb, tb_nb[:, None]], dim=1)
    exact_words = (scroll.max_rbsp_bytes(cfg) + 3) // 4
    check_k2("720p B=256", exact_pat, exact_nb, exact_words)
    _log(f"phase 3: K1 and K2 equal their plain versions on every case "
         f"(720p: n={sym_pat.shape[1]} symbols, n_rbsp={n_rbsp} B)")

    # Timing at the 720p B = 256 shapes: the kernel alone (launched on
    # prepared int32 inputs), its wrapper (int64 -> int32 conversion plus
    # kernel) and the plain version, in turns: plain, kernel, kernel, plain.
    pat32, nb32 = _kernels.as_i32_bits(sym_pat), sym_nb.to(torch.int32)
    idc32 = idc.to(torch.int32).contiguous()
    epat32, enb32 = _kernels.as_i32_bits(exact_pat), exact_nb.to(torch.int32)
    runs = {
        "K1": (lambda: emit_fused.launch_kernel(
                   pat32, nb32, idc32, n_rbsp, cap, align=False,
                   append_tb=True),
               lambda: emit_fused.emit_nal_fused_batch(
                   sym_pat, sym_nb, idc, n_rbsp, cap, append_tb=True),
               lambda: emit_fused.emit_nal_fused_plain(
                   sym_pat, sym_nb, idc, n_rbsp, cap, append_tb=True)),
        "K2": (lambda: bitpack_flat.launch_kernel(epat32, enb32, exact_words),
               lambda: bitpack_flat.pack_words_place_batch(
                   exact_pat, exact_nb, exact_words),
               lambda: bitpack_flat.pack_words_place_plain(
                   exact_pat, exact_nb, exact_words)),
    }
    timing = {}
    for name, (kernel, wrapper, plain) in runs.items():
        p_a = _cuda_ms(plain, 10)
        k_a = _cuda_ms(kernel, 20)
        w = _cuda_ms(wrapper, 20)
        k_b = _cuda_ms(kernel, 20)
        p_b = _cuda_ms(plain, 10)
        timing[name] = (statistics.median([k_a, k_b]),
                        statistics.median([p_a, p_b]))
        _log(f"phase 3: {name} at 720p B=256: kernel {k_a:.4f}/{k_b:.4f} ms, "
             f"wrapper {w:.4f} ms, plain {p_a:.4f}/{p_b:.4f} ms "
             f"(CUDA-event medians)")

    # -- 4. The main path ----------------------------------------------------
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(B, device=dev)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    step_ms, wall_ms, waypoints = [], [], 0
    for offs in schedule:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, (nal, nal_len, wp, bits, ovf) = step(state, offs)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        if bool(ovf.any()):
            raise AssertionError("batch-256 720p step overflowed")
        if nal.shape != (B, emit_fused.nal_bytes(n_rbsp, cap)):
            raise AssertionError(f"unexpected NAL shape {tuple(nal.shape)}")
        lens = nal_len.cpu()
        if not bool(((lens > 5) & (lens <= nal.shape[1])).all()):
            raise AssertionError("NAL length out of range")
        waypoints += int(wp.sum())
    k1_steps = _kernels.EMIT_FUSED.launches
    if k1_steps != len(schedule):
        raise AssertionError(f"K1 launched {k1_steps} times in "
                             f"{len(schedule)} steps")
    golden = json.loads(cases.GOLDEN_PATH.read_text())
    if cases.port_golden(dev) != golden:
        raise AssertionError("CUDA output differs from the golden digests")
    launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    torch.cuda.synchronize()
    for k in _kernels.KERNELS:
        if launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on the main path")
    _log(f"phase 4: {len(schedule)} steps at B={B}: no overflow, "
         f"{waypoints} waypoint frames, K1 launches {k1_steps}; golden "
         f"digests match; launches {launches}")
    _log(f"phase 4: batch-256 720p step: {statistics.median(step_ms):.4f} ms "
         f"(CUDA-event median), host wall {statistics.median(wall_ms):.4f} ms "
         f"(median)")

    # -- 5. Results ------------------------------------------------------------
    src = "h264_scroll_encoder_tpu_torch/csrc/emit_kernels.cu"
    kernels = [
        {"name": "emit_fused (K1)", "route": "cuda", "source": src,
         "replaces": "h264_scroll_encoder_tpu/ops/emit_fused.py:214",
         "launches": launches["h264t_emit_fused"], "max_abs_err": k1_err,
         "ms": timing["K1"][0], "plain_ms": timing["K1"][1]},
        {"name": "pack_place (K2)", "route": "cuda", "source": src,
         "replaces": "h264_scroll_encoder_tpu/ops/bitpack_flat.py:435",
         "launches": launches["h264t_pack_place"], "max_abs_err": k2_err,
         "ms": timing["K2"][0], "plain_ms": timing["K2"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
