"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. Require CUDA; print the torch, CUDA, nvcc and card versions.
  2. Build, started together: the kernels (K1 h264t_emit_fused, K2
     h264t_pack_place, K3 h264t_ebsp_nal, K4 h264t_pack_words) from
     h264_scroll_encoder_tpu_torch/csrc/*.cu with nvcc, and the native
     CAVLC engine from csrc/cavlc_decode.cpp with g++.
  3. Hold each kernel against its plain PyTorch version on CUDA tensors,
     exactly (tolerance: none — outputs are integers and bytes): the
     byte-stream, overflow, alignment, saturation, truncation and pack
     boundary cases of the tests (K3's at each of its NAL sizes, with int32
     and int64 lengths and tensor and int headers), real 1280x720 scroll
     and splice symbol batches at B = 256 (K1, K2, K4; K1 also at
     B = 1,024), K1, K2 and K4 on int32 and on int64 symbols, and the
     splice frames' RBSP bytes (K3); K3's bytes per thread, which the
     boundary cases follow, equal ops/ebsp_flat.items_per_thread.  Show
     that the wrappers run no tensor
     op (no conversion) around their kernel on the entry path's inputs:
     int64 symbols (K1, K2, K4), uint8 bytes with int64 lengths and an int
     header (K3).  Time each kernel's device time per call (calls queued
     back to back), one call as a caller waits for it, the host's issue
     time per call, and the plain version (CUDA-event medians); K1 also on
     int32 symbols, K1 and K3 also at B = 1 and 1,024.
  4. The scroll path — `parallel.batch.make_batched_step` at 1280x720 —
     over 16 frames of the benchmark's schedule at B = 256, then the
     golden batch-8 schedule and one `ebsp_exact` (K2) frame per session,
     whose digests must equal golden/scroll_720p.json (the JAX package's
     output).
  5. The rows splice path (the serving hot path): 32 seeded representative
     donors prepared by the native engine into the blob wire (host time per
     donor; the Python engine must give the same wire), tiled to B = 256
     and 1,024 sessions and spliced at bench.py's geometry (23x23 MBs at
     MB (30, 10)) by the compact and the static-chrome programs, plus one
     `ebsp_exact` frame per session; every session's digest must equal
     golden/splice_rows_720p.json, no frame may overflow, and K1 launches
     once per step.  Step times: CUDA events and host wall; launches per
     step from torch.profiler.
  6. K3 and K4 through their own entry points (ops/ebsp_flat
     `rbsp_to_nal_batch`, ops/bitpack_flat `pack_words_batch`) on the
     splice frames at B = 256; K3's NAL must equal K1's bytes wherever K1
     did not flag the frame.
  7. Print the kernel table (one JSON line; `ms` is one call on an idle
     card, as in the first port's rows, with `device_ms` and `host_ms`
     beside it), the card's name and power limit, and the result line.

Launch counters are set to 0 just before each path (4, 5, 6) and read
just after; every kernel must have launched on its path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM device memory bandwidth (NVIDIA's data sheet), bytes per ms.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
N_DONORS = 32


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel output {g.dtype}{tuple(g.shape)} vs "
                                 f"plain {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()) if g.numel() else 0)
    return err


def _build_all(_kernels, native_bridge):
    """nvcc (kernels) and g++ (CAVLC engine) started together; returns
    {name: (path, seconds)}; a failed build raises."""
    results, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=("kernels", _kernels.build)),
               threading.Thread(target=run, args=("cavlc", native_bridge.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


class Timer:
    """Step timing: CUDA-event and host-wall milliseconds per call."""

    def __init__(self):
        self.cuda_ms, self.wall_ms = [], []

    def __call__(self, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.wall_ms.append((time.perf_counter() - t0) * 1e3)
        self.cuda_ms.append(start.elapsed_time(end))
        return out

    def medians(self):
        return statistics.median(self.cuda_ms), statistics.median(self.wall_ms)


def _profile_launches(fn, steps: int):
    """(cudaLaunchKernel calls per step, device ms per step) over `steps`
    calls of fn under torch.profiler, or None when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunch"))
    # Device-side events only: a CPU op's self device time repeats its
    # kernels' time.
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        return None
    return launches / steps, dev_us / 1e3 / steps


def main() -> int:
    # -- 1. CUDA and versions ----------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from h264_scroll_encoder_tpu_torch import _kernels, cases, native_bridge
    from h264_scroll_encoder_tpu_torch.config import ComposerConfig
    from h264_scroll_encoder_tpu_torch.models import scroll
    from h264_scroll_encoder_tpu_torch.ops import (bitpack, bitpack_flat,
                                                   ebsp_flat, emit_fused)
    from h264_scroll_encoder_tpu_torch.parallel import batch
    from h264_scroll_encoder_tpu_torch.utils import timing as timing_

    dev = torch.device("cuda", 0)
    smi = _smi()
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, nvcc: "
         f"{nvcc.stdout.strip().splitlines()[-1]}")
    _log(f"card: {smi}")

    # -- 2. Build ------------------------------------------------------------
    built = _build_all(_kernels, native_bridge)
    for name, (path, secs) in built.items():
        _log(f"phase 2: built {path.name} ({name}) in {secs:.2f} s")
    native_bridge.load_library()

    # -- 3. Kernels vs plain versions on the card ----------------------------
    def cu(a, int32=False):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)
        return cases.int32_bits(a) if int32 else a.to(dev, torch.int64)

    errs = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def hold(name, case, got, want):
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} {case}: kernel != plain (max err {err})")
        errs[name] = max(errs[name], err)
        return got

    def check_k1(case, pat, nb, idc, n_rbsp, cap, **kw):
        """K1 on int32 and on int64 symbols; returns the int64 result."""
        for int32 in (True, False):
            args = (cu(pat, int32), cu(nb, int32), idc, n_rbsp, cap)
            got = hold("K1", f"{case} int{32 if int32 else 64}",
                       emit_fused.emit_nal_fused_batch(*args, **kw),
                       emit_fused.emit_nal_fused_plain(*args, **kw))
        return got

    def check_pack(name, case, pat, nb, num_words):
        entry = (bitpack_flat.pack_words_place_batch if name == "K2"
                 else bitpack_flat.pack_words_batch)
        for int32 in (True, False):
            args = (cu(pat, int32), cu(nb, int32), num_words)
            got = hold(name, f"{case} int{32 if int32 else 64}", entry(*args),
                       bitpack_flat.pack_words_place_plain(*args))
        return got

    def check_k3(case, rbsp, lens, hdr, n_nal, cap):
        args = tuple(x if isinstance(x, int) else torch.as_tensor(x, device=dev)
                     for x in (rbsp, lens, hdr)) + (n_nal, cap)
        return hold("K3", case, ebsp_flat.rbsp_to_nal_batch(*args),
                    ebsp_flat.rbsp_to_nal_plain(*args))

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
    pat, nb, _runs, c_rbsp = cases.chunk_zero_run_cases()
    check_k1("chunk zero runs", pat, nb, 0, c_rbsp, 64)
    pat, nb = cases.align_cases()
    check_k1("align+tb", pat, nb, 3, cases.N_RBSP, cap, align=True,
             append_tb=True)
    check_k1("align", pat, nb, 3, cases.N_RBSP, cap, align=True)
    got = check_k1("sentinel without align", pat, nb, 3, cases.N_RBSP, cap,
                   append_tb=True)
    has_sentinel = torch.as_tensor((nb < 0).any(axis=1), device=dev)
    if not bool(torch.all(got[3][has_sentinel])):
        raise AssertionError("K1 did not flag sentinels without align")
    for n in cases.PACK_BOUNDARY_LENGTHS:
        pat, nb, b_rbsp = cases.pack_boundary_cases(n)
        for align in (False, True):
            check_k1(f"pack boundary n={n} align={align}", pat, nb,
                     torch.arange(len(pat)) % 4, b_rbsp, cap, align=align,
                     append_tb=True)
        pat, nb, b_rbsp = cases.pack_boundary_cases(n, sentinels=False)
        for k in ("K2", "K4"):
            for nw in (b_rbsp // 4, b_rbsp // 8):
                check_pack(k, f"pack boundary n={n} words={nw}", pat, nb, nw)
    for k in ("K2", "K4"):
        for n, nw in ((1024, 300), (64, 80), (200, 64), (8483, 1490)):
            p2, n2 = cases.pack_cases(n, 8, n, nw)
            check_pack(k, f"pack n={n}", p2, n2, nw)
    for seed, (n, nw) in enumerate(((100, 10), (257, 30), (64, 3), (5, 1),
                                    (1000, 40), (1000, 1000))):
        p2, n2 = cases.pack_edge_case(seed, n, nw)
        check_pack("K4", f"edge n={n} words={nw}", p2[None], n2[None], nw)
    rbsp, lens, hdr = cases.ebsp_cases()
    for k3_cap in (cap, 1000):
        check_k3(f"bytes cap={k3_cap}", rbsp, lens, hdr, cases.EBSP_N_NAL,
                 k3_cap)
    rb, rb_len = cases.ebsp_saturation_case()
    sat = check_k3("saturation", rb[None], [rb_len], [0x41], 384, cap)
    if not int(sat[1][0]) > cap:
        raise AssertionError("K3 did not saturate past the window")
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    for n_nal in cases.EBSP_BOUNDARY_N_NALS:
        for k3_cap in (cap, 1000):
            check_k3(f"boundary n_nal={n_nal} cap={k3_cap}", rbsp, lens, hdr,
                     n_nal, k3_cap)
            check_k3(f"boundary n_nal={n_nal} cap={k3_cap} int64 lengths",
                     rbsp, lens.astype(np.int64), 0x41, n_nal, k3_cap)
    # The boundary cases follow ebsp_flat.items_per_thread; the built K3
    # must own the same runs.
    for valid in range(ebsp_flat.padded_len(max(cases.EBSP_BOUNDARY_N_NALS)) + 1):
        if ebsp_flat.items_per_thread(valid) != _kernels.ebsp_items_per_thread(valid):
            raise AssertionError(f"K3's bytes per thread at {valid} differ "
                                 "from ebsp_flat.items_per_thread")

    # Real 720p scroll symbols at B = 256: step 0 of the benchmark schedule.
    cfg = ComposerConfig(1280, 720)
    B = 256
    schedule = torch.as_tensor(cases.bench_schedule(cfg.height, B, 16),
                               device=dev)
    state = batch.SessionState.create(B, device=dev)
    needs = scroll.needs_waypoint(schedule[0], state.wp_offsets,
                                  state.wp_valid, state.wp_count)
    sym_pat, sym_nb, n_rbsp, idc = scroll.unified_frame_symbols(
        cfg, state.frame_num, schedule[0], state.wp_offsets, state.wp_ltidx,
        state.wp_valid, state.wp_count, needs)
    got = check_k1("scroll 720p B=256", sym_pat, sym_nb, idc, n_rbsp, cap,
                   append_tb=True)
    if bool(got[3].any()):
        raise AssertionError("720p symbols overflowed the bounded path")

    # Real 720p splice symbols: the compact program's input, sessions
    # carrying the 32 donors in turn, at B = 256 (and 1 and 1,024 for K1).
    payloads = [cases.splice_donor_payload(k) for k in range(N_DONORS)]
    dn32, bits32, align32 = cases.prepare_splice_donors(
        payloads, engine="native", device=dev)
    has_align = bool(align32.any())
    s_n_rbsp = cases.splice_budget(cfg, int(bits32.max()), static_bg=False)

    def tile(B):
        return {"blob": dn32["blob"][torch.arange(B, device=dev) % N_DONORS]}

    s_pat, s_nb = cases.splice_symbols(cfg, dn32, B, s_n_rbsp, dev)
    s_idc = 0  # the splice step's nal_ref_idc
    got = check_k1("splice 720p B=256", s_pat, s_nb, s_idc, s_n_rbsp, cap,
                   align=has_align, append_tb=True)
    if bool(got[3].any()):
        raise AssertionError("720p splice symbols overflowed the bounded path")
    k1_sym = {1: (s_pat[:1], s_nb[:1]), B: (s_pat, s_nb),
              1024: cases.splice_symbols(cfg, dn32, 1024, s_n_rbsp, dev)}
    check_k1("splice 720p B=1024", *k1_sym[1024], s_idc, s_n_rbsp, cap,
             align=has_align, append_tb=True)

    # K2/K4 input: the splice symbols plus the trailing-bits symbol, into
    # the exact path's buffer (finish_slice with ebsp_exact=True).
    tb_pat, tb_nb = bitpack.trailing_bits_symbol(s_nb.sum(dim=1))
    exact_pat = torch.cat([s_pat, tb_pat[:, None]], dim=1)
    exact_nb = torch.cat([s_nb, tb_nb[:, None]], dim=1)
    exact_words = (s_n_rbsp + 3) // 4
    for k in ("K2", "K4"):
        words, total = check_pack(k, "splice 720p B=256", exact_pat, exact_nb,
                                  exact_words)
    # K3 input: those frames' RBSP bytes, into K1's NAL buffer size, with
    # the lengths (int64) and header (an int) as the entry path hands them.
    rbsp_720 = bitpack.words_to_bytes(words)[:, :s_n_rbsp].to(torch.uint8)
    rbsp_len = total // 8
    k3_n_nal = emit_fused.nal_bytes(s_n_rbsp, cap)
    check_k3("splice 720p B=256", rbsp_720, rbsp_len, 0x01, k3_n_nal, cap)
    check_k3("splice 720p B=256 int32", rbsp_720, rbsp_len.to(torch.int32),
             torch.full((B,), 0x01, dtype=torch.int32, device=dev), k3_n_nal,
             cap)

    # The wrappers run no conversion (or any other tensor op but
    # allocations and views) around their kernel on the main path's int64
    # symbols, and K3's on uint8 bytes, int64 lengths and an int header.
    for name, fn in (
            ("K1", lambda: emit_fused.emit_nal_fused_batch(
                s_pat, s_nb, s_idc, s_n_rbsp, cap, align=has_align,
                append_tb=True)),
            ("K2", lambda: bitpack_flat.pack_words_place_batch(
                exact_pat, exact_nb, exact_words)),
            ("K4", lambda: bitpack_flat.pack_words_batch(
                exact_pat, exact_nb, exact_words)),
            ("K3", lambda: ebsp_flat.rbsp_to_nal_batch(
                rbsp_720, rbsp_len, 0x01, k3_n_nal, cap))):
        ops = cases.compute_ops(fn)
        if ops:
            raise AssertionError(f"{name}'s wrapper ran tensor ops {ops} on "
                                 "the entry path's inputs")
    _log(f"phase 3: K1-K4 equal their plain versions on every case, K1, K2 "
         f"and K4 on int32 and int64 symbols, K3 on int32 and int64 lengths "
         f"(scroll 720p: n={sym_pat.shape[1]} symbols, n_rbsp={n_rbsp} B; "
         f"splice 720p: n={s_pat.shape[1]} symbols, n_rbsp={s_n_rbsp} B, NAL "
         f"buffer {k3_n_nal} B, mean RBSP {float(rbsp_len.float().mean()):.1f} "
         f"B); no wrapper runs a tensor op on the entry path's inputs")

    # Timing at the 720p B = 256 splice shapes (K1 and K3 also at B = 1
    # and 1,024, K1 at the scroll shapes): the kernel's device time on the
    # main path's inputs (calls queued back to back) and K1's and K2's on
    # int32, one call as a caller waits for it (host issue + device: the
    # method of the first port's rows) and the plain version's call, in
    # turns: plain, kernel, kernel, plain.  All through the wrappers.
    e32 = (cases.int32_bits(exact_pat), cases.int32_bits(exact_nb))

    k3_rows = {b: torch.arange(b, device=dev) % B  # the sessions' frames in turn
               for b in (1, B, 1024)}

    def k3_run(b):
        rows = k3_rows[b]
        args = (rbsp_720[rows], rbsp_len[rows], 0x01, k3_n_nal, cap)
        return (lambda: ebsp_flat.rbsp_to_nal_batch(*args),
                lambda: ebsp_flat.rbsp_to_nal_plain(*args))

    def k1_run(pat_nb, idc_, n_rbsp_, **kw):
        return (lambda: emit_fused.emit_nal_fused_batch(*pat_nb, idc_, n_rbsp_,
                                                        cap, **kw),
                lambda: emit_fused.emit_nal_fused_plain(*pat_nb, idc_, n_rbsp_,
                                                        cap, **kw))

    splice_kw = dict(align=has_align, append_tb=True)
    runs = {
        "K1": k1_run(k1_sym[B], s_idc, s_n_rbsp, **splice_kw),
        "K1 int32": k1_run(tuple(cases.int32_bits(x) for x in k1_sym[B]), s_idc,
                           s_n_rbsp, **splice_kw),
        "K1 B=1": k1_run(k1_sym[1], s_idc, s_n_rbsp, **splice_kw),
        "K1 B=1024": k1_run(k1_sym[1024], s_idc, s_n_rbsp, **splice_kw),
        "K1 scroll": k1_run((sym_pat, sym_nb), idc, n_rbsp, append_tb=True),
        "K2": (lambda: bitpack_flat.pack_words_place_batch(
                   exact_pat, exact_nb, exact_words),
               lambda: bitpack_flat.pack_words_place_plain(
                   exact_pat, exact_nb, exact_words)),
        "K2 int32": (lambda: bitpack_flat.pack_words_place_batch(
                         *e32, exact_words),
                     lambda: bitpack_flat.pack_words_place_plain(
                         *e32, exact_words)),
        "K3": k3_run(B),
        "K3 B=1": k3_run(1),
        "K3 B=1024": k3_run(1024),
        "K4": (lambda: bitpack_flat.pack_words_batch(exact_pat, exact_nb,
                                                     exact_words),
               lambda: bitpack_flat.pack_words_place_plain(
                   exact_pat, exact_nb, exact_words)),
    }
    timing = {}
    for name, (kernel, plain) in runs.items():
        p_a = timing_.call_ms(plain, 10)
        d_a = timing_.device_ms(kernel)
        c = timing_.call_ms(kernel, 20)
        h = timing_.host_ms(kernel)
        d_b = timing_.device_ms(kernel)
        p_b = timing_.call_ms(plain, 10)
        timing[name] = {"ms": c, "device_ms": statistics.median([d_a, d_b]),
                        "host_ms": h, "plain_ms": statistics.median([p_a, p_b])}
        _log(f"phase 3: {name} at 720p: device {d_a:.5f}/{d_b:.5f} ms per "
             f"call, one call {c:.5f} ms, host issue {h:.5f} ms per call, "
             f"plain {p_a:.4f}/{p_b:.4f} ms (CUDA-event medians)")
    # Least time for each kernel's work at the timed shapes: its inputs read
    # once and its outputs written once at the card's memory rate.  K1, K2
    # and K4 keep the first port's formula (symbols counted as int32, NAL
    # plus 16 bytes of per-session results); they now read the main path's
    # int64 symbols in place, whose bytes are logged beside it.  K3's is
    # counted from this run's lengths: the valid bytes of each row it
    # stages, the int64 lengths, NAL plus count (the header is an int,
    # passed by value).  Its earlier formula, every row's whole RBSP
    # budget with lengths and headers as int32, is logged beside it.
    def k3_bytes(lens):
        staged = lens.clamp(0, min(s_n_rbsp, ebsp_flat.padded_len(k3_n_nal)))
        return (int(staged.sum()) + lens.numel() * lens.element_size()
                + lens.numel() * (k3_n_nal + 4))

    n_nal_s = emit_fused.nal_bytes(s_n_rbsp, cap)
    n_s, n_e = s_pat.shape[1], exact_pat.shape[1]
    pack_bytes = B * n_e * 8 + B * (exact_words + 1) * 4
    bound = {
        "K1 scroll": (B * sym_pat.shape[1] * 8 + B * 4
                      + B * (emit_fused.nal_bytes(n_rbsp, cap) + 16)),
        "K1": B * n_s * 8 + B * 4 + B * (n_nal_s + 16),
        "K2": pack_bytes,
        "K3": k3_bytes(rbsp_len[k3_rows[B]]),
        "K3 B=1": k3_bytes(rbsp_len[k3_rows[1]]),
        "K3 B=1024": k3_bytes(rbsp_len[k3_rows[1024]]),
        "K4": pack_bytes,
    }
    compare_bytes = {"K1": B * n_s * 16 + B * (n_nal_s + 9),
                     "K2": B * n_e * 16 + B * (exact_words + 1) * 8,
                     "K3 earlier formula": (B * s_n_rbsp + 2 * 4 * B
                                            + B * (k3_n_nal + 4))}
    bound_ms = {k: v / HBM_BYTES_PER_MS for k, v in bound.items()}
    _log("phase 3: memory bounds at 3.35 TB/s: " + ", ".join(
        f"{k} {v} B = {bound_ms[k]:.5f} ms" for k, v in bound.items()))
    _log("phase 3: for comparison, K1 and K2 on the int64 symbols as the main "
         "path hands them, and K3's earlier formula: " + ", ".join(
        f"{k} {v} B = {v / HBM_BYTES_PER_MS:.5f} ms" for k, v in compare_bytes.items()))

    # -- 4. The scroll path --------------------------------------------------
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(B, device=dev)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    timer, waypoints = Timer(), 0
    for offs in schedule:
        state, (nal, nal_len, wp, bits, ovf) = timer(lambda: step(state, offs))
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
        raise AssertionError("CUDA output differs from the scroll golden digests")
    torch.cuda.synchronize()
    scroll_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    for k in (_kernels.EMIT_FUSED, _kernels.PACK_PLACE):
        if scroll_launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on the scroll path")
    step_ms, wall_ms = timer.medians()
    _log(f"phase 4: scroll, {len(schedule)} steps at B={B}: no overflow, "
         f"{waypoints} waypoint frames; golden digests match; launches "
         f"{scroll_launches}")
    _log(f"phase 4: batch-256 720p scroll step: {step_ms:.4f} ms (CUDA-event "
         f"median), host wall {wall_ms:.4f} ms (median)")

    # -- 5. The rows splice path -----------------------------------------------
    prep_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        cases.prepare_splice_donors(payloads, engine="native", device=dev)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    one_ms = []
    for k in range(8):
        t0 = time.perf_counter()
        cases.prepare_splice_donors(payloads[k:k + 1], engine="native",
                                    device=dev)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    dn_py, bits_py, _ = cases.prepare_splice_donors(payloads[:1],
                                                    engine="python",
                                                    device="cpu")
    if not (torch.equal(dn32["blob"][0].cpu(), dn_py["blob"][0])
            and int(bits_py[0]) == int(bits32[0])):
        raise AssertionError("native and Python donor wires differ")
    _log(f"phase 5: host prep (native engine, blob wire, to the card): "
         f"{statistics.median(prep_ms) / N_DONORS:.4f} ms per donor in a "
         f"batch of {N_DONORS} (median of 5), "
         f"{statistics.median(one_ms):.4f} ms for one donor alone (median "
         f"of 8); wire {dn32['blob'].shape[1] * 4} B per donor; native wire "
         f"== Python engine's")

    splice_golden = json.loads(cases.SPLICE_GOLDEN_PATH.read_text())
    steps = cases.splice_steps(cfg, int(bits32.max()), has_align)
    n_warm, n_steps = 2, 20

    def check_digests(name, out, B):
        nal, nal_len, _bits, ovf = out
        if bool(ovf.any()):
            raise AssertionError(f"splice {name} B={B} overflowed")
        idx = [b for b in range(B) if b % N_DONORS < cases.SPLICE_GOLDEN_BATCH]
        got = cases.digest_step(nal[idx].cpu().numpy(), nal_len[idx].cpu().numpy(),
                                np.zeros(len(idx), bool), ovf[idx].cpu().numpy())
        want = [splice_golden[name][b % N_DONORS] for b in idx]
        if got != want:
            raise AssertionError(f"splice {name} B={B}: digests differ from "
                                 "the golden file")

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    n_run = 0
    for B_s in (256, 1024):
        args = cases.splice_session_inputs(cfg, B_s, dev) + (tile(B_s),)
        for name in ("compact", "static"):
            for _ in range(n_warm):
                check_digests(name, steps[name](*args), B_s)
            timer = Timer()
            for _ in range(n_steps):
                out = timer(lambda: steps[name](*args))
            n_run += n_warm + n_steps
            check_digests(name, out, B_s)
            step_ms, wall_ms = timer.medians()
            _log(f"phase 5: splice {name} B={B_s}: {step_ms:.4f} ms "
                 f"(CUDA-event median of {n_steps}), host wall {wall_ms:.4f} ms "
                 f"(median) = {B_s / wall_ms * 1e3:.1f} frames/s; NAL buffer "
                 f"{tuple(out[0].shape)}, mean nal_len "
                 f"{float(out[1].float().mean()):.1f} B")
        if B_s == 256:
            check_digests("ebsp_exact", steps["ebsp_exact"](*args), B_s)
    torch.cuda.synchronize()
    splice_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    if splice_launches["h264t_emit_fused"] != n_run:
        raise AssertionError(f"K1 launched {splice_launches['h264t_emit_fused']} "
                             f"times in {n_run} splice steps")
    for k in (_kernels.EMIT_FUSED, _kernels.PACK_PLACE):
        if splice_launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on the splice path")
    if cases.port_splice_golden(dev) != splice_golden:
        raise AssertionError("CUDA output differs from the splice golden digests")
    _log(f"phase 5: {n_run} splice steps + 1 ebsp_exact frame: no overflow, "
         f"digests match the golden file; launches {splice_launches}")
    for B_s in (256, 1024):
        args = cases.splice_session_inputs(cfg, B_s, dev) + (tile(B_s),)
        for name in ("compact", "static"):
            try:
                prof = _profile_launches(lambda: steps[name](*args), 5)
            except Exception as e:  # measurement only; outputs checked above
                prof = None
                _log(f"phase 5: torch.profiler failed: {e!r}")
            if prof is None:
                _log(f"phase 5: splice {name} B={B_s}: launches per step not "
                     "measured (no device time)")
            else:
                _log(f"phase 5: splice {name} B={B_s} under torch.profiler: "
                     f"{prof[0]:.1f} cudaLaunch calls per step, device time "
                     f"{prof[1]:.4f} ms per step")

    # -- 6. K3 and K4 through their own entry points ----------------------------
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    words, total = bitpack_flat.pack_words_batch(exact_pat, exact_nb, exact_words)
    rbsp = bitpack.words_to_bytes(words)[:, :s_n_rbsp].to(torch.uint8)
    nal3, count3 = ebsp_flat.rbsp_to_nal_batch(rbsp, total // 8, 0x01, k3_n_nal,
                                               cap)
    torch.cuda.synchronize()
    entry_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    for k in (_kernels.EBSP_NAL, _kernels.PACK_WORDS):
        if entry_launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on its entry path")
    nal1, len1, _bits, ovf1 = emit_fused.emit_nal_fused_batch(
        s_pat, s_nb, s_idc, s_n_rbsp, cap, align=has_align, append_tb=True)
    len3 = 5 + total // 8 + count3
    both = ~ovf1 & (count3 <= cap)
    for b in torch.nonzero(both).flatten().tolist():
        n = int(len1[b])
        if int(len3[b]) != n or not torch.equal(nal3[b, :n], nal1[b, :n]):
            raise AssertionError(f"K3 and K1 disagree on splice frame {b}")
    _log(f"phase 6: K4 then K3 on the splice frames at B={B}: K3's NAL equals "
         f"K1's on the {int(both.sum())} frames neither flagged; launches "
         f"{entry_launches}")

    # -- 7. Results ------------------------------------------------------------
    src = "h264_scroll_encoder_tpu_torch/csrc/emit_kernels.cu"
    rows = [
        ("emit_fused (K1)", "K1", "h264t_emit_fused", splice_launches,
         "h264_scroll_encoder_tpu/ops/emit_fused.py:214"),
        ("pack_place (K2)", "K2", "h264t_pack_place", splice_launches,
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:435"),
        ("ebsp_nal (K3)", "K3", "h264t_ebsp_nal", entry_launches,
         "h264_scroll_encoder_tpu/ops/ebsp_flat.py:158"),
        ("pack_words (K4)", "K4", "h264t_pack_words", entry_launches,
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:261"),
    ]
    # ms: one call as a caller waits for it (the method of the first port's
    # rows); device_ms: device time per call of calls queued back to back;
    # host_ms: the host's issue time per call.
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[sym], "max_abs_err": errs[key],
                **timing[key], "bound_ms": bound_ms[key], "bound_by": "bytes",
                "library_ms": None}
               for name, key, sym, counts, rep in rows]
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
