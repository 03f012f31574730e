"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. Require CUDA; print the torch, CUDA, nvcc and card versions.
  2. Build, started together: the kernels (K1 h264t_emit_fused, K2
     h264t_pack_place, K3 h264t_ebsp_nal, K4 h264t_pack_words) from
     h264_scroll_encoder_tpu_torch/csrc/*.cu with nvcc, the native CAVLC
     engine from csrc/cavlc_decode.cpp with g++, and avref from
     csrc/avref.c with gcc where the system has libavcodec (else a line
     says what is missing).
  3. Hold each kernel against its plain PyTorch version on CUDA tensors,
     exactly (tolerance: none — outputs are integers and bytes): the
     byte-stream, overflow, alignment, saturation, truncation and pack
     boundary cases of the tests (K3's at each of its NAL sizes, with int64
     lengths under each header byte, and rows read through a stride),
     K1 on the frames whose NAL passes a block's shared memory (3840x2160
     at 64 bits per MB, 5120x3200, the 720p dense frame of I_PCM donors:
     words and NAL in global memory, the 720p shapes' plans in shared
     memory), real 1280x720 scroll
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
  7. The per-session composer ("session") at 1280x720: one
     ComposerSession on the card over the scroll-encoder schedule (64
     frames through write_scroll_or_waypoint_frame, each timed: host wall
     with the frame's bytes on the host), two sliced frames, 8 hint frames
     and 2 spliced frames (one frame's launches, device time and tensor
     ops also counted); partitioned and nearest sessions; the
     scroll-encoder and composer CLIs (donors from the port's ipcm); a
     1920x1088 hint frame and a 3840x2160 scroll frame.  Every stream's
     sha256 must equal golden/session_720p.json and pass verify_stream;
     K1 launches once per device P-frame (once per sliced frame), K2 on a
     forced `ebsp_exact` frame.  Then make_batched_hint_step (compact_x)
     at B = 256 against the golden digest and compact_batch_nal on its
     output (exact bytes, overflow at total - 1), both timed (CUDA events
     and host wall).
  8. The dense splice path and the large frames ("dense", "large"):
     make_batched_splice_step_dense at bench.py's geometry over the 32
     representative donors at the honest budget, tiled to B = 256 and
     1,024 (every session's digest equals golden/splice_dense_720p.json
     and its bytes the rows step's), and over the same donors with one
     I_PCM MB each at the default budget, B = 256 (NAL buffer 237,600 B:
     K1 builds words and NAL in global memory), and one forced
     `ebsp_exact` retry (K1 then K2, bytes unchanged); step times (CUDA
     events, host wall) and launches per step (torch.profiler).  Then
     3840x2160 at 64 bits per MB and 5120x3200 hint frames through
     ComposerSession (golden/large_frames.json, verify_stream), K3 on
     rows at NAL sizes past a block's shared memory against its plain
     version, the pixel oracle on a 720p session at MB-aligned offsets,
     libavcodec (avref, where the system has it) on phase 7's and this
     phase's streams and on a 720p session with a fallback frame, and the
     trans-resizer on phase 7's composer stream (both engines equal).
  9. Print the kernel table (one JSON line; `ms` is one call on an idle
     card, as in the first port's rows, with `device_ms` and `host_ms`
     beside it; `launches` sums the paths, `launches_by_path` splits
     them), the card's name and power limit, and the result line.

Launch counters are set to 0 just before each path (4, 5, 6, 7, 8) and
read just after; every kernel must have launched on its path.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
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


def _build_all(_kernels, native_bridge, avref):
    """nvcc (kernels), g++ (CAVLC engine) and gcc (avref, where the system
    has libavcodec) started together; returns {name: (path, seconds)}; a
    failed build raises."""
    results, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    builds = [("kernels", _kernels.build), ("cavlc", native_bridge.build)]
    if avref.missing() is None:
        builds.append(("avref", avref.build))
    threads = [threading.Thread(target=run, args=b) for b in builds]
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


def _large_k1_inputs(dev, cases, ComposerConfig) -> dict:
    """K1's inputs on frames whose NAL buffer passes a block's shared
    memory: {name: (patterns, nbits, n_rbsp, kwargs)} for the two large
    hint frames (B = 1, the session's frame) and the 720p dense frames of
    the 32 I_PCM-bearing donors."""
    from h264_scroll_encoder_tpu_torch.models import hints, scroll, splice
    from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
        p_slice_header_symbols)

    out = {}
    z = torch.zeros((1, 8), dtype=torch.int64, device=dev)
    for name, (w, h, bits) in cases.LARGE_FRAMES.items():
        cfg = ComposerConfig(w, h, rbsp_bits_per_mb=bits)
        ref, mvx, mvy = hints.hint_fields(cfg, splice.FrameHints(
            motion_regions=tuple(splice.MotionRegion(*s)
                                 for s in cases.LARGE_HINT_REGIONS)), dev)
        hp, hn = p_slice_header_symbols(
            cfg, torch.tensor([2], device=dev), torch.tensor([4], device=dev),
            False, -1, 0, z, z.bool())
        pat, nb, n_rbsp = scroll.p_frame_symbols(
            cfg, hp, hn, ref[None], mvx[None], mvy[None], 2, enable_pskip=True)
        out[name] = (pat, nb, n_rbsp, {})
    cfg = ComposerConfig(cases.GOLDEN_WIDTH, cases.GOLDEN_HEIGHT)
    dn, bits, align = cases.prepare_dense_donors("ipcm", engine="native",
                                                 device=dev)
    pat, nb, n_rbsp = cases.dense_symbols(cfg, "ipcm", dn, bits, dev)
    out["dense_ipcm_720p"] = (pat, nb, n_rbsp, {"align": align})
    return out


def main() -> int:
    # -- 1. CUDA and versions ----------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from h264_scroll_encoder_tpu_torch import (_kernels, avref, cases,
                                               native_bridge)
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
    built = _build_all(_kernels, native_bridge, avref)
    for name, (path, secs) in built.items():
        _log(f"phase 2: built {path.name} ({name}) in {secs:.2f} s")
    if "avref" not in built:
        _log(f"phase 2: avref not built: {avref.missing()}")
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
        """K3 on rows with int64 lengths under one header byte, or per-row
        header bytes (one call per value); returns the last call's result."""
        rbsp = torch.as_tensor(rbsp, device=dev)
        lens = torch.as_tensor(lens, device=dev).to(torch.int64)
        groups = ([(None, hdr)] if isinstance(hdr, int) else
                  [(torch.as_tensor(hdr == h, device=dev), int(h))
                   for h in np.unique(hdr)])
        for rows, h in groups:
            args = ((rbsp, lens) if rows is None else
                    (rbsp[rows], lens[rows])) + (h, n_nal, cap)
            got = hold("K3", f"{case} header {h:#x}",
                       ebsp_flat.rbsp_to_nal_batch(*args),
                       ebsp_flat.rbsp_to_nal_plain(*args))
        return got

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
    sat = check_k3("saturation", rb[None], [rb_len], 0x41, 384, cap)
    if not int(sat[1][0]) > cap:
        raise AssertionError("K3 did not saturate past the window")
    rbsp, lens, hdr = cases.ebsp_boundary_cases()
    for n_nal in cases.EBSP_BOUNDARY_N_NALS:
        for k3_cap in (cap, 1000):
            check_k3(f"boundary n_nal={n_nal} cap={k3_cap}", rbsp, lens, hdr,
                     n_nal, k3_cap)
            check_k3(f"boundary n_nal={n_nal} cap={k3_cap} one header",
                     rbsp, lens, 0x165, n_nal, k3_cap)
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
    # The same step's partitioned frames: 4 slots per MB, two 12,288-symbol
    # chunks, 16x8 seam rows (the session slice's new K1 shape).
    part_pat, part_nb, part_rbsp, part_idc = scroll.unified_frame_symbols(
        cfg, state.frame_num, schedule[0], state.wp_offsets, state.wp_ltidx,
        state.wp_valid, state.wp_count, needs, boundary_policy="partitioned")
    got = check_k1("partitioned 720p B=256", part_pat, part_nb, part_idc,
                   part_rbsp, cap, append_tb=True)
    if bool(got[3].any()):
        raise AssertionError("720p partitioned symbols overflowed")

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
    strided = torch.zeros((B, s_n_rbsp + 9), dtype=torch.uint8, device=dev)
    strided[:, 3:-6] = rbsp_720
    check_k3("splice 720p B=256 strided rows", strided[:, 3:-6], rbsp_len,
             0x01, k3_n_nal, cap)

    # Frames whose NAL buffer passes a block's shared memory.  K1 on
    # the 3840x2160 hint frame at 64 bits per MB, the 5120x3200 one at 32
    # (words and NAL in global memory) and the 720p dense frame of I_PCM
    # donors at its default budget; the 720p shapes keep both in shared
    # memory.
    large_k1 = _large_k1_inputs(dev, cases, ComposerConfig)
    for name, (pat_l, nb_l, rbsp_l, kw_l) in large_k1.items():
        plan = _kernels.emit_plan(8, emit_fused.items_per_thread(pat_l.shape[1]),
                                  emit_fused.nal_bytes(rbsp_l, cap))
        if tuple(plan) != (True, True):
            raise AssertionError(f"K1 at {name}: plan {plan}, not global")
        got = check_k1(f"large {name}", pat_l, nb_l, 0, rbsp_l, cap,
                       append_tb=True, **kw_l)
        if bool(got[3].any()):
            raise AssertionError(f"K1 flagged the large frame {name}")
    for shape in ((8, sym_pat.shape[1], n_rbsp), (8, s_pat.shape[1], s_n_rbsp),
                  (8, part_pat.shape[1], part_rbsp)):
        sym_bytes, n_sym, budget = shape
        plan = _kernels.emit_plan(sym_bytes, emit_fused.items_per_thread(n_sym),
                                  emit_fused.nal_bytes(budget, cap))
        if tuple(plan) != (False, False):
            raise AssertionError(f"a 720p K1 shape {shape} left shared memory")
    if _kernels.ebsp_nal_in_global(k3_n_nal):
        raise AssertionError("K3 at the 720p NAL size left shared memory")

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
         f"and K4 on int32 and int64 symbols, K3 on int64 lengths under each "
         f"header byte and on strided rows; K1 on {sorted(large_k1)} with "
         f"words and NAL in global memory, the 720p shapes in shared memory "
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

    def k3_large_run(n_nal):
        rows, lens = cases.ebsp_large_cases(n_nal)
        args = (torch.as_tensor(rows, device=dev),
                torch.as_tensor(lens, device=dev), 0x61, n_nal, cap)
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
        "K1 partitioned": k1_run((part_pat, part_nb), part_idc, part_rbsp,
                                 append_tb=True),
        "K1 scroll B=1": k1_run((sym_pat[:1], sym_nb[:1]), idc[:1], n_rbsp,
                                append_tb=True),
        "K1 partitioned B=1": k1_run((part_pat[:1], part_nb[:1]), part_idc[:1],
                                     part_rbsp, append_tb=True),
        "K2": (lambda: bitpack_flat.pack_words_place_batch(
                   exact_pat, exact_nb, exact_words),
               lambda: bitpack_flat.pack_words_place_plain(
                   exact_pat, exact_nb, exact_words)),
        "K2 int32": (lambda: bitpack_flat.pack_words_place_batch(
                         *e32, exact_words),
                     lambda: bitpack_flat.pack_words_place_plain(
                         *e32, exact_words)),
        "K1 dense I_PCM 720p B=32 (global NAL)": k1_run(
            large_k1["dense_ipcm_720p"][:2], 0, large_k1["dense_ipcm_720p"][2],
            align=True, append_tb=True),
        "K1 hint 5120x3200 B=1 (global NAL)": k1_run(
            large_k1["hint_5120x3200"][:2], 0, large_k1["hint_5120x3200"][2],
            append_tb=True),
        "K3 n_nal=259328 B=4 (global)": k3_large_run(259_328),
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
        where = "" if "global" in name else " at 720p"
        p_a = timing_.call_ms(plain, 10)
        d_a = timing_.device_ms(kernel)
        c = timing_.call_ms(kernel, 20)
        h = timing_.host_ms(kernel)
        d_b = timing_.device_ms(kernel)
        p_b = timing_.call_ms(plain, 10)
        timing[name] = {"ms": c, "device_ms": statistics.median([d_a, d_b]),
                        "host_ms": h, "plain_ms": statistics.median([p_a, p_b])}
        _log(f"phase 3: {name}{where}: device {d_a:.5f}/{d_b:.5f} ms per "
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
        "K1 partitioned": (B * part_pat.shape[1] * 8 + B * 4
                           + B * (emit_fused.nal_bytes(part_rbsp, cap) + 16)),
        "K1": B * n_s * 8 + B * 4 + B * (n_nal_s + 16),
        "K2": pack_bytes,
        "K3": k3_bytes(rbsp_len[k3_rows[B]]),
        "K3 B=1": k3_bytes(rbsp_len[k3_rows[1]]),
        "K3 B=1024": k3_bytes(rbsp_len[k3_rows[1024]]),
        "K4": pack_bytes,
    }
    # The global plans' timed shapes, by the same formulas.
    for name, key in (
            ("K1 dense I_PCM 720p B=32 (global NAL)", "dense_ipcm_720p"),
            ("K1 hint 5120x3200 B=1 (global NAL)", "hint_5120x3200")):
        pat_g, _nb, rbsp_g, _kw = large_k1[key]
        b_g = pat_g.shape[0]
        bound[name] = (b_g * pat_g.shape[1] * 8 + b_g * 4
                       + b_g * (emit_fused.nal_bytes(rbsp_g, cap) + 16))
    g_rows, g_lens = cases.ebsp_large_cases(259_328)
    g_staged = np.clip(g_lens, 0, min(g_rows.shape[1],
                                      ebsp_flat.padded_len(259_328)))
    bound["K3 n_nal=259328 B=4 (global)"] = (int(g_staged.sum()) + 8 * len(g_lens)
                                            + len(g_lens) * (259_328 + 4))
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

    # -- 7. The per-session composer --------------------------------------------
    session_launches, streams7 = _session_phase(dev, cfg, cases, batch,
                                                _kernels, Timer)

    # -- 8. The dense splice path and the large frames ---------------------------
    dense_launches, large_launches = _dense_phase(
        dev, cfg, cases, batch, _kernels, Timer, avref, streams7, dn32, bits32,
        has_align)

    # -- 9. Results ------------------------------------------------------------
    src = "h264_scroll_encoder_tpu_torch/csrc/emit_kernels.cu"
    rows = [
        ("emit_fused (K1)", "K1", "h264t_emit_fused",
         "h264_scroll_encoder_tpu/ops/emit_fused.py:214"),
        ("pack_place (K2)", "K2", "h264t_pack_place",
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:435"),
        ("ebsp_nal (K3)", "K3", "h264t_ebsp_nal",
         "h264_scroll_encoder_tpu/ops/ebsp_flat.py:158"),
        ("pack_words (K4)", "K4", "h264t_pack_words",
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:261"),
    ]
    paths = {"scroll": scroll_launches, "splice": splice_launches,
             "entry": entry_launches, "session": session_launches,
             "dense": dense_launches, "large": large_launches}
    # ms: one call as a caller waits for it (the method of the first port's
    # rows); device_ms: device time per call of calls queued back to back;
    # host_ms: the host's issue time per call.  launches: the kernel's
    # launches summed over the paths it runs on (phase 4's scroll golden
    # run, 5, 6, 7 and 8's dense steps and large frames), each path
    # counted from 0.
    kernels = []
    for name, key, sym, rep in rows:
        by_path = {p: c[sym] for p, c in paths.items() if c[sym]}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": errs[key],
                        **timing[key], "bound_ms": bound_ms[key],
                        "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _session_phase(dev, cfg, cases, batch, _kernels, Timer):
    """Phase 7: the per-session composer and the batched hint step on the
    card; returns the launch counts of the phase and its streams."""
    from h264_scroll_encoder_tpu_torch.session import ComposerSession
    from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
        p_slice_header_symbols)
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    golden = json.loads(cases.SESSION_GOLDEN_PATH.read_text())
    pkg = cases.port_package()
    streams, frame_ms = {}, []

    def timed(call):
        t0 = time.perf_counter()
        call()
        frame_ms.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t_phase = time.perf_counter()
    s = ComposerSession(cfg, device=dev)
    cases.drive_session(s, pkg, timed=timed)
    streams["session"] = s.getvalue()
    with tempfile.TemporaryDirectory() as tmp:
        streams.update(cases.session_streams(
            pkg, tmp, [n for n in cases.SESSION_STREAMS if n != "session"],
            device=dev))
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    compose_s = time.perf_counter() - t_phase

    device_frames = 0
    for name, data in streams.items():
        if cases.stream_digest(data) != golden[name]:
            raise AssertionError(f"session stream {name}: digest differs from "
                                 "golden/session_720p.json")
        rep = verify_stream(data)
        if not rep.ok:
            raise AssertionError(f"session stream {name}: verify_stream "
                                 f"failed: {rep.errors[:3]}")
        device_frames += rep.frame_count - 2       # all but the two atlases
    device_frames -= cases.SESSION_SPLICED_FRAMES  # composed on the host
    if launches["h264t_emit_fused"] != device_frames:
        raise AssertionError(f"K1 launched {launches['h264t_emit_fused']} "
                             f"times for {device_frames} device P-frames")
    verify_s = time.perf_counter() - t_phase - compose_s

    # One sliced frame is one K1 launch; a flagged frame retries through K2.
    _kernels.reset_launch_counts()
    s.write_scroll_frame_sliced(60, cases.SESSION_ROWS_PER_SLICE)
    torch.cuda.synchronize()
    if _kernels.EMIT_FUSED.launches != 1:
        raise AssertionError(f"a sliced frame launched K1 "
                             f"{_kernels.EMIT_FUSED.launches} times")
    launches["h264t_emit_fused"] += 1
    honest = ComposerSession(cfg, device=dev)
    forced = ComposerSession(cfg, device=dev)
    fast = forced._scroll_fn

    def flagged(*args):
        nal, nal_len, bits, ovf = fast(*args)
        return nal, nal_len, bits, torch.ones_like(ovf)

    forced._scroll_fn = flagged
    honest.write_scroll_frame(100)
    _kernels.reset_launch_counts()
    forced.write_scroll_frame(100)
    torch.cuda.synchronize()
    retry = {k.symbol: k.launches for k in _kernels.KERNELS}
    if retry["h264t_emit_fused"] != 1 or retry["h264t_pack_place"] != 1:
        raise AssertionError(f"forced ebsp_exact frame launched {retry}")
    if forced.getvalue() != honest.getvalue():
        raise AssertionError("the ebsp_exact retry changed the frame's bytes")
    for k, n in retry.items():
        launches[k] += n

    ms = sorted(frame_ms)
    p50, p90 = statistics.median(ms), ms[int(0.9 * (len(ms) - 1))]
    # Launches and device time of one batch-1 frame (offsets that need no
    # waypoint), by torch.profiler: the device's busy share at batch 1.
    probe = ComposerSession(cfg, device=dev)
    try:
        per_frame = _profile_launches(
            lambda: probe.write_scroll_or_waypoint_frame(500), 5)
    except Exception as e:  # measurement only; outputs checked above
        per_frame = None
        _log(f"phase 7: torch.profiler failed: {e!r}")
    _log(f"phase 7: session streams {sorted(streams)}: digests equal "
         f"golden/session_720p.json and verify_stream passes each "
         f"({sum(map(len, streams.values()))} B); K1 launched once per each "
         f"of {device_frames} device P-frames and once for one sliced frame; "
         f"a forced ebsp_exact frame launched K1 and K2 once each, bytes "
         f"unchanged; compose {compose_s:.2f} s, verify {verify_s:.2f} s")
    _log(f"phase 7: batch-1 session latency, {len(ms)} 720p "
         f"write_scroll_or_waypoint_frame calls (host wall, bytes on the "
         f"host): p50 {p50:.4f} ms, p90 {p90:.4f} ms, min {ms[0]:.4f} ms, "
         f"max {ms[-1]:.4f} ms; card {_smi()}")
    if per_frame is not None:
        _log(f"phase 7: one batch-1 scroll frame under torch.profiler: "
             f"{per_frame[0]:.1f} cudaLaunch calls, device time "
             f"{per_frame[1]:.4f} ms")
    # Tensor ops (besides allocations and views) of one frame, and of its
    # P slice header's symbol stream alone.
    frame_num, _off, _wp_off, wp_lt, wp_valid, count = probe._frame_args(500)
    poc = frame_num * 2
    frame_ops = cases.compute_ops(
        lambda: probe.write_scroll_or_waypoint_frame(500))
    header_ops = cases.compute_ops(lambda: p_slice_header_symbols(
        cfg, frame_num, poc, False, -1, count, wp_lt, wp_valid))
    _log(f"phase 7: one batch-1 scroll frame runs {len(frame_ops)} tensor "
         f"ops, {len(header_ops)} of them in its slice header's symbols")

    # The batched hint step at B = 256 and egress.
    step = batch.make_batched_hint_step(cfg, compact_x=True, device=dev)
    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in cases.hint_step_inputs().items()}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = cases.run_hint_step(step, inputs)
    torch.cuda.synchronize()
    if _kernels.EMIT_FUSED.launches != 1:
        raise AssertionError("the hint step did not launch K1 once")
    launches["h264t_emit_fused"] += 1
    nal, nal_len, _bits, ovf = out
    if cases.hint_step_digest(nal.cpu().numpy(), nal_len.cpu().numpy(),
                              ovf.cpu().numpy()) != golden["hint_step"]:
        raise AssertionError("hint step: digest differs from the golden file")
    total = int(nal_len.sum())
    packed, tot, c_ovf = batch.compact_batch_nal(nal, nal_len, total)
    want = bytes.fromhex(golden["hint_step"]["sha256"])
    if (int(tot) != total or bool(c_ovf)
            or hashlib.sha256(packed.cpu().numpy().tobytes()).digest() != want):
        raise AssertionError("compact_batch_nal: packed bytes differ from the "
                             "sessions' valid bytes")
    if not bool(batch.compact_batch_nal(nal, nal_len, total - 1)[2]):
        raise AssertionError("compact_batch_nal: no overflow at total - 1")
    step_t, egress_t = Timer(), Timer()
    for _ in range(3):
        cases.run_hint_step(step, inputs)
    for _ in range(20):
        out = step_t(lambda: cases.run_hint_step(step, inputs))
        egress_t(lambda: batch.compact_batch_nal(out[0], out[1], total))
    (step_ms, step_wall), (eg_ms, eg_wall) = step_t.medians(), egress_t.medians()
    try:
        prof = {name: _profile_launches(fn, 5) for name, fn in (
            ("hint step", lambda: cases.run_hint_step(step, inputs)),
            ("compact_batch_nal",
             lambda: batch.compact_batch_nal(out[0], out[1], total)))}
    except Exception as e:  # measurement only; outputs checked above
        prof = {}
        _log(f"phase 7: torch.profiler failed: {e!r}")
    for name, got in prof.items():
        if got is not None:
            _log(f"phase 7: {name} B=256 under torch.profiler: {got[0]:.1f} "
                 f"cudaLaunch calls per call, device time {got[1]:.4f} ms")
    _log(f"phase 7: hint step (compact_x) B=256 720p: digest equals the golden "
         f"file; {step_ms:.4f} ms (CUDA-event median of 20), host wall "
         f"{step_wall:.4f} ms; NAL buffer {tuple(nal.shape)}, {total} valid B "
         f"(mean {total / nal.shape[0]:.1f} B)")
    _log(f"phase 7: compact_batch_nal B=256 (cap = total = {total} B): "
         f"{eg_ms:.4f} ms (CUDA-event median of 20), host wall {eg_wall:.4f} "
         f"ms; packed[:total] equals the sessions' bytes, overflow at total - 1")
    return launches, streams


def _dense_phase(dev, cfg, cases, batch, _kernels, Timer, avref, streams7,
                 dn_rows, bits_rows, rows_align):
    """Phase 8: the dense splice path and the large frames on the card, then
    the host checks of this slice (pixel oracle, avref, fallback frame,
    trans-resizer); returns the launch counts of the dense steps and of
    the large frames."""
    from h264_scroll_encoder_tpu_torch import pixel_oracle as po
    from h264_scroll_encoder_tpu_torch.models.splice import (
        FrameHints, MotionRegion, transcode_pad_stream)
    from h264_scroll_encoder_tpu_torch.ops import ebsp_flat
    from h264_scroll_encoder_tpu_torch.session import ComposerSession
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    golden = json.loads(cases.DENSE_GOLDEN_PATH.read_text())
    wires = {c: cases.prepare_dense_donors(c, engine="native", device=dev)
             for c in cases.DENSE_CONFIGS}

    def check(config, out, B):
        nal, nal_len, _bits, ovf = out
        got = cases.digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                np.zeros(B, bool), ovf.cpu().numpy())
        if got != [golden[config][b % cases.DENSE_DONORS] for b in range(B)]:
            raise AssertionError(f"dense {config} B={B}: digests differ from "
                                 "golden/splice_dense_720p.json")

    # The dense steps, counted from 0: K1 once per step, then one forced
    # ebsp_exact retry (K2 once), as a session retries a flagged frame.
    runs = {}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    n_steps = 0
    for config, sizes in (("representative", (256, 1024)), ("ipcm", (256,))):
        dn, bits, align = wires[config]
        step = cases.dense_step(cfg, config, bits, align)
        for B in sizes:
            args = cases.splice_session_inputs(cfg, B, dev) + (
                cases.tile_donors(dn, B),)
            check(config, step(*args), B)
            timer = Timer()
            for _ in range(10):
                out = timer(lambda: step(*args))
            n_steps += 11
            check(config, out, B)
            runs[(config, B)] = (step, args, out, timer.medians())
    dn, bits, align = wires["representative"]
    step, args, _out, _ = runs[("representative", 256)]
    flagged = step(*args)
    if bool(flagged[3].any()):
        raise AssertionError("the dense step flagged a representative frame")
    retry = cases.dense_step(cfg, "representative", bits, align,
                             ebsp_exact=True)(*args)
    check("representative", retry, 256)
    torch.cuda.synchronize()
    dense_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    if (dense_launches["h264t_emit_fused"] != n_steps + 1
            or dense_launches["h264t_pack_place"] != 1):
        raise AssertionError(f"dense path launches {dense_launches} for "
                             f"{n_steps + 1} steps and one retry")

    # Configuration (i) against the rows step on the same donors.
    rows_step = cases.splice_steps(cfg, int(bits_rows.max()),
                                   rows_align)["compact"]
    for B in (256, 1024):
        _step, args, (nal, nal_len, _b, _o), _ = runs[("representative", B)]
        blob = dn_rows["blob"][torch.arange(B, device=dev) % N_DONORS]
        r_nal, r_len, _rb, r_ovf = rows_step(*args[:-1], {"blob": blob})
        if bool(r_ovf.any()) or not torch.equal(r_len, nal_len):
            raise AssertionError(f"rows and dense lengths differ at B={B}")
        width = torch.arange(nal.shape[1], device=dev)[None, :] < nal_len[:, None]
        n_r = min(r_nal.shape[1], nal.shape[1])
        if not torch.equal(torch.where(width[:, :n_r], r_nal[:, :n_r], 0),
                           torch.where(width[:, :n_r], nal[:, :n_r], 0)):
            raise AssertionError(f"rows and dense bytes differ at B={B}")
    for (config, B), (step, args, out, (ms, wall)) in runs.items():
        try:
            prof = _profile_launches(lambda: step(*args), 5)
        except Exception as e:  # measurement only; outputs checked above
            prof = None
            _log(f"phase 8: torch.profiler failed: {e!r}")
        prof_s = ("launches not measured (no device time)" if prof is None
                  else f"{prof[0]:.1f} cudaLaunch calls and {prof[1]:.4f} ms "
                       f"of device time per step (torch.profiler, 5 steps)")
        _log(f"phase 8: dense {config} B={B}: {ms:.4f} ms (CUDA-event median "
             f"of 10), host wall {wall:.4f} ms = {B / wall * 1e3:.1f} frames/s; "
             f"NAL buffer {tuple(out[0].shape)}, mean nal_len "
             f"{float(out[1].float().mean()):.1f} B; {prof_s}")
    _log(f"phase 8: dense steps: every session equals "
         f"golden/splice_dense_720p.json, the representative ones the rows "
         f"step's bytes; a forced ebsp_exact retry equals too; launches "
         f"{dense_launches}")

    # The two large hint frames through ComposerSession at B = 1, counted
    # from 0.
    golden_l = json.loads(cases.LARGE_GOLDEN_PATH.read_text())
    pkg = cases.port_package()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    large = {n: cases.large_frame_stream(pkg, n, device=dev)
             for n in cases.LARGE_FRAMES}
    torch.cuda.synchronize()
    compose_s = time.perf_counter() - t0
    large_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    if large_launches["h264t_emit_fused"] != len(large):
        raise AssertionError(f"large frames launched {large_launches}")
    for name, data in large.items():
        if cases.stream_digest(data) != golden_l[name]:
            raise AssertionError(f"{name}: digest differs from "
                                 "golden/large_frames.json")
        rep = verify_stream(data)
        if not rep.ok:
            raise AssertionError(f"{name}: verify_stream failed: {rep.errors[:3]}")
    _log(f"phase 8: large hint frames {sorted(large)} ({compose_s:.2f} s with "
         f"their atlases): digests equal golden/large_frames.json, "
         f"verify_stream passes; launches {large_launches}")

    # K3 past a block's shared memory (comparisons, not a path).
    for n_nal in cases.EBSP_LARGE_N_NALS:
        if not _kernels.ebsp_nal_in_global(n_nal):
            raise AssertionError(f"K3 at n_nal={n_nal} kept shared memory")
        rbsp, lens = cases.ebsp_large_cases(n_nal)
        for k3_cap in (cases.CAP, 1000):
            args = (torch.as_tensor(rbsp, device=dev),
                    torch.as_tensor(lens, device=dev), 0x61, n_nal, k3_cap)
            err = _max_abs_err(ebsp_flat.rbsp_to_nal_batch(*args),
                               ebsp_flat.rbsp_to_nal_plain(*args))
            if err:
                raise AssertionError(f"K3 at n_nal={n_nal}: kernel != plain")
    _log(f"phase 8: K3 equals its plain version at n_nal "
         f"{list(cases.EBSP_LARGE_N_NALS)} (rows read from global memory, the "
         f"NAL built in place), max_abs_err 0")

    # The pixel oracle: a 720p session at MB-aligned offsets is exact.
    t0 = time.perf_counter()
    s = ComposerSession(cfg, device=dev)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    offsets = (0, 16, 48, 96)
    for off in offsets:
        s.write_scroll_frame(off)
    oracle_stream = s.getvalue()
    pics = po.decode_stream_pixels(oracle_stream)
    canvas = po.scroll_canvas(pics[0], pics[1])
    for pic, off in zip(pics[2:], offsets):
        if (po.luma_mismatch_rows(pic, po.intended_scroll_luma(
                canvas, off, cfg.height)).size
                or not (pic.cb == canvas.cb[off // 2: off // 2 + cfg.height // 2]).all()
                or not (pic.cr == canvas.cr[off // 2: off // 2 + cfg.height // 2]).all()):
            raise AssertionError(f"pixel oracle: 720p frame at {off} not exact")
    _log(f"phase 8: pixel oracle: the 720p session at offsets {offsets} "
         f"decodes pixel-exact ({time.perf_counter() - t0:.2f} s)")

    # libavcodec, where the system has it (host code, not a device path).
    if avref.missing() is not None:
        _log(f"phase 8: avref unavailable ({avref.missing()}): the libavcodec "
             f"decode and the fallback frame were not run")
    else:
        t0 = time.perf_counter()
        decoded = {**streams7, **large, "oracle_720p": oracle_stream}
        for name, data in decoded.items():
            pics_av, nerrors = avref.decode_pictures(data)
            if nerrors or not pics_av:
                raise AssertionError(f"libavcodec: {name} decoded with "
                                     f"{nerrors} errors, {len(pics_av)} pictures")
        _log(f"phase 8: libavcodec decodes {sorted(decoded)} with 0 errors "
             f"({time.perf_counter() - t0:.2f} s)")
        _fallback_check(cfg, dev, avref, ComposerSession, FrameHints,
                        MotionRegion)

    # The trans-resizer on phase 7's composer stream: both engines equal.
    data = streams7["composer_cli"]
    t0 = time.perf_counter()
    widened = {e: transcode_pad_stream(data, cfg.width + 16, cfg.height,
                                       engine=e) for e in ("native", "python")}
    if widened["native"] != widened["python"] or not verify_stream(
            widened["native"]).ok:
        raise AssertionError("trans-resizer: the engines differ or the "
                             "stream fails verify_stream")
    _log(f"phase 8: trans-resizer on the composer stream ({len(data)} B -> "
         f"{len(widened['native'])} B at {cfg.width + 16}x{cfg.height}): both "
         f"engines equal, verify_stream passes "
         f"({time.perf_counter() - t0:.2f} s)")
    return dense_launches, large_launches


def _fallback_check(cfg, dev, avref, ComposerSession, FrameHints,
                    MotionRegion) -> None:
    """A 720p session on the card takes a fallback frame mid-stream: the
    stream decodes with 0 errors, the fallback frame shows a standalone
    x264 encode of the same pixels, and the session composes against it."""
    W, H = cfg.width, cfg.height
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[:H, :W]
    target = (((xx * 255) // W + rng.integers(0, 24, (H, W))).astype(np.uint8),
              (128 + (yy[::2, ::2] * 60) // H).astype(np.uint8),
              (128 - (xx[::2, ::2] * 60) // W).astype(np.uint8))
    s = ComposerSession(cfg, device=dev)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    full = (0, 0, W // 16, H // 16)
    took = [s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(*full, ref_idx=1),))),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(*full, ref_idx=5),)), fallback_frame=target),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=())),
            s.write_hint_frame_or_fallback(FrameHints(motion_regions=(
                MotionRegion(0, 0, W // 16, 2, ref_idx=0, mv_x=0, mv_y=16),)))]
    pics, nerrors = avref.decode_pictures(s.getvalue())
    ref, _ = avref.decode_pictures(avref.encode_x264(
        [target], qp=20, keyint=1, refs=1,
        extra_params="psy=0:chroma-qp-offset=0"))
    fb = pics[3] if len(pics) == 6 else None
    ok = (took == [False, True, False, False] and nerrors == 0 and fb is not None
          and all((getattr(fb, p) == getattr(ref[0], p)).all()
                  and (getattr(pics[4], p) == getattr(fb, p)).all()
                  for p in ("y", "cb", "cr"))
          and (pics[5].y[:32] == fb.y[16:48]).all()
          and (pics[5].y[32:] == fb.y[32:]).all())
    if not ok:
        raise AssertionError(f"fallback frame: took {took}, {nerrors} decode "
                             f"errors, {len(pics)} pictures, or pixels differ")
    _log("phase 8: a 720p session's fallback frame: 0 decode errors, the "
         "fallback shows the standalone x264 encode, the following frames "
         "compose against it")


if __name__ == "__main__":
    sys.exit(main())
