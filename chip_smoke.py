"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line).  Every step and session frame is compiled as the JAX
package jits it (utils/graphs): the first call of a key runs eagerly and
captures a CUDA graph, later calls replay it; a replay counts each kernel
it launches, so K1 still counts once per step or frame:

  1. Require CUDA; print the torch, CUDA, nvcc and card versions.
  2. Build, started together: the kernels (K1 h264t_emit_fused, K2
     h264t_pack_place, K3 h264t_ebsp_nal, K4 h264t_pack_words, K5
     h264t_composite_grid, K6 h264t_scroll_grid, K7
     h264t_p_slice_header, K8 h264t_compact_nal, and the probes P1-P6)
     from h264_scroll_encoder_tpu_torch/csrc/*.cu with one nvcc per
     source, then one link, the native CAVLC
     engine from csrc/cavlc_decode.cpp with g++, and avref from
     csrc/avref.c with gcc where the system has libavcodec (else a line
     says what is missing).
  3. Hold each kernel against its plain PyTorch version on CUDA tensors,
     exactly (tolerance: none — outputs are integers and bytes): the
     byte-stream, overflow, alignment, saturation, truncation and pack
     boundary cases of the tests (K3's at each of its NAL sizes, with int64
     lengths under each header byte, and rows read through a stride),
     K1 on the frames whose session passes a block's shared memory
     (3840x2160 at 32 and 64 bits per MB, 5120x3200, the 720p dense frame
     of I_PCM donors) and K2 on the exact retry at 4096x2160 and
     5120x3200, each on a thread-block cluster of the size the library's
     plan gives (asserted: 8, 8, 16, 4; 8, 16; the 720p shapes one block
     a session), real 1280x720 scroll
     and splice symbol batches at B = 256 (K1, K2, K4; K1 also at
     B = 1,024), K1, K2 and K4 on int32 and on int64 symbols, and the
     splice frames' RBSP bytes (K3); K3's bytes per thread, which the
     boundary cases follow, equal ops/ebsp_flat.items_per_thread.  Show
     that the wrappers run no tensor
     op (no conversion) around their kernel on the entry path's inputs:
     int32 symbols, the width the symbol stages make (K1, K2, K4), uint8
     bytes with int64 lengths and an int header (K3).  Time each kernel's
     device time per call (calls queued back to back), one call as a
     caller waits for it, the host's issue time per call, and the plain
     version (CUDA-event medians); K1 and K2 also on the same symbols
     widened to int64 (the comparison line), K1 and K3 also at B = 1 and
     1,024, K1 and K2 on every
     large shape (the dense I_PCM frame at B = 32 and 256) beside its
     bound and its earlier (one-block, global-memory) time, and K1 on the
     1920x1088 hint and 3840x2160 scroll frames that one block stages in
     several chunks.  The grid stage's kernels likewise: K5
     (ops/grid.composite_grid_batch) on cases.COMPOSITE_GRID_CASES and on
     the 720p rows (compact_x) inputs at B = 1, 256 and 1,024 and the
     dense splice inputs at B = 256, K6 (ops/grid.scroll_grid_batch) on
     cases.SCROLL_GRID_CASES, the 720p scroll and hint steps' fields at
     B = 256, a session's 720p scroll frame at B = 1 and the 1920x1088,
     3840x2160 and 5120x3200 hint frames, each on the band plan the
     library gives (`_kernels.grid_plan`: the row bands a session, a
     thread-block cluster where more than one), and on one small case
     each (GRID_FORCED_CASES) at every band plan forced; every output
     exactly equal to the plain version's; their wrappers run no tensor
     op on those inputs; each timed as K1 is, beside its bound and plan.
     K7 (syntax/slice_headers.p_slice_header_symbols) on every
     configuration of cases.HEADER_CONFIGS at B = 1, 256 and 1,024, on a
     session's sliced rows (first_mb a tensor) and on int64, int16/uint8
     and strided inputs: every slot equal to the plain version's, one
     launch and no tensor op a call; timed at B = 1, 256, 1,024 and the
     sliced rows.
  4. The scroll path — `parallel.batch.make_batched_step` at 1280x720 —
     over 16 frames of the benchmark's schedule at B = 256, then the
     golden batch-8 schedule and one `ebsp_exact` (K2) frame per session,
     whose digests must equal golden/scroll_720p.json (the JAX package's
     output).  Each step's rows go through egress as the benchmark's
     harness sends them (compact_batch_nal into the whole buffer, B * N:
     K8, equal to its plain version), one K8 launch a step.
  5. The rows splice path (the serving hot path): 32 seeded representative
     donors prepared by the native engine into the blob wire (host time per
     donor; the Python engine must give the same wire), tiled to B = 256
     and 1,024 sessions and spliced at bench.py's geometry (23x23 MBs at
     MB (30, 10)) by the compact and the static-chrome programs, plus one
     `ebsp_exact` frame per session; every session's digest must equal
     golden/splice_rows_720p.json, no frame may overflow, and K1 launches
     once per step; each step's rows go through egress as in phase 4, one
     K8 launch a step.  Step times: CUDA events and host wall; launches per
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
     at B = 256 against the golden digest, timed (CUDA events and host
     wall), and compact_batch_nal on its output (exact bytes, overflow at
     total - 1).  Then K8 (compact_batch_nal on CUDA tensors) against
     its plain version on every case of cases.COMPACT_CASES at each cap,
     exactly, one launch and no tensor op but its outputs' allocation a
     call (these launches count on no path); timed as phase 3 times its
     kernels on the benchmark's egress
     rows (the pooled splice rows, B = 1,024 at the 10,240 B RBSP budget,
     and the scroll step's, B = 256; the cap the whole buffer, B * N).
  8. The dense splice path and the large frames ("dense", "large"):
     make_batched_splice_step_dense at bench.py's geometry over the 32
     representative donors at the honest budget, tiled to B = 256 and
     1,024 (every session's digest equals golden/splice_dense_720p.json
     and its bytes the rows step's), and over the same donors with one
     I_PCM MB each at the default budget, B = 256 (NAL buffer 237,600 B:
     K1 on clusters of 4 blocks), and one forced
     `ebsp_exact` retry (K1 then K2, bytes unchanged); step times (CUDA
     events, host wall) and launches per step (torch.profiler).  Then
     3840x2160 at 64 bits per MB and 5120x3200 hint frames through
     ComposerSession (golden/large_frames.json, verify_stream), K3 on
     rows at NAL sizes past a block's shared memory against its plain
     version, the pixel oracle on a 720p session at MB-aligned offsets,
     libavcodec (avref, where the system has it) on phase 7's and this
     phase's streams and on a 720p session with a fallback frame, and the
     trans-resizer on phase 7's composer stream (both engines equal).
  9. Serving ("serving"): make_sharded_step at 1280x720, B = 256, over
     phase 4's 16 frames with the sessions split over every card (two
     blocks on cuda:0 on a one-card machine): every session's bytes,
     lengths and flags equal the unsharded step's, egress across the
     blocks (compact_sharded_nal) equals compact_batch_nal on the whole
     batch, and K1 launches once per block per step.  Then the splice
     serving loop at bench.py's geometry (B = 256, fresh donors from the
     32 representative donors through the native engine each step),
     evicted with save_serving_state after 3 of 6 steps and restored with
     load_serving_state: every NAL equals the uninterrupted run's; a
     ComposerSession through save_session / restore_session continues
     byte for byte; parallel.dryrun.dryrun_multigpu on the card; the
     serving, splice-serving and full-pipeline examples, generate_refs,
     run_e2e.sh at 1280x720 with 60 frames, and the MP4 mux of phase 7's
     scroll-encoder stream (box structure, one sample per frame); the
     video-in-corner demo and netflix_scroll --demo where avref builds.
     Times: the sharded and unsharded steps (host wall, device time per
     block by torch.profiler), save and load of the B = 256 serving state
     (and its npz bytes), the mux.
 10. The measurement probes ("probes"): P1 (h264t_emit_stage: K1 cut
     after each of its stages), P2 (h264t_pack_place_u16: K2 with 8-bit
     staged widths and 16-bit positions) and P3 (h264t_pack_place_tiled:
     K2 with T sessions a block), from csrc/probe_kernels.cu, held against
     their plain versions exactly on the JAX probes' inputs (8,483
     symbols, widths 0-8), the 720p compact splice symbols and a session
     past 65,536 bits (P2), at every stage and every T; P2 must refuse
     2,049 words and P3 a batch its T does not divide, launching nothing.
     Then every measurement script of h264_scroll_encoder_tpu_torch
     .scripts (emit_stage_probe, emit_wrap_probe, pack_u16_probe,
     pack_tiled_probe, splice_stage_profile, symbols_stage_probe,
     step_xprof, step_cost, ebsp_stage_probe, ebsp_sizing_probe,
     gpu_parity_probe) runs through its main at a small depth, each
     table printed on a line of its own; every probe kernel must launch
     in that run.  P1 at each stage, P2 and P3 at each T are timed as in
     phase 3 at the 720p splice shapes, B = 256.  Beside them the probes
     of XLA races: P4 (h264t_cavlc_lockstep, csrc/cavlc_lockstep.cu:
     lockstep CAVLC residual decode, one thread a donor lane) on the JAX
     probe's 256 lanes x 256 blocks (seed 5) and on hostile blocks,
     against its plain version and the host truth of ops/cavlc; P5/P6
     (h264t_ebsp_variant: K3 with its emulation-prevention stage or
     framing swapped, variants runs, ballot, shared, direct, lanes) against
     K3 and K3's plain version on the fused probe's exactness cases, the
     scripts' B = 256 payloads at their NAL sizes and hostile rows (all
     zeros, all 0x03, a row past the cap); the scripts cavlc_device_probe
     (with a 4,224-lane row), ebsp_cumsum_probe and ebsp_fused_probe; and
     their timings (P4 at the probe's shape, P5 at the cumsum probe's,
     P6 at the fused probe's serving-rep shape).
 11. The compiled steps ("graphs"): every graphed path at 720p (the
     scroll step, the rows compact, static-chrome and ebsp_exact programs,
     the dense and hint steps at B = 256 and the compact and static ones
     at 1,024, the session's scroll and waypoint frames and their
     ebsp_exact retries, its sliced and hint frames) captured afresh and
     driven over 8 calls with changing inputs: each call equals its
     `.eager` byte for byte (NAL, lengths, bits, flags, next state), its
     outputs survive the next call, one capture per key, and each replay
     is one graph launch running K1 (K2 on the exact paths).  Per path,
     graphed against eager in one run: CUDA API launches, device kernels
     and device time per call (torch.profiler, the medians of 3 windows;
     each window records the kernel 1 to 5 times in its 5 replays, the
     median window 5), host wall and CUDA-event
     time (in turns), busy share, capture ms and pool bytes.  The sharded
     step's blocks against its .eager; the golden digests on replays; the
     batch-1 session's p50 and p90, graphed and eager; a step with an
     .item() refused at capture on every call (no eager fallback).  The
     table is one JSON line, {"graphs": ...}.
 12. Print the kernel table (one JSON line; `ms` is one call on an idle
     card, as in the first port's rows, with `device_ms` and `host_ms`
     beside it; `launches` sums the paths, `launches_by_path` splits
     them), the card's name and power limit, and the result line.

Launch counters are set to 0 just before each path (4, 5, 6, 7, 8, 9, 10,
11) and read just after; every kernel must have launched on its path:
K5 on the splice, dense, serving, probes and graphs paths, K6 on the
scroll, session, large, serving, probes and graphs paths.
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
# Phase 11's torch.profiler windows a graphed path (5 calls each).
PROFILE_WINDOWS = 3
# K1's and K2's shapes past a block's shared memory (cases.large_emit_inputs,
# large_pack_inputs): the blocks a session the library's plan must give on
# an H100, and the rows phase 3 times.
LARGE_CLUSTERS = {"hint_3840x2160": 8, "hint_3840x2160_64": 8,
                  "hint_5120x3200": 16, "dense_ipcm_720p": 4,
                  "exact_4096x2160": 8, "exact_5120x3200": 16}
LARGE_K1_ROWS = {"K1 hint 3840x2160 B=1 (cluster 8)": "hint_3840x2160",
                 "K1 hint 3840x2160 64 bits/MB B=1 (cluster 8)": "hint_3840x2160_64",
                 "K1 hint 5120x3200 B=1 (cluster 16)": "hint_5120x3200",
                 "K1 dense I_PCM 720p B=32 (cluster 4)": "dense_ipcm_720p"}
LARGE_K2_ROWS = {"K2 exact 4096x2160 B=1 (cluster 8)": "exact_4096x2160",
                 "K2 exact 5120x3200 B=1 (cluster 16)": "exact_5120x3200"}
# The small grid cases phase 3 also runs at every band plan forced.
GRID_FORCED_CASES = {"K5": "sparse_rows", "K6": "still_band"}
# K1 on the shapes one block holds in several staged chunks
# (cases.multichunk_emit_inputs), timed beside them.
MULTICHUNK_K1_ROWS = {"K1 hint 1920x1088 B=1 (one block, 3 chunks)": "hint_1920x1088",
                      "K1 scroll 3840x2160 B=1 (one block, 8 chunks)": "scroll_3840x2160"}
# Device ms per call of the same shapes on the one-block plans that kept
# the words (and the NAL) in global memory, where PERF.md has them (NVIDIA
# H100 80GB HBM3, 700 W): logged beside this run's times for comparison.
EARLIER_DEVICE_MS = {"K1 dense I_PCM 720p B=32 (cluster 4)": 0.0854,
                     "K1 hint 5120x3200 B=1 (cluster 16)": 0.1604}


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _one_call_ms(fn) -> float:
    """CUDA-event time of one fn() in ms, with no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
    """utils/timing.profile_launches: (CUDA API launches per step, device ms
    per step) under torch.profiler, or None without device time."""
    from h264_scroll_encoder_tpu_torch.utils import timing

    return timing.profile_launches(fn, steps)


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
                                                   ebsp_flat, emit_fused, grid)
    from h264_scroll_encoder_tpu_torch.parallel import batch
    from h264_scroll_encoder_tpu_torch.syntax import slice_headers
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

    errs = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}

    def hold(name, case, got, want):
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} {case}: kernel != plain (max err {err})")
        errs[name] = max(errs[name], err)
        return got

    def check_k1(case, pat, nb, idc, n_rbsp, cap, **kw):
        """K1 on int64 and on int32 symbols (the symbol stages' width);
        returns the int32 result."""
        for int32 in (False, True):
            args = (cu(pat, int32), cu(nb, int32), idc, n_rbsp, cap)
            got = hold("K1", f"{case} int{32 if int32 else 64}",
                       emit_fused.emit_nal_fused_batch(*args, **kw),
                       emit_fused.emit_nal_fused_plain(*args, **kw))
        return got

    def check_pack(name, case, pat, nb, num_words):
        entry = (bitpack_flat.pack_words_place_batch if name == "K2"
                 else bitpack_flat.pack_words_batch)
        for int32 in (False, True):
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
    rbsp_len = (total // 8).to(torch.int64)  # K3's int64 length contract
    k3_n_nal = emit_fused.nal_bytes(s_n_rbsp, cap)
    check_k3("splice 720p B=256", rbsp_720, rbsp_len, 0x01, k3_n_nal, cap)
    strided = torch.zeros((B, s_n_rbsp + 9), dtype=torch.uint8, device=dev)
    strided[:, 3:-6] = rbsp_720
    check_k3("splice 720p B=256 strided rows", strided[:, 3:-6], rbsp_len,
             0x01, k3_n_nal, cap)

    # Sessions that pass a block's shared memory run on a thread-block
    # cluster: K1 on the 3840x2160 hint frames at 32 and 64 bits per MB,
    # the 5120x3200 one and the 720p dense frame of I_PCM donors at its
    # default budget; K2 on the exact retry at 4096x2160 and 5120x3200.
    # The 720p shapes keep one block a session.
    large_k1 = cases.large_emit_inputs(dev)
    large_k2 = cases.large_pack_inputs(dev)
    multichunk = cases.multichunk_emit_inputs(dev)
    for name, (pat_l, nb_l, rbsp_l, kw_l) in multichunk.items():
        n_l = pat_l.shape[1]
        if _kernels.emit_plan(pat_l.element_size(), n_l,
                              emit_fused.items_per_thread(n_l),
                              emit_fused.nal_bytes(rbsp_l, cap)) != 1:
            raise AssertionError(f"K1 at {name} left one block a session")
        check_k1(f"multichunk {name}", pat_l, nb_l, 0, rbsp_l, cap,
                 append_tb=True, **kw_l)
    for name, (pat_l, nb_l, rbsp_l, kw_l) in large_k1.items():
        n_l = pat_l.shape[1]
        c = _kernels.emit_plan(pat_l.element_size(), n_l,
                               emit_fused.items_per_thread(n_l),
                               emit_fused.nal_bytes(rbsp_l, cap))
        if c != LARGE_CLUSTERS[name]:
            raise AssertionError(f"K1 at {name}: {c} blocks a session, not "
                                 f"{LARGE_CLUSTERS[name]}")
        got = check_k1(f"large {name}", pat_l, nb_l, 0, rbsp_l, cap,
                       append_tb=True, **kw_l)
        if bool(got[3].any()):
            raise AssertionError(f"K1 flagged the large frame {name}")
    for name, (pat_l, nb_l, words_l) in large_k2.items():
        n_l = pat_l.shape[1]
        c = _kernels.pack_plan(pat_l.element_size(), n_l,
                               emit_fused.items_per_thread(n_l),
                               words_l)
        if c != LARGE_CLUSTERS[name]:
            raise AssertionError(f"K2 at {name}: {c} blocks a session, not "
                                 f"{LARGE_CLUSTERS[name]}")
        check_pack("K2", f"large {name}", pat_l, nb_l, words_l)
    for n_c in (0, 9219, 64_798, 129_640, 256_040, 600_000):
        for c in emit_fused.CLUSTER_SIZES:
            if _kernels.cluster_items(n_c, c) != \
                    emit_fused.cluster_items_per_thread(n_c, c):
                raise AssertionError(f"cluster items at n={n_c}, C={c}")
    for shape in ((sym_pat.element_size(), sym_pat.shape[1], n_rbsp),
                  (s_pat.element_size(), s_pat.shape[1], s_n_rbsp),
                  (part_pat.element_size(), part_pat.shape[1], part_rbsp)):
        sym_bytes, n_sym, budget = shape
        c = _kernels.emit_plan(sym_bytes, n_sym, emit_fused.items_per_thread(n_sym),
                               emit_fused.nal_bytes(budget, cap))
        if c != 1:
            raise AssertionError(f"a 720p K1 shape {shape} took {c} blocks")
    if _kernels.ebsp_nal_in_global(k3_n_nal):
        raise AssertionError("K3 at the 720p NAL size left shared memory")

    # The wrappers run no conversion (or any other tensor op but
    # allocations and views) around their kernel on the main path's int32
    # symbols (the JAX package's widths), and K3's on uint8 bytes, int64
    # lengths and an int header.  The symbol stages hand over int32.
    for name, x in (("scroll", sym_pat), ("scroll nbits", sym_nb),
                    ("partitioned", part_pat), ("splice", s_pat),
                    ("splice nbits", s_nb), ("scroll nal_ref_idc", idc)):
        if x.dtype != torch.int32:
            raise AssertionError(f"the {name} symbol stage made {x.dtype}")
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
         f"header byte and on strided rows; K1 on {sorted(large_k1)} and K2 "
         f"on {sorted(large_k2)} on clusters of "
         f"{[LARGE_CLUSTERS[k] for k in (*large_k1, *large_k2)]} blocks, the "
         f"720p shapes on one block a session "
         f"(scroll 720p: n={sym_pat.shape[1]} symbols, n_rbsp={n_rbsp} B; "
         f"splice 720p: n={s_pat.shape[1]} symbols, n_rbsp={s_n_rbsp} B, NAL "
         f"buffer {k3_n_nal} B, mean RBSP {float(rbsp_len.float().mean()):.1f} "
         f"B); the symbol stages hand over int32; no wrapper runs a tensor op "
         f"on the entry path's inputs")

    # K5 and K6, the grid stage: on their cases, then on the main paths'
    # inputs (the 720p rows and dense splice steps at B = 256 and 1,024,
    # the 720p scroll and hint steps at B = 256, the large hint frames at
    # B = 1), every output equal to the plain version's on the same CUDA
    # inputs.
    def check_grid(name, case, args, kw, parts=None):
        fn, plain = ((grid.composite_grid_batch, grid.composite_grid_plain)
                     if name == "K5" else
                     (grid.scroll_grid_batch, grid.scroll_grid_plain))
        got, want = fn(*args, parts=parts, **kw), plain(*args, **kw)
        if [g is None for g in got] != [w is None for w in want]:
            raise AssertionError(f"{name} {case}: outputs differ in kind")
        hold(name, case, [g for g in got if g is not None],
             [w for w in want if w is not None])
        return got

    for name in [c[0] for c in cases.COMPOSITE_GRID_CASES]:
        rect, compact_x, nr_arg, _nr, bg, dn_c = cases.composite_grid_case(name)
        check_grid("K5", name, (*rect, *cases.grid_args((nr_arg, *bg, dn_c),
                                                         dev)),
                   {"compact_x": compact_x})
    for name in [c[0] for c in cases.SCROLL_GRID_CASES]:
        pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
        check_grid("K6", name, cases.grid_args((*fields, nr_arg), dev),
                   {"enable_pskip": pskip, "compact_x": compact_x})
    # Every band plan forced on one small case each (a band with no coded
    # MB between bands with some: the carry across the cluster).
    rect, compact_x, nr_arg, _nr, bg, dn_c = cases.composite_grid_case(
        GRID_FORCED_CASES["K5"])
    for p in grid.allowed_parts(*bg[0].shape[1:]):
        check_grid("K5", f"{GRID_FORCED_CASES['K5']} P={p}",
                   (*rect, *cases.grid_args((nr_arg, *bg, dn_c), dev)),
                   {"compact_x": compact_x}, parts=p)
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(
        GRID_FORCED_CASES["K6"])
    for p in grid.allowed_parts(*fields[0].shape[1:]):
        check_grid("K6", f"{GRID_FORCED_CASES['K6']} P={p}",
                   cases.grid_args((*fields, nr_arg), dev),
                   {"enable_pskip": pskip, "compact_x": compact_x}, parts=p)
    dense_dn, _dbits, _dalign = cases.prepare_dense_donors(
        "representative", engine="native", device=dev)
    k6_in = cases.scroll_grid_inputs(dev)
    # {timed label: (kernel, args, kwargs)}; the first of each kernel is
    # its kernels-line row, the others its "shapes".
    grid_runs = {
        "K5": ("K5", *cases.composite_grid_inputs(cfg, dn32, B, dev,
                                                  rows=True)),
        "K5 B=1024": ("K5", *cases.composite_grid_inputs(cfg, dn32, 1024, dev,
                                                         rows=True)),
        "K5 B=1": ("K5", *cases.composite_grid_inputs(cfg, dn32, 1, dev,
                                                      rows=True)),
        "K5 dense": ("K5", *cases.composite_grid_inputs(cfg, dense_dn, B, dev,
                                                        rows=False)),
        "K6": ("K6", *k6_in["scroll_720p"]),
        "K6 hint": ("K6", *k6_in["hint_720p"]),
        "K6 session B=1": ("K6", *k6_in["session_720p"]),
        **{f"K6 hint {k[5:]} B=1 (bands)": ("K6", *v)
           for k, v in k6_in.items() if not k.endswith("720p")},
    }
    # Each shape's band plan: the blocks a session (a cluster where > 1).
    grid_parts = {}
    for label, (kern, args, kw) in grid_runs.items():
        g = args[5] if kern == "K5" else args[0]
        grid_parts[label] = _kernels.grid_plan(
            g.shape[1] * g.shape[2], g.shape[2], g.shape[0],
            grid.GRID_COMPOSITE if kern == "K5" else grid.GRID_SCROLL)
    grid_out = {label: check_grid(kern, label, args, kw)
                for label, (kern, args, kw) in grid_runs.items()}
    for label, (kern, args, kw) in grid_runs.items():
        fn = (grid.composite_grid_batch if kern == "K5"
              else grid.scroll_grid_batch)
        ops = cases.compute_ops(lambda: fn(*args, **kw))
        if ops:
            raise AssertionError(f"{kern}'s wrapper ran tensor ops {ops} on "
                                 f"the {label} inputs")
    _log(f"phase 3: K5 equals its plain version on "
         f"{len(cases.COMPOSITE_GRID_CASES)} cases (rects at every edge, "
         f"compact_x, the wide layout, int8/int16/int32 roles) and K6 on "
         f"{len(cases.SCROLL_GRID_CASES)} (P_Skip, compact_x, wide), both on "
         f"{GRID_FORCED_CASES} at every band plan forced and on "
         f"{sorted(grid_runs)}, every output exactly; their wrappers run no "
         f"tensor op on those inputs; band plans (blocks a session): "
         f"{grid_parts}")

    # K7, the P slice header: the sweep's configurations at B = 1, 256 and
    # 1,024 and on a session's sliced rows (first_mb a tensor), the scroll
    # step's input forms, each equal to the plain version on the same CUDA
    # inputs, one launch a call and no tensor op around it.
    def header_run(k, case, variant="int32"):
        cfg_k, qp = cases.header_config(k)
        t = cases.header_tensors(case, dev, variant)
        return ((lambda: slice_headers.p_slice_header_symbols(
                     cfg_k, slice_qp_delta=qp, **t)),
                (lambda: slice_headers.p_slice_header_symbols_plain(
                    cfg_k, slice_qp_delta=qp, **t)), t)

    header_runs = {
        "K7": header_run(0, cases.header_case(B, 7)),
        "K7 B=1": header_run(0, cases.header_case(1, 7)),
        "K7 B=1024": header_run(0, cases.header_case(1024, 7)),
        "K7 sliced rows B=1 (5 slices)": header_run(0, cases.header_case(5, 7)),
    }
    for k in range(len(cases.HEADER_CONFIGS)):
        for b_h in (1, B, 1024):
            header_runs.setdefault(f"K7 config {k} B={b_h}", header_run(
                k, cases.header_case(b_h, 100 + k)))
    for variant in ("int64", "narrow", "strided"):
        header_runs[f"K7 {variant}"] = header_run(
            3, cases.header_case(B, 9), variant)
    header_out = {}
    for label, (kern, plain, _t) in header_runs.items():
        before = _kernels.P_SLICE_HEADER.launches
        header_out[label] = hold("K7", label, kern(), plain())
        if _kernels.P_SLICE_HEADER.launches != before + 1:
            raise AssertionError(f"K7 {label}: not one launch")
        ops = cases.compute_ops(kern)
        if ops:
            raise AssertionError(f"K7's wrapper ran tensor ops {ops} on the "
                                 f"{label} inputs")
    _log(f"phase 3: K7 equals its plain version on {len(header_runs)} "
         f"header batches ({len(cases.HEADER_CONFIGS)} configurations at B = "
         f"1, {B} and 1,024, sliced rows, int64, int16/uint8 and strided "
         f"inputs), every slot exactly, one launch and no tensor op a call")

    # Timing at the 720p B = 256 splice shapes (K1 and K3 also at B = 1
    # and 1,024, K1 at the scroll shapes): the kernel's device time on the
    # main path's inputs (int32 symbols; calls queued back to back) and, as
    # the comparison line, K1's and K2's on the same symbols widened to
    # int64, one call as a caller waits for it (host issue + device: the
    # method of the first port's rows) and the plain version's call, in
    # turns: plain, kernel, kernel, plain.  All through the wrappers.
    e64 = (exact_pat.to(torch.int64), exact_nb.to(torch.int64))

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
        "K1 int64": k1_run(tuple(x.to(torch.int64) for x in k1_sym[B]), s_idc,
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
        "K2 int64": (lambda: bitpack_flat.pack_words_place_batch(
                         *e64, exact_words),
                     lambda: bitpack_flat.pack_words_place_plain(
                         *e64, exact_words)),
        **{label: k1_run(large_k1[key][:2], 0, large_k1[key][2],
                         append_tb=True, **large_k1[key][3])
           for label, key in LARGE_K1_ROWS.items()},
        "K1 dense I_PCM 720p B=256 (cluster 4)": k1_run(
            tuple(x[torch.arange(B, device=dev) % x.shape[0]]
                  for x in large_k1["dense_ipcm_720p"][:2]), 0,
            large_k1["dense_ipcm_720p"][2], append_tb=True,
            **large_k1["dense_ipcm_720p"][3]),
        **{label: (lambda a=large_k2[key]: bitpack_flat.pack_words_place_batch(*a),
                   lambda a=large_k2[key]: bitpack_flat.pack_words_place_plain(*a))
           for label, key in LARGE_K2_ROWS.items()},
        **{label: k1_run(multichunk[key][:2], 0, multichunk[key][2],
                         append_tb=True)
           for label, key in MULTICHUNK_K1_ROWS.items()},
        "K3 n_nal=259328 B=4 (global)": k3_large_run(259_328),
        "K3": k3_run(B),
        "K3 B=1": k3_run(1),
        "K3 B=1024": k3_run(1024),
        "K4": (lambda: bitpack_flat.pack_words_batch(exact_pat, exact_nb,
                                                     exact_words),
               lambda: bitpack_flat.pack_words_place_plain(
                   exact_pat, exact_nb, exact_words)),
        **{label: ((lambda a=args, k=kw: grid.composite_grid_batch(*a, **k),
                    lambda a=args, k=kw: grid.composite_grid_plain(*a, **k))
                   if kern == "K5" else
                   (lambda a=args, k=kw: grid.scroll_grid_batch(*a, **k),
                    lambda a=args, k=kw: grid.scroll_grid_plain(*a, **k)))
           for label, (kern, args, kw) in grid_runs.items()},
        **{label: header_runs[label][:2]
           for label in ("K7", "K7 B=1", "K7 B=1024",
                         "K7 sliced rows B=1 (5 slices)")},
    }
    timing = {}
    for name, (kernel, plain) in runs.items():
        where = ("" if any(w in name for w in ("cluster", "global", "block",
                                                 "bands"))
                 else " at 720p")
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
    # and K4: the main path's int32 symbols (8 bytes a symbol), NAL plus
    # 16 bytes of per-session results, or the 32-bit words and total; the
    # bytes of the same work on int64 symbols are logged beside it.  K3's is
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
    # The cluster plan's timed shapes, by the same formulas.
    for name, key in (*LARGE_K1_ROWS.items(),
                      ("K1 dense I_PCM 720p B=256 (cluster 4)", "dense_ipcm_720p")):
        pat_g, _nb, rbsp_g, _kw = large_k1[key]
        b_g = B if "B=256" in name else pat_g.shape[0]
        bound[name] = (b_g * pat_g.shape[1] * 8 + b_g * 4
                       + b_g * (emit_fused.nal_bytes(rbsp_g, cap) + 16))
    for name, key in LARGE_K2_ROWS.items():
        pat_g, _nb, words_g = large_k2[key]
        bound[name] = pat_g.shape[1] * 8 + (words_g + 1) * 4
    for name, key in MULTICHUNK_K1_ROWS.items():
        pat_g, _nb, rbsp_g, _kw = multichunk[key]
        bound[name] = (pat_g.shape[1] * 8 + 4
                       + emit_fused.nal_bytes(rbsp_g, cap) + 16)
    _log("phase 3: K1 and K2 on clusters, device ms per call against the "
         "earlier one-block plans' (words, and NAL, in global memory; "
         "PERF.md's NVIDIA H100 80GB HBM3 700 W run, where timed) and the "
         "bound: " + "; ".join(
             f"{name}: {timing[name]['device_ms']:.5f} (earlier "
             f"{EARLIER_DEVICE_MS.get(name, 'not timed')}, bound "
             f"{bound[name] / HBM_BYTES_PER_MS:.5f})"
             for name in (*LARGE_K1_ROWS, "K1 dense I_PCM 720p B=256 (cluster 4)",
                          *LARGE_K2_ROWS, *MULTICHUNK_K1_ROWS)))
    g_rows, g_lens = cases.ebsp_large_cases(259_328)
    g_staged = np.clip(g_lens, 0, min(g_rows.shape[1],
                                      ebsp_flat.padded_len(259_328)))
    bound["K3 n_nal=259328 B=4 (global)"] = (int(g_staged.sum()) + 8 * len(g_lens)
                                            + len(g_lens) * (259_328 + 4))
    # K5 and K6: each input they need at this run's data read once (a
    # tensor passed twice counted once; K5's MVs and refs only around its
    # live MBs, none on the all-skip background) and each output written
    # once (ops/grid's byte counts); their integer work (a few dozen
    # operations an MB) takes far less at the card's rates.
    for label, (kern, args, kw) in grid_runs.items():
        bound[label] = (grid.composite_grid_bytes(*args, grid_out[label])
                        if kern == "K5" else
                        grid.scroll_grid_bytes(*args, grid_out[label]))
    # K7: each input tensor read once, both [B, 39] int32 outputs written
    # once; its work (a few integer operations a slot) is far less.
    for label in ("K7", "K7 B=1", "K7 B=1024", "K7 sliced rows B=1 (5 slices)"):
        _k, _p, t = header_runs[label]
        bound[label] = (sum(x.numel() * x.element_size() for x in t.values())
                        + sum(o.numel() * o.element_size()
                              for o in header_out[label]))
    compare_bytes = {"K1 int64": B * n_s * 16 + B * (n_nal_s + 16),
                     "K2 int64": B * n_e * 16 + B * (exact_words + 1) * 4,
                     "K3 earlier formula": (B * s_n_rbsp + 2 * 4 * B
                                            + B * (k3_n_nal + 4))}
    bound_ms = {k: v / HBM_BYTES_PER_MS for k, v in bound.items()}
    _log("phase 3: memory bounds at 3.35 TB/s: " + ", ".join(
        f"{k} {v} B = {bound_ms[k]:.5f} ms" for k, v in bound.items()))
    _log("phase 3: for comparison, K1 and K2 on the main path's symbols "
         "widened to int64, and K3's earlier formula: " + ", ".join(
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
        _egress(batch, nal, nal_len, "scroll")
    scroll_rows = (nal, nal_len)
    k1_steps = _kernels.EMIT_FUSED.launches
    if k1_steps != len(schedule):
        raise AssertionError(f"K1 launched {k1_steps} times in "
                             f"{len(schedule)} steps")
    if _kernels.SCROLL_GRID.launches != len(schedule):
        raise AssertionError(f"K6 launched {_kernels.SCROLL_GRID.launches} "
                             f"times in {len(schedule)} steps")
    if _kernels.P_SLICE_HEADER.launches != len(schedule):
        raise AssertionError(f"K7 launched {_kernels.P_SLICE_HEADER.launches} "
                             f"times in {len(schedule)} steps")
    if _kernels.COMPACT_NAL.launches != len(schedule):
        raise AssertionError(f"K8 launched {_kernels.COMPACT_NAL.launches} "
                             f"times in {len(schedule)} steps' egress")
    golden = json.loads(cases.GOLDEN_PATH.read_text())
    if cases.port_golden(dev) != golden:
        raise AssertionError("CUDA output differs from the scroll golden digests")
    torch.cuda.synchronize()
    scroll_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    for k in (_kernels.EMIT_FUSED, _kernels.PACK_PLACE, _kernels.SCROLL_GRID,
              _kernels.P_SLICE_HEADER, _kernels.COMPACT_NAL):
        if scroll_launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on the scroll path")
    step_ms, wall_ms = timer.medians()
    _log(f"phase 4: scroll, {len(schedule)} steps at B={B}: no overflow, "
         f"{waypoints} waypoint frames, egress K8 equal to its plain version "
         f"each step; golden digests match; launches {scroll_launches}")
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
        _egress(batch, nal, nal_len, f"splice {name} B={B}")
        idx = [b for b in range(B) if b % N_DONORS < cases.SPLICE_GOLDEN_BATCH]
        got = cases.digest_step(nal[idx].cpu().numpy(), nal_len[idx].cpu().numpy(),
                                np.zeros(len(idx), bool), ovf[idx].cpu().numpy())
        want = [splice_golden[name][b % N_DONORS] for b in idx]
        if got != want:
            raise AssertionError(f"splice {name} B={B}: digests differ from "
                                 "the golden file")

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    n_run = n_compact = n_egress = 0
    for B_s in (256, 1024):
        args = cases.splice_session_inputs(cfg, B_s, dev) + (tile(B_s),)
        for name in ("compact", "static"):
            for _ in range(n_warm):
                check_digests(name, steps[name](*args), B_s)
            timer = Timer()
            for _ in range(n_steps):
                out = timer(lambda: steps[name](*args))
                _egress(batch, out[0], out[1], f"splice {name} B={B_s}")
            n_run += n_warm + n_steps
            n_compact += (n_warm + n_steps) * (name == "compact")
            check_digests(name, out, B_s)
            n_egress += n_warm + n_steps + 1
            step_ms, wall_ms = timer.medians()
            _log(f"phase 5: splice {name} B={B_s}: {step_ms:.4f} ms "
                 f"(CUDA-event median of {n_steps}), host wall {wall_ms:.4f} ms "
                 f"(median) = {B_s / wall_ms * 1e3:.1f} frames/s; NAL buffer "
                 f"{tuple(out[0].shape)}, mean nal_len "
                 f"{float(out[1].float().mean()):.1f} B")
        if B_s == 256:
            check_digests("ebsp_exact", steps["ebsp_exact"](*args), B_s)
            n_egress += 1
    torch.cuda.synchronize()
    splice_launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    if splice_launches["h264t_emit_fused"] != n_run:
        raise AssertionError(f"K1 launched {splice_launches['h264t_emit_fused']} "
                             f"times in {n_run} splice steps")
    # K5 runs in the compact program and its ebsp_exact retry; the
    # static-chrome program has no grid stage.
    if splice_launches["h264t_composite_grid"] != n_compact + 1:
        raise AssertionError(f"K5 launched "
                             f"{splice_launches['h264t_composite_grid']} times "
                             f"in {n_compact + 1} compact steps")
    if splice_launches["h264t_compact_nal"] != n_egress:
        raise AssertionError(f"K8 launched {splice_launches['h264t_compact_nal']} "
                             f"times in {n_egress} splice steps' egress")
    for k in (_kernels.EMIT_FUSED, _kernels.PACK_PLACE):
        if splice_launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched on the splice path")
    if cases.port_splice_golden(dev) != splice_golden:
        raise AssertionError("CUDA output differs from the splice golden digests")
    _log(f"phase 5: {n_run} splice steps + 1 ebsp_exact frame: no overflow, "
         f"digests match the golden file, egress K8 equal to its plain version "
         f"each step; launches {splice_launches}")
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
                     f"{prof[0]:.1f} CUDA API launches per step, device time "
                     f"{prof[1]:.4f} ms per step")

    # -- 6. K3 and K4 through their own entry points ----------------------------
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    words, total = bitpack_flat.pack_words_batch(exact_pat, exact_nb, exact_words)
    rbsp = bitpack.words_to_bytes(words)[:, :s_n_rbsp].to(torch.uint8)
    nal3, count3 = ebsp_flat.rbsp_to_nal_batch(rbsp, (total // 8).to(torch.int64),
                                               0x01, k3_n_nal,
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
    egress_rows = {"K8": cases.pooled_egress_rows(cfg, dn32, has_align, dev),
                   "K8 scroll B=256": scroll_rows}
    session_launches, streams7, k8 = _session_phase(
        dev, cfg, cases, batch, _kernels, Timer, timing_, egress_rows)
    timing.update(k8["timing"])
    bound_ms.update(k8["bound_ms"])
    errs["K8"] = 0

    # -- 8. The dense splice path and the large frames ---------------------------
    dense_launches, large_launches = _dense_phase(
        dev, cfg, cases, batch, _kernels, Timer, avref, streams7, dn32, bits32,
        has_align)

    # -- 9. Serving: sharded step, eviction, dry run, examples, scripts ---------
    t_serving = time.perf_counter()
    serving_launches = _serving_phase(dev, cfg, cases, batch, _kernels, Timer,
                                      avref, streams7, schedule, payloads)
    _log(f"phase 9: {time.perf_counter() - t_serving:.2f} s in all")

    # -- 10. The measurement probes ------------------------------------------
    t_probes = time.perf_counter()
    probe_launches, probe_rows = _probes_phase(
        dev, cfg, cases, _kernels, timing_,
        splice=(s_pat, s_nb, s_idc, s_n_rbsp, splice_kw),
        exact=(exact_pat, exact_nb, exact_words))
    _log(f"phase 10: {time.perf_counter() - t_probes:.2f} s in all")

    # -- 11. The compiled steps (CUDA graphs) ------------------------------------
    t_graphs = time.perf_counter()
    graph_launches = _graphs_phase(dev, cfg, cases, batch, _kernels, timing_,
                                   Timer, schedule, dn32, bits32, has_align)
    _log(f"phase 11: {time.perf_counter() - t_graphs:.2f} s in all")

    # -- 12. Results -----------------------------------------------------------
    emit_src = "h264_scroll_encoder_tpu_torch/csrc/emit_kernels.cu"
    grid_src = "h264_scroll_encoder_tpu_torch/csrc/grid_kernels.cu"
    # K5 and K6 replace XLA code of the JAX package (no Pallas kernel).
    rows = [
        ("emit_fused (K1)", "K1", "h264t_emit_fused",
         "h264_scroll_encoder_tpu/ops/emit_fused.py:214", emit_src),
        ("pack_place (K2)", "K2", "h264t_pack_place",
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:435", emit_src),
        ("ebsp_nal (K3)", "K3", "h264t_ebsp_nal",
         "h264_scroll_encoder_tpu/ops/ebsp_flat.py:158", emit_src),
        ("pack_words (K4)", "K4", "h264t_pack_words",
         "h264_scroll_encoder_tpu/ops/bitpack_flat.py:261", emit_src),
        ("composite_grid (K5)", "K5", "h264t_composite_grid",
         "h264_scroll_encoder_tpu/models/splice_device.py:1321", grid_src),
        ("scroll_grid (K6)", "K6", "h264t_scroll_grid",
         "h264_scroll_encoder_tpu/models/scroll.py:328", grid_src),
        ("p_slice_header (K7)", "K7", "h264t_p_slice_header",
         "h264_scroll_encoder_tpu/syntax/slice_headers.py:28",
         "h264_scroll_encoder_tpu_torch/csrc/header_kernels.cu"),
        ("compact_nal (K8)", "K8", "h264t_compact_nal",
         "h264_scroll_encoder_tpu/parallel/batch.py:298",
         "h264_scroll_encoder_tpu_torch/csrc/egress_kernels.cu"),
    ]
    # The paths each grid kernel serves; it must have launched on each.
    grid_paths = {"K5": ("splice", "dense", "serving", "probes", "graphs"),
                  "K6": ("scroll", "session", "large", "serving", "probes",
                         "graphs"),
                  "K7": ("scroll", "session", "graphs"),
                  "K8": ("scroll", "splice", "serving")}
    paths = {"scroll": scroll_launches, "splice": splice_launches,
             "entry": entry_launches, "session": session_launches,
             "dense": dense_launches, "large": large_launches,
             "serving": serving_launches, "probes": probe_launches,
             "graphs": graph_launches}
    # ms: one call as a caller waits for it (the method of the first port's
    # rows); device_ms: device time per call of calls queued back to back;
    # host_ms: the host's issue time per call.  launches: the kernel's
    # launches summed over the paths it runs on (phase 4's scroll golden
    # run, 5, 6, 7, 8's dense steps and large frames, 9's sharded steps
    # and serving loop, 10's measurement scripts and 11's graphed paths),
    # each path counted from 0; a graph replay counts each kernel it
    # launches.  The probes (P1-P6) run on phase 10's path only.
    # large: K1's and K2's rows on the cluster plan, and K1's on the shapes
    # one block stages in several chunks (phase 3), each with its blocks a
    # session and its bound.
    large_rows = {"K1": {**LARGE_K1_ROWS,
                         "K1 dense I_PCM 720p B=256 (cluster 4)": "dense_ipcm_720p",
                         **MULTICHUNK_K1_ROWS},
                  "K2": LARGE_K2_ROWS}
    kernels = []
    for name, key, sym, rep, src in rows:
        by_path = {p: c[sym] for p, c in paths.items() if c[sym]}
        missing = [p for p in grid_paths.get(key, ()) if p not in by_path]
        if missing:
            raise AssertionError(f"{name} never launched on {missing}")
        large = {label: {"cluster": LARGE_CLUSTERS.get(shape, 1), **timing[label],
                         "bound_ms": bound_ms[label]}
                 for label, shape in large_rows.get(key, {}).items()}
        # K5's and K6's other timed shapes (phase 3's grid_runs), each with
        # its band plan.
        shapes = {label: {**timing[label], "bound_ms": bound_ms[label],
                          "parts": grid_parts[label]}
                  for label, (kern, _a, _k) in grid_runs.items()
                  if kern == key and label != key}
        shapes.update({label: {**timing[label], "bound_ms": bound_ms[label]}
                       for label in k8["timing"]
                       if label.startswith(key + " ") and label != key})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": errs[key],
                        **timing[key], "bound_ms": bound_ms[key],
                        "bound_by": "bytes", "library_ms": None,
                        **({"parts": grid_parts[key]} if key in grid_parts
                           else {}),
                        **({"large": large} if large else {}),
                        **({"shapes": shapes} if shapes else {})})
    for row in probe_rows:
        by_path = {"probes": probe_launches[row.pop("counter")]}
        kernels.append({**row, "launches": by_path["probes"],
                        "launches_by_path": by_path})
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _egress(batch, nal, nal_len, what):
    """A step's rows through egress as the benchmark's harness sends them
    (drive._Egress): compact_batch_nal into the whole buffer, B * N, held
    to the plain version."""
    cap = nal.numel()
    got = batch.compact_batch_nal(nal, nal_len, cap)
    if _max_abs_err(got, batch.compact_batch_nal_plain(nal, nal_len, cap)):
        raise AssertionError(f"{what}: egress (K8) != its plain version")
    return got


def _k8_phase(dev, cases, batch, _kernels, timing_, egress_rows):
    """Phase 7's K8: held to its plain version on the sweep, then timed
    on the benchmark's egress rows; returns {"timing", "bound_ms"} by
    label.  Its launches are counted here and on no path."""
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    calls = 0
    for name in cases.COMPACT_CASES:
        case = cases.compact_case(name)
        nal, lens = cases.compact_tensors(case, dev)
        for cap in case["caps"]:
            got = batch.compact_batch_nal(nal, lens, cap)
            want = batch.compact_batch_nal_plain(nal, lens, cap)
            torch.cuda.synchronize()
            if _max_abs_err(got, want):
                raise AssertionError(f"K8 {name} cap {cap}: kernel != plain")
            calls += 1
        ops = cases.compute_ops(lambda: batch.compact_batch_nal(
            nal, lens, case["caps"][0]))
        calls += 1
        if ops:
            raise AssertionError(f"K8's wrapper ran tensor ops {ops} on {name}")
    torch.cuda.synchronize()
    if _kernels.COMPACT_NAL.launches != calls:
        raise AssertionError(f"K8 launched {_kernels.COMPACT_NAL.launches} "
                             f"times in {calls} calls")
    _log(f"phase 7: K8 equals its plain version on {len(cases.COMPACT_CASES)} "
         f"compaction cases at every cap, exactly, one launch and no tensor "
         f"op but the outputs' allocation a call")
    # Timing as phase 3's: the kernel's device time (calls queued back to
    # back), one call, the host's issue time, and the plain version on the
    # card, in turns.  Bound: the valid bytes and the lengths read once,
    # the cap, total and overflow written once at 3.35 TB/s.
    timing, bound_ms = {}, {}
    for label, (nal, nal_len) in egress_rows.items():
        cap = nal.numel()
        kernel = lambda nal=nal, nal_len=nal_len, cap=cap: (
            batch.compact_batch_nal(nal, nal_len, cap))
        plain = lambda nal=nal, nal_len=nal_len, cap=cap: (
            batch.compact_batch_nal_plain(nal, nal_len, cap))
        if _max_abs_err(kernel(), plain()):
            raise AssertionError(f"{label}: kernel != plain")
        p_a = timing_.call_ms(plain, 10)
        d_a = timing_.device_ms(kernel)
        c = timing_.call_ms(kernel, 20)
        h = timing_.host_ms(kernel)
        d_b = timing_.device_ms(kernel)
        p_b = timing_.call_ms(plain, 10)
        valid = int(nal_len.sum())
        timing[label] = {"ms": c, "device_ms": statistics.median([d_a, d_b]),
                         "host_ms": h,
                         "plain_ms": statistics.median([p_a, p_b])}
        bound_ms[label] = (valid + nal_len.numel() * nal_len.element_size()
                           + cap + 5) / HBM_BYTES_PER_MS
        _log(f"phase 7: {label} ({tuple(nal.shape)} rows, {valid} valid B, "
             f"cap {cap} B): device {d_a:.5f}/{d_b:.5f} ms per call, one call "
             f"{c:.5f} ms, host issue {h:.5f} ms per call, plain "
             f"{p_a:.4f}/{p_b:.4f} ms (CUDA-event medians); bound "
             f"{bound_ms[label]:.5f} ms")
    return {"timing": timing, "bound_ms": bound_ms}


def _session_phase(dev, cfg, cases, batch, _kernels, Timer, timing_,
                   egress_rows):
    """Phase 7: the per-session composer, the batched hint step and
    egress (K8) on the card; returns the launch counts of the phase, its
    streams and K8's timings."""
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
    if launches["h264t_scroll_grid"] == 0:
        raise AssertionError("K6 never launched on the session path")
    verify_s = time.perf_counter() - t_phase - compose_s

    # One sliced frame is one K1 launch; a flagged frame retries through K2.
    _kernels.reset_launch_counts()
    s.write_scroll_frame_sliced(60, cases.SESSION_ROWS_PER_SLICE)
    torch.cuda.synchronize()
    if _kernels.EMIT_FUSED.launches != 1 or _kernels.SCROLL_GRID.launches != 1:
        raise AssertionError(f"a sliced frame launched K1 "
                             f"{_kernels.EMIT_FUSED.launches} and K6 "
                             f"{_kernels.SCROLL_GRID.launches} times")
    for k in _kernels.KERNELS:
        launches[k.symbol] += k.launches
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
             f"{per_frame[0]:.1f} CUDA API launches, device time "
             f"{per_frame[1]:.4f} ms")
    # Tensor ops (besides allocations and views) of one frame run op by op
    # (the frame graph's .eager), and of its P slice header's symbol
    # stream alone.
    frame_num, _off, _wp_off, wp_lt, wp_valid, count = probe._frame_args(500)
    poc = frame_num * 2
    frame_ops = cases.compute_ops(
        lambda: probe._scroll_fn.eager(probe._frame_row(500)))
    header_ops = cases.compute_ops(lambda: p_slice_header_symbols(
        cfg, frame_num, poc, False, -1, count, wp_lt, wp_valid))
    if header_ops:
        raise AssertionError(f"the slice header's symbols ran tensor ops "
                             f"{header_ops} besides K7")
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
    if _kernels.EMIT_FUSED.launches != 1 or _kernels.SCROLL_GRID.launches != 1:
        raise AssertionError("the hint step did not launch K1 and K6 once")
    for k in _kernels.KERNELS:
        launches[k.symbol] += k.launches
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
    step_t = Timer()
    for _ in range(3):
        cases.run_hint_step(step, inputs)
    for _ in range(20):
        step_t(lambda: cases.run_hint_step(step, inputs))
    step_ms, step_wall = step_t.medians()
    try:
        prof = _profile_launches(lambda: cases.run_hint_step(step, inputs), 5)
    except Exception as e:  # measurement only; outputs checked above
        prof = None
        _log(f"phase 7: torch.profiler failed: {e!r}")
    if prof is not None:
        _log(f"phase 7: hint step B=256 under torch.profiler: {prof[0]:.1f} "
             f"CUDA API launches per call, device time {prof[1]:.4f} ms")
    _log(f"phase 7: hint step (compact_x) B=256 720p: digest equals the golden "
         f"file; {step_ms:.4f} ms (CUDA-event median of 20), host wall "
         f"{step_wall:.4f} ms; NAL buffer {tuple(nal.shape)}, {total} valid B "
         f"(mean {total / nal.shape[0]:.1f} B); compact_batch_nal's "
         f"packed[:total] equals the sessions' bytes, overflow at total - 1")
    k8 = _k8_phase(dev, cases, batch, _kernels, timing_, egress_rows)
    return launches, streams, k8


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
            or dense_launches["h264t_pack_place"] != 1
            or dense_launches["h264t_composite_grid"] != n_steps + 2):
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
                  else f"{prof[0]:.1f} CUDA API launches and {prof[1]:.4f} ms "
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
    if (large_launches["h264t_emit_fused"] != len(large)
            or large_launches["h264t_scroll_grid"] != len(large)):
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



def _block_devices(dev):
    """Phase 9's device list: every card, or two blocks on the one card."""
    count = torch.cuda.device_count()
    if count > 1:
        return [torch.device("cuda", i) for i in range(count)], f"{count} cards"
    return [dev, dev], "two blocks on cuda:0 (one card)"


def _serving_phase(dev, cfg, cases, batch, _kernels, Timer, avref, streams7,
                   schedule, payloads):
    """Phase 9: the sharded scroll step, eviction and restore mid-stream on
    the splice serving loop, the multi-device dry run, and the examples
    and scripts on the card; returns the launch counts of the sharded
    steps and the serving loop."""
    from h264_scroll_encoder_tpu_torch.models import scroll
    from h264_scroll_encoder_tpu_torch.parallel import dryrun
    from h264_scroll_encoder_tpu_torch.session import ComposerSession
    from h264_scroll_encoder_tpu_torch.syntax import parse
    from h264_scroll_encoder_tpu_torch.utils import snapshot
    from h264_scroll_encoder_tpu_torch.utils.trace import StageTimer

    devices, layout = _block_devices(dev)
    n_blocks = len(devices)
    B = schedule.shape[1]
    step_u = batch.make_batched_step(cfg)
    step_s = batch.make_sharded_step(cfg, devices)

    # (a) The sharded scroll step over phase 4's schedule, counted from 0.
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    states = batch.shard_batch(batch.SessionState.create(B, device=dev),
                               devices)
    sharded = []
    for offs in schedule:
        states, outs = step_s(states, batch.shard_batch(offs, devices))
        sharded.append(outs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    k1 = _kernels.EMIT_FUSED.launches
    if k1 != n_blocks * len(schedule):
        raise AssertionError(f"K1 launched {k1} times for {n_blocks} blocks x "
                             f"{len(schedule)} sharded steps")
    # A forced ebsp_exact frame on one shard: K2, then exact EBSP, with the
    # bounded frame's bytes.
    st0 = states[0]
    offs0 = batch.shard_batch(schedule[-1], devices)[0]
    with batch.on_device(devices[0]):
        frame_args = (cfg, st0.frame_num, offs0, st0.wp_offsets, st0.wp_ltidx,
                      st0.wp_valid, st0.wp_count)
        exact = scroll.scroll_frame(*frame_args, ebsp_exact=True)
        bounded = scroll.scroll_frame(*frame_args)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    if launches["h264t_pack_place"] != 1:
        raise AssertionError(f"the shard's ebsp_exact frame launched {launches}")
    n = min(exact[0].shape[1], bounded[0].shape[1])
    if not (torch.equal(exact[1], bounded[1]) and not bool(bounded[3].any())
            and torch.equal(dryrun.valid_bytes(*exact[:2])[:, :n],
                            dryrun.valid_bytes(*bounded[:2])[:, :n])):
        raise AssertionError("the shard's ebsp_exact frame changed its bytes")

    state_u = batch.SessionState.create(B, device=dev)
    for t, offs in enumerate(schedule):
        state_u, out_u = step_u(state_u, offs)
        out_s = batch.gather_batch(sharded[t], dev)
        if bool(out_u[4].any()):
            raise AssertionError(f"unsharded step {t} overflowed")
        if not (all(torch.equal(a, b) for a, b in zip(out_u[1:], out_s[1:]))
                and torch.equal(dryrun.valid_bytes(*out_u[:2]),
                                dryrun.valid_bytes(*out_s[:2]))):
            raise AssertionError(f"sharded step {t} differs from unsharded")
        cap = B * out_u[0].shape[1]
        want = batch.compact_batch_nal(out_u[0], out_u[1], cap)
        got = batch.compact_sharded_nal([o[0] for o in sharded[t]],
                                        [o[1] for o in sharded[t]], cap, dev)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"egress across the blocks differs at step {t}")
    # Egress is K8 on the card: one launch a call, both calls a step.
    launches["h264t_compact_nal"] = _kernels.COMPACT_NAL.launches
    if launches["h264t_compact_nal"] != 2 * len(schedule):
        raise AssertionError(f"K8 launched {launches['h264t_compact_nal']} "
                             f"times in {2 * len(schedule)} egress calls")
    final = batch.gather_batch(states, dev)
    if not all(torch.equal(getattr(final, f), getattr(state_u, f))
               for f in ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid",
                         "wp_count")):
        raise AssertionError("sharded and unsharded final states differ")
    _log(f"phase 9: sharded scroll step over {layout}, {len(schedule)} steps "
         f"at B={B} 720p: every session's bytes, lengths and flags equal the "
         f"unsharded step's, egress across the blocks equals "
         f"compact_batch_nal; K1 launched {k1} times = once per block per "
         f"step; a forced ebsp_exact frame on one shard launched K2 once, "
         f"bytes unchanged")

    # Times: host wall (CUDA events and host clock to a synchronise) and
    # device time per block (torch.profiler), sharded against unsharded, on
    # the same inputs, in turns.
    offs_blocks = batch.shard_batch(schedule[0], devices)
    blocks0 = batch.shard_batch(batch.SessionState.create(B, device=dev),
                                devices)
    state0 = batch.SessionState.create(B, device=dev)
    runs = {"unsharded": lambda: step_u(state0, schedule[0]),
            "sharded": lambda: step_s(blocks0, offs_blocks)}
    timers = {name: Timer() for name in runs}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        for _ in range(3):
            runs[name]()
        for _ in range(10):
            timers[name](runs[name])
    for name, fn in runs.items():
        try:
            prof = _profile_launches(fn, 5)
        except Exception as e:  # measurement only; outputs checked above
            prof = None
            _log(f"phase 9: torch.profiler failed: {e!r}")
        ms, wall = timers[name].medians()
        per = 1 if name == "unsharded" else n_blocks
        prof_s = ("device time not measured" if prof is None else
                  f"{prof[0]:.1f} CUDA API launches and {prof[1]:.4f} ms of "
                  f"device time per step, {prof[1] / per:.4f} ms per block "
                  f"of {B // per} sessions (torch.profiler, 5 steps)")
        _log(f"phase 9: {name} scroll step B={B} 720p: {ms:.4f} ms "
             f"(CUDA-event median of 20), host wall {wall:.4f} ms (median); "
             f"{prof_s}")

    # (b) The splice serving loop at bench.py's geometry, B = 256: fresh
    # donors each step from the 32 representative donors through the
    # native engine (blob wire); evicted after 3 of 6 steps and restored.
    T, EVICT = 6, 3
    ctx0 = {"step": 0, "rotation": 5}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    uninterrupted = _serving_run(cfg, cases, batch, payloads, dev, B,
                                 _serving_state(batch, B, dev), ctx0, 0, T)[1]
    state, first = _serving_run(cfg, cases, batch, payloads, dev, B,
                                _serving_state(batch, B, dev), ctx0, 0, EVICT)
    timer = StageTimer()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/serving.npz"
        ctx = dict(ctx0, step=EVICT)
        for _ in range(20):
            with timer.stage("save"):
                snapshot.save_serving_state(path, state, ctx)
            with timer.stage("load"):
                restored = snapshot.load_serving_state(path, device=dev)
                torch.cuda.synchronize()
        npz_bytes = len(open(path, "rb").read())
        del state, restored
        state2, ctx2 = snapshot.load_serving_state(path, device=dev)
    if ctx2 != ctx:
        raise AssertionError("the restored host context differs")
    rest = _serving_run(cfg, cases, batch, payloads, dev, B, state2, ctx2,
                        ctx2["step"], T)[1]
    for t, (got, want) in enumerate(zip(first + rest, uninterrupted)):
        if not (torch.equal(got[1], want[1])
                and torch.equal(dryrun.valid_bytes(*got),
                                dryrun.valid_bytes(*want))):
            raise AssertionError(f"serving step {t}: NALs after eviction "
                                 "differ from the uninterrupted run's")
    torch.cuda.synchronize()
    loop = {k.symbol: k.launches for k in _kernels.KERNELS}
    if (loop["h264t_emit_fused"] != 2 * T
            or loop["h264t_composite_grid"] != 2 * T):
        raise AssertionError(f"serving loop launches {loop} in {2 * T} steps")
    for k, n in loop.items():
        launches[k] += n
    if launches["h264t_scroll_grid"] == 0:
        raise AssertionError("K6 never launched in the sharded scroll steps")
    _log(f"phase 9: splice serving loop B={B} (23x23 MBs at MB (30, 10), fresh "
         f"donors each step), evicted after {EVICT} of {T} steps with "
         f"save_serving_state and restored with load_serving_state: every "
         f"NAL equals the uninterrupted run's; save "
         f"{timer.stages['save'].mean_ms} ms, load (to the card) "
         f"{timer.stages['load'].mean_ms} ms (means of 20), npz {npz_bytes} B")

    # A ComposerSession through save_session / restore_session.
    a = ComposerSession(cfg, device=dev)
    a.write_parameter_sets()
    a.write_test_atlases(striped=True)
    for off in (0, 496, 496, 600):
        a.write_scroll_or_waypoint_frame(off)
    with tempfile.TemporaryDirectory() as tmp:
        snapshot.save_session(a, f"{tmp}/session.json")
        b = ComposerSession(cfg, device=dev)
        snapshot.restore_session(b, f"{tmp}/session.json")
    for off in (700, 992, 992, 40):
        for s in (a, b):
            s.write_scroll_or_waypoint_frame(off)
        if (list(parse.iter_nal_units(a.getvalue()))[-1].data
                != list(parse.iter_nal_units(b.getvalue()))[-1].data):
            raise AssertionError(f"restored session differs at offset {off}")
    _log("phase 9: a 720p ComposerSession restored by restore_session "
         "continues byte for byte (4 frames, 2 waypoints)")

    # (c) The multi-device dry run on the card.
    t0 = time.perf_counter()
    report = dryrun.dryrun_multigpu(devices)
    _log(f"phase 9: dryrun_multigpu over {layout}: sharded == unsharded on "
         f"{report} ({time.perf_counter() - t0:.2f} s)")

    # (d) The examples and scripts on the card.
    _examples_and_scripts(dev, cfg, avref, streams7)
    return launches


def _serving_state(batch, B, dev):
    """Sessions at distinct frame_nums (no waypoints: two references, the
    rows step's num_refs)."""
    state = batch.SessionState.create(B, device=dev)
    state.frame_num += torch.arange(B, device=dev, dtype=torch.int32) % 5
    return state


def _serving_run(cfg, cases, batch, payloads, dev, B, state, ctx, t0, t1):
    """Steps t0..t1-1 of the splice serving loop: each step the 32 donors
    go through the native engine into the blob wire, session b carries
    donor (b + rotation * t) % 32.  Returns (state, [(nal, nal_len)])."""
    from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
        p_slice_header_symbols)

    zero = torch.zeros((B, cfg.mb_height, cfg.mb_width), dtype=torch.int32,
                       device=dev)
    out = []
    for t in range(t0, t1):
        dn, bits, align = cases.prepare_splice_donors(payloads, engine="native",
                                                      device=dev)
        step = cases.splice_steps(cfg, int(bits.max()),
                                  bool(align.any()))["compact"]
        pick = (torch.arange(B, device=dev) + ctx["rotation"] * t) % len(payloads)
        fn = state.frame_num % (1 << cfg.log2_max_frame_num)
        hp, hn = p_slice_header_symbols(
            cfg, fn, fn * 2, False, -1, state.wp_count, state.wp_ltidx,
            state.wp_valid)
        nal, nal_len, _bits, ovf = step(hp, hn, zero, zero, zero, zero.bool(),
                                        {"blob": dn["blob"][pick]})
        if bool(ovf.any()):
            raise AssertionError(f"serving step {t} overflowed")
        out.append((nal, nal_len))
        state = batch.SessionState(state.frame_num + 1, state.wp_offsets,
                                   state.wp_ltidx, state.wp_valid,
                                   state.wp_count)
    return state, out


def _examples_and_scripts(dev, cfg, avref, streams7) -> None:
    """Phase 9 (d): the port's examples and scripts on the card."""
    import os
    from pathlib import Path

    from h264_scroll_encoder_tpu_torch.examples import (full_pipeline_demo,
                                                        serving_demo,
                                                        splice_serving_demo)
    from h264_scroll_encoder_tpu_torch.scripts import generate_refs
    from h264_scroll_encoder_tpu_torch.utils import mp4mux
    from h264_scroll_encoder_tpu_torch.utils.trace import StageTimer
    from h264_scroll_encoder_tpu_torch.verify import verify_stream

    repo = Path(__file__).resolve().parent
    quiet = lambda *a, **k: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        streams = serving_demo.run(dev, out_dir=tmp / "serving", log=quiet)
        t1 = time.perf_counter()
        nals = splice_serving_demo.run(dev, log=quiet)
        nals_cpu = splice_serving_demo.run("cpu", log=quiet)
        if nals != nals_cpu:
            raise AssertionError("splice_serving_demo: card and CPU NALs differ")
        t2 = time.perf_counter()
        data, mp4 = full_pipeline_demo.run(tmp / "full.h264", dev, log=quiet)
        t3 = time.perf_counter()
        _log(f"phase 9: examples on the card: serving_demo ({len(streams)} "
             f"sessions x 40 frames at 720p, {sum(map(len, streams))} B, "
             f"verify_stream and the snapshot round trip pass; {t1 - t0:.2f} "
             f"s), splice_serving_demo (8 NALs equal the CPU run's, "
             f"verify_stream passes; {t2 - t1:.2f} s), full_pipeline_demo "
             f"({len(data)} B stream, verify_stream passes, {len(mp4)} B MP4; "
             f"{t3 - t2:.2f} s)")

        if generate_refs.main(["--out-dir", str(tmp / "refs"),
                               "--device", str(dev)]) != 0:
            raise AssertionError("generate_refs failed")
        for name in ("ref_a.h264", "ref_b.h264"):
            rep = verify_stream((tmp / "refs" / name).read_bytes())
            if not rep.ok or rep.frame_count != 1:
                raise AssertionError(f"generate_refs {name}: {rep.errors[:3]}")

        t0 = time.perf_counter()
        env = dict(os.environ, OUT=str(tmp / "e2e"), W=str(cfg.width),
                   H=str(cfg.height), FRAMES="60", DEVICE=str(dev),
                   PYTHON=sys.executable)
        r = subprocess.run(["bash", str(repo / "h264_scroll_encoder_tpu_torch"
                                        / "scripts" / "run_e2e.sh")],
                           env=env, capture_output=True, text=True)
        if r.returncode != 0 or r.stdout.count('"ok": true') != 2:
            raise AssertionError(f"run_e2e.sh failed ({r.returncode}):\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        e2e_mp4 = (tmp / "e2e" / "scroll.mp4").read_bytes()
        if e2e_mp4 != mp4mux.mux((tmp / "e2e" / "scroll.h264").read_bytes()):
            raise AssertionError("run_e2e.sh: the MP4 differs from its stream's")
        _log(f"phase 9: run_e2e.sh at {cfg.width}x{cfg.height}, 60 frames, on "
             f"the card: both streams verify, the MP4 muxes "
             f"({time.perf_counter() - t0:.2f} s)")

    # The MP4 mux of phase 7's scroll-encoder stream.
    stream = streams7["scroll_encoder_cli"]
    timer = StageTimer()
    for _ in range(5):
        with timer.stage("mux"):
            mp4 = mp4mux.mux(stream)
    boxes, pos = [], 0
    while pos < len(mp4):
        size, kind = int.from_bytes(mp4[pos:pos + 4], "big"), mp4[pos + 4:pos + 8]
        boxes.append(kind)
        pos += size
    frames = verify_stream(stream).frame_count
    _sps, _pps, samples, sync = mp4mux.annexb_to_samples(stream)
    if (boxes != [b"ftyp", b"moov", b"mdat"] or pos != len(mp4)
            or len(samples) != frames or sync != [1]):
        raise AssertionError(f"mp4mux: boxes {boxes}, {len(samples)} samples "
                             f"for {frames} frames, sync {sync}")
    _log(f"phase 9: mp4mux of the scroll-encoder stream ({len(stream)} B, "
         f"{frames} frames): {len(mp4)} B, ftyp/moov/mdat, one sample per "
         f"frame; {timer.stages['mux'].mean_ms} ms (mean of 5)")

    if avref.missing() is not None:
        _log(f"phase 9: avref unavailable ({avref.missing()}): "
             f"video_in_corner_demo and netflix_scroll --demo were not run")
        return
    from h264_scroll_encoder_tpu_torch.examples import video_in_corner_demo
    from h264_scroll_encoder_tpu_torch.scripts import netflix_scroll

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        video_in_corner_demo.main_batched(f"{tmp}/vic.h264", device=dev,
                                          log=quiet)
        if netflix_scroll.main(["--demo", "-n", "60", "--device", str(dev),
                                "-o", f"{tmp}/netflix.mp4",
                                "--extract-frames"]) != 0:
            raise AssertionError("netflix_scroll --demo failed")
    _log(f"phase 9: video_in_corner_demo --batched (1280x720, B = 4, equal to "
         f"the host path, 0 libavcodec errors) and netflix_scroll --demo (60 "
         f"frames, 0 errors) on the card ({time.perf_counter() - t0:.2f} s)")


# Phase 10's scripts and the arguments that keep the phase short: B = 256
# (the 4B shapes 1,024), two steps a chain, one chain; P4's extra row at
# 4,224 lanes, one block of 32 lanes on each of the H100's 132 SMs.
PROBE_SCRIPTS = (
    ("emit_stage_probe", []), ("emit_wrap_probe", []),
    ("pack_u16_probe", []), ("pack_tiled_probe", []),
    ("splice_stage_profile", []), ("splice_stage_profile", ["--static"]),
    ("symbols_stage_probe", []), ("step_xprof", []), ("step_cost", []),
    ("ebsp_stage_probe", []), ("ebsp_sizing_probe", []),
    ("gpu_parity_probe", []), ("cavlc_device_probe", ["--wide", "4224"]),
    ("ebsp_cumsum_probe", []), ("ebsp_fused_probe", []))
PROBE_DEPTH = ["--steps", "2", "--reps", "1"]


def _probes_phase(dev, cfg, cases, _kernels, timing_, *, splice, exact):
    """Phase 10: P1-P6 against their plain versions, the measurement
    scripts on the card (counted from 0), and the probes' timings; returns
    the scripts' launch counts and the probes' rows of the kernel table
    (each with its counter's name under "counter")."""
    import contextlib
    import importlib
    import io

    from h264_scroll_encoder_tpu_torch.ops import (bitpack_flat, cavlc_lockstep,
                                                   ebsp_flat, emit_fused, probes)
    from h264_scroll_encoder_tpu_torch.scripts import _probe_common as common
    from h264_scroll_encoder_tpu_torch.scripts import (cavlc_device_probe,
                                                       ebsp_cumsum_probe,
                                                       ebsp_fused_probe,
                                                       ebsp_stage_probe,
                                                       pack_tiled_probe,
                                                       pack_u16_probe)

    t0 = time.perf_counter()
    s_pat, s_nb, s_idc, s_n_rbsp, splice_kw = splice
    e_pat, e_nb, e_words = exact
    cap, B = cases.CAP, s_pat.shape[0]
    errs = {}

    def hold(name, case, got, want):
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} {case}: kernel != plain (max err {err})")
        errs[name] = max(errs.get(name, 0), err)

    # (a) Exactness: every stage, P2 and every T on the JAX probes' inputs
    # and the 720p compact splice symbols, on int64 and int32 symbols.
    p_pat, p_nb = common.probe_symbols(B, dev)
    rep = common.rep_budget("native")
    p1_inputs = {"JAX probe input": (p_pat, p_nb, 0, rep, {"append_tb": True}),
                 "splice 720p B=256": splice}
    for case, (pat, nb, idc, n_rbsp, kw) in p1_inputs.items():
        for int32 in (False, True):
            p, n = ((cases.int32_bits(pat), cases.int32_bits(nb)) if int32
                    else (pat.to(torch.int64), nb.to(torch.int64)))
            for stage in probes.EMIT_STAGES:
                args = (stage, p, n, idc, n_rbsp, cap)
                hold(f"P1 {stage}", f"{case} int{32 if int32 else 64}",
                     probes.emit_stage_batch(*args, **kw),
                     probes.emit_stage_plain(*args, **kw))
    pack_inputs = [("JAX probe input", p_pat, p_nb, 2048),
                   ("splice 720p exact B=256", e_pat, e_nb, e_words)]
    pack_inputs += [(f"pack_u16_probe case {i}", *(torch.as_tensor(a, device=dev)
                                                   for a in case), 2048)
                    for i, case in enumerate(pack_u16_probe.exact_cases())]
    tiled_case = tuple(torch.as_tensor(a, device=dev)
                       for a in pack_tiled_probe.exact_case())
    for case, pat, nb, nw in pack_inputs:
        want = bitpack_flat.pack_words_place_plain(pat, nb, nw)
        hold("P2", case, probes.pack_place_u16_batch(pat, nb, nw), want)
        if pat.shape[0] % 16 == 0:
            for tile in probes.TILES:
                hold(f"P3 T={tile}", case,
                     probes.pack_place_tiled_batch(pat, nb, nw, tile), want)
    for tile in probes.TILES:
        hold(f"P3 T={tile}", "pack_tiled_probe case",
             probes.pack_place_tiled_batch(*tiled_case, 2048, tile),
             bitpack_flat.pack_words_place_plain(*tiled_case, 2048))
    hostile = tuple(torch.as_tensor(a, device=dev)
                    for a in pack_u16_probe.hostile_case())
    if int(probes.pack_place_u16_batch(*hostile, 2048)[1][0]) <= 65_536:
        raise AssertionError("the hostile P2 case stayed under 65,536 bits")
    before = _kernels.launch_counts()
    for call, what in (
            (lambda: probes.pack_place_u16_batch(p_pat, p_nb, 2049),
             "P2 took 2,049 words"),
            (lambda: probes.pack_place_tiled_batch(p_pat[:12], p_nb[:12], 2048,
                                                   8),
             "P3 took B = 12 at T = 8")):
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(what)
    if _kernels.launch_counts() != before:
        raise AssertionError("a refused probe call launched a kernel")
    _log(f"phase 10: P1 at every stage, P2 and P3 at every T equal their "
         f"plain versions (max_abs_err {max(errs.values())}) on the JAX "
         f"probes' input (8,483 symbols, n_rbsp {rep}), the 720p compact "
         f"splice symbols (and P2's eight cases, one past 65,536 bits), on "
         f"int64 and int32; P2 refuses 2,049 words and P3 B % T != 0 before "
         f"launching ({time.perf_counter() - t0:.2f} s)")

    # (a2) P4 on the JAX probe's streams (256 lanes x 256 blocks, seed 5)
    # and the hostile blocks, against its plain version and the host truth;
    # every P5/P6 variant against K3's plain version and K3 at the scripts'
    # shapes, on the fused probe's exactness cases and on hostile rows.
    t_new = time.perf_counter()
    luts = cavlc_lockstep.device_luts(dev)
    c_np, c_truth, _c_bits = cavlc_lockstep.probe_streams()
    h_np, h_truth = cavlc_device_probe.hostile_streams()
    p4_inputs = {"JAX probe streams": (c_np, c_truth),
                 "hostile blocks": (h_np, h_truth)}
    p4_end, p4_plain_ms = {}, {}
    for case, (data_np, truth) in p4_inputs.items():
        data = torch.as_tensor(data_np, device=dev)
        k = truth.shape[1]
        got = cavlc_lockstep.decode_lockstep_batch(data, k, luts)
        # The plain decode is seconds of small ops on the card: this one
        # call is also its timing (plain_ms of the kernels line).
        want = []
        p4_plain_ms[case] = _one_call_ms(lambda: want.extend(
            cavlc_lockstep.decode_lockstep_plain(data, k, luts)))
        hold("P4", case, got, want)
        if not np.array_equal(got[1].cpu().numpy(), truth):
            raise AssertionError(f"P4 {case}: device decode != host truth")
        p4_end[case] = got[0]
    c_data = torch.as_tensor(c_np, device=dev)
    h_rows, h_lens = ebsp_cumsum_probe.hostile_rows()
    x_rows, x_lens = ebsp_fused_probe.exact_cases()
    serving = ebsp_stage_probe.payload(B, 5960, dev)
    ebsp_inputs = [
        ("fused probe exactness cases", torch.as_tensor(x_rows, device=dev),
         torch.as_tensor(x_lens, device=dev),
         ebsp_fused_probe.n_nal_of(ebsp_fused_probe.EXACT_BYTES)),
        ("cumsum probe serving-rep", *serving,
         ebsp_cumsum_probe.n_nal_of(5960)),
        ("fused probe serving-rep", *serving, ebsp_fused_probe.n_nal_of(5960)),
        ("fused probe profiler-rep", *ebsp_stage_probe.payload(B, 16384, dev),
         ebsp_fused_probe.n_nal_of(16384))]
    ebsp_inputs += [(f"hostile rows n_nal {n}", torch.as_tensor(h_rows, device=dev),
                     torch.as_tensor(h_lens, device=dev), n)
                    for n in (ebsp_cumsum_probe.n_nal_of(5960),
                              ebsp_fused_probe.n_nal_of(5960))]
    over = 0
    for case, rows, lens, n_nal in ebsp_inputs:
        args = (rows, lens, 0x41, n_nal, cap)
        want = ebsp_flat.rbsp_to_nal_plain(*args)
        hold("K3", case, ebsp_flat.rbsp_to_nal_batch(*args), want)
        for v in probes.EBSP_VARIANTS:
            hold(f"P5/P6 {v}", case, probes.ebsp_variant_batch(v, *args), want)
        over += int((want[1] > cap).sum())
    if over < 3:
        raise AssertionError("the hostile rows stayed under the cap")
    _log(f"phase 10: P4 equals its plain version and the host truth on the "
         f"JAX probe's {c_truth.shape[0]} x {c_truth.shape[1]} blocks and "
         f"{h_truth.shape[0]} lanes of hostile blocks; P5/P6 "
         f"({', '.join(probes.EBSP_VARIANTS)}) equal K3 and its plain version "
         f"on {len(ebsp_inputs)} inputs ({over} sessions past the cap) "
         f"({time.perf_counter() - t_new:.2f} s)")

    # (b) The scripts on the card, counted from 0.
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for name, extra in PROBE_SCRIPTS:
        mod = importlib.import_module(
            f"h264_scroll_encoder_tpu_torch.scripts.{name}")
        out = io.StringIO()
        ts = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(PROBE_DEPTH + extra)
        if rc != 0:
            raise AssertionError(f"{name} {extra} exited {rc}")
        table = json.loads(out.getvalue().strip().splitlines()[-1])
        table["seconds"] = round(time.perf_counter() - ts, 2)
        print(json.dumps(table), flush=True)
        if name == "step_cost":
            # The census line: each step's aten bytes by dtype (int64 is
            # left to index arguments and local unsigned widenings).
            for step, r in table["rows"].items():
                if r["int64_share"] > 0.15:
                    raise AssertionError(
                        f"step_cost {step}: int64 is {r['int64_share']:.1%} "
                        f"of the aten bytes ({r['int64_ops']})")
            _log(f"phase 10: census at B={table['batch']}: " + "; ".join(
                f"{step} {r['aten_ops']} aten ops move {r['aten_bytes']} B "
                f"(+ K1's {r['k1_bytes']} B on {r['symbols_dtype']} symbols, "
                f"K5/K6's {r['grid_bytes']} B): "
                + ", ".join(f"{d} {b} B" for d, b in r["by_dtype"].items())
                for step, r in table["rows"].items()))
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    for k in (*_kernels.PROBE_KERNELS, _kernels.COMPOSITE_GRID,
              _kernels.SCROLL_GRID):
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} never launched on the probes path")
    _log(f"phase 10: {len(PROBE_SCRIPTS)} script runs on the card "
         f"({time.perf_counter() - t1:.2f} s); launches {launches}")

    # (c) Timing at the 720p splice shapes, B = 256, as phase 3 times: the
    # stage's P1 on the compact step's symbols, P2 and P3 on the
    # ebsp_exact retry's (K2's input).  Bound: inputs read once and
    # outputs written once at 3.35 TB/s, symbols counted as int32.
    t2 = time.perf_counter()
    n_s, n_e = s_pat.shape[1], e_pat.shape[1]
    n_nal = emit_fused.nal_bytes(s_n_rbsp, cap)
    sym_in = B * n_s * 8 + B * 4
    out_bytes = {"launch": B * 16, "stage": B * 16, "scan": B * 16,
                 "pack": B * (n_nal + 16), "ep": B * 16, "full": B * (n_nal + 16)}
    pack_bytes = B * n_e * 8 + B * (e_words + 1) * 4
    runs = []
    for stage in probes.EMIT_STAGES:
        args = (stage, s_pat, s_nb, s_idc, s_n_rbsp, cap)
        runs.append((f"emit_stage[{stage}] (P1)", f"h264t_emit_stage[{stage}]",
                     f"P1 {stage}",
                     "h264_scroll_encoder_tpu/ops/emit_fused.py:214"
                     if stage == "full" else "scripts/emit_stage_probe.py:57",
                     lambda a=args: probes.emit_stage_batch(*a, **splice_kw),
                     lambda a=args: probes.emit_stage_plain(*a, **splice_kw),
                     (0 if stage == "launch" else sym_in) + out_bytes[stage]))
    runs.append(("pack_place_u16 (P2)", "h264t_pack_place_u16", "P2",
                 "scripts/pack_u16_probe.py:115",
                 lambda: probes.pack_place_u16_batch(e_pat, e_nb, e_words),
                 lambda: probes.pack_place_u16_plain(e_pat, e_nb, e_words),
                 pack_bytes))
    for tile in probes.TILES:
        runs.append((f"pack_place_tiled T={tile} (P3)", "h264t_pack_place_tiled",
                     f"P3 T={tile}", "scripts/pack_tiled_probe.py:116",
                     lambda t=tile: probes.pack_place_tiled_batch(
                         e_pat, e_nb, e_words, t),
                     lambda t=tile: probes.pack_place_tiled_plain(
                         e_pat, e_nb, e_words, t), pack_bytes))
    src = "h264_scroll_encoder_tpu_torch/csrc/probe_kernels.cu"
    runs = [(*r, src, f"720p splice B={B}") for r in runs]
    # P4 on the JAX probe's streams: its bound counts the stream bytes the
    # lanes decoded (the cursor's bytes) and the int32 results.
    k4 = cavlc_lockstep.BLOCKS
    p4_bytes = (int(((p4_end["JAX probe streams"].to(torch.int64) + 7) // 8)
                    .sum()) + c_data.shape[0] * (k4 * 5 + 1) * 4)
    runs.append(("cavlc_lockstep (P4)", "h264t_cavlc_lockstep", "P4",
                 "scripts/cavlc_device_probe.py:127",
                 lambda: cavlc_lockstep.decode_lockstep_batch(c_data, k4, luts),
                 None,                 # the plain decode is timed in (a2)
                 p4_bytes, "h264_scroll_encoder_tpu_torch/csrc/cavlc_lockstep.cu",
                 f"the JAX probe's {c_data.shape[0]} lanes x {k4} blocks"))
    # P5 at the cumsum probe's serving-rep shape, P6 at the fused probe's:
    # the valid bytes read once, the lengths, the NAL and the count.
    p5_p6 = {"runs": ("P5", "scripts/ebsp_cumsum_probe.py:36",
                      ebsp_cumsum_probe.n_nal_of(5960)),
             "ballot": ("P5", "scripts/ebsp_cumsum_probe.py:48",
                        ebsp_cumsum_probe.n_nal_of(5960)),
             "shared": ("P6", "scripts/ebsp_fused_probe.py:158",
                        ebsp_fused_probe.n_nal_of(5960)),
             "lanes": ("P6", "scripts/ebsp_fused_probe.py:40",
                       ebsp_fused_probe.n_nal_of(5960)),
             "direct": ("P6", "scripts/ebsp_fused_probe.py:170",
                        ebsp_fused_probe.n_nal_of(5960))}
    s_rows, s_lens = serving
    for v, (probe, rep_line, v_nal) in p5_p6.items():
        v_bytes = int(s_lens.sum()) + B * (8 + v_nal + 4)
        runs.append((f"ebsp_variant[{v}] ({probe})", f"h264t_ebsp_variant[{v}]",
                     f"P5/P6 {v}", rep_line,
                     lambda v=v, n=v_nal: probes.ebsp_variant_batch(
                         v, s_rows, s_lens, 0x41, n, cap),
                     lambda v=v, n=v_nal: probes.ebsp_variant_plain(
                         v, s_rows, s_lens, 0x41, n, cap),
                     v_bytes, src, f"n_rbsp 5960, n_nal {v_nal}, B={B}"))
    rows = []
    for name, counter, err_key, rep_line, kernel, plain, nbytes, source, shape \
            in runs:
        if plain is None:
            p_a = p_b = p4_plain_ms["JAX probe streams"]
        else:
            p_a = timing_.call_ms(plain, 5)
        d_a = timing_.device_ms(kernel)
        c = timing_.call_ms(kernel, 20)
        h = timing_.host_ms(kernel)
        d_b = timing_.device_ms(kernel)
        if plain is not None:
            p_b = timing_.call_ms(plain, 5)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": rep_line, "counter": counter,
                     "max_abs_err": errs[err_key], "ms": c,
                     "device_ms": statistics.median([d_a, d_b]), "host_ms": h,
                     "plain_ms": statistics.median([p_a, p_b]),
                     "bound_ms": nbytes / HBM_BYTES_PER_MS, "bound_by": "bytes",
                     "library_ms": None})
        _log(f"phase 10: {name} at {shape}: device {d_a:.5f}/"
             f"{d_b:.5f} ms per call, one call {c:.5f} ms, host issue "
             f"{h:.5f} ms, plain {p_a:.4f}/{p_b:.4f} ms, bound "
             f"{nbytes / HBM_BYTES_PER_MS:.5f} ms ({nbytes} B)")
    _log(f"phase 10: timing {time.perf_counter() - t2:.2f} s")
    return launches, rows



def _graph_paths(dev, cfg, cases, batch, schedule, dn32, bits32, has_align):
    """Phase 11's graphed paths at 720p: {name: (step, args_at, kernel)},
    args_at(t, outs) giving call t's arguments (changing every call: the
    scroll offsets and state, fresh donors and frame numbers, rolled hint
    sessions, the session's offsets and registry) and `kernel` the name of
    the device kernel each replay must run (K1's, or K2's on the exact
    paths)."""
    from h264_scroll_encoder_tpu_torch import session
    from h264_scroll_encoder_tpu_torch.config import MAX_WAYPOINTS
    from h264_scroll_encoder_tpu_torch.models import hints
    from h264_scroll_encoder_tpu_torch.models.splice import (FrameHints,
                                                             MotionRegion)
    from h264_scroll_encoder_tpu_torch.syntax.slice_headers import (
        p_slice_header_symbols)

    k1, k2 = "emit_fused_kernel", "pack_place"
    paths = {}
    state0 = batch.SessionState.create(schedule.shape[1], device=dev)
    paths["scroll step B=256"] = (
        batch.make_batched_step(cfg),
        lambda t, o: (state0 if o is None else o[0], schedule[t]), k1)

    def splice_args(dn, B):
        z = torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32, device=dev)
        zero = torch.zeros((B, cfg.mb_height, cfg.mb_width), dtype=torch.int32,
                           device=dev)

        def args_at(t, _outs):
            fn = torch.full((B,), 3 + t, dtype=torch.int32, device=dev)
            hp, hn = p_slice_header_symbols(cfg, fn, 2 * fn, False, -1, 0, z,
                                            z.bool())
            rows = (torch.arange(B, device=dev) + 5 * t) % N_DONORS
            return (hp, hn, zero, zero, zero, zero.bool(),
                    {k: v[rows] for k, v in dn.items()})
        return args_at

    steps = cases.splice_steps(cfg, int(bits32.max()), has_align)
    for name, B in (("compact", 256), ("compact", 1024), ("static", 256),
                    ("static", 1024), ("ebsp_exact", 256)):
        paths[f"rows {name} B={B}"] = (steps[name], splice_args(dn32, B),
                                       k2 if name == "ebsp_exact" else k1)
    dn, bits, align = cases.prepare_dense_donors("representative",
                                                 engine="native", device=dev)
    paths["dense B=256"] = (cases.dense_step(cfg, "representative", bits,
                                             align), splice_args(dn, 256), k1)
    hint_in = cases.hint_step_inputs()
    names = ("frame_num", "ref", "mv_x", "mv_y", "wp_count", "wp_ltidx",
             "wp_valid")
    paths["hint step B=256"] = (
        batch.make_batched_hint_step(cfg, compact_x=True, device=dev),
        lambda t, o: tuple(torch.as_tensor(np.roll(hint_in[k], t, axis=0) + (
            t if k == "frame_num" else 0), device=dev) for k in names), k1)

    s = session.ComposerSession(cfg, device=dev)
    offsets = (16, 496, 500, 700, 992, 1000, 1200, 1400)

    def frame_row(t, _outs):
        s.frame_num = 2 + t
        if t in (2, 5) and s.waypoints.count < 2:
            s.waypoints.register(496 * (t // 2))
        return (s._frame_row(offsets[t]),)

    for kind in ("scroll_frame", "waypoint_frame"):
        for exact in (False, True):
            fn = session.graphed_frame(kind, cfg, False, "floor", exact)
            paths[fn.name] = (fn, frame_row, k2 if exact else k1)
    paths["session sliced frame"] = (
        session.graphed_sliced_frame(cfg, False),
        lambda t, o: (s._frame_row(40 * t), cases.SESSION_ROWS_PER_SLICE), k1)
    paths["session hint frame"] = (
        hints.graphed_hint_frame(cfg, True),
        lambda t, o: (torch.as_tensor(hints.hint_frame_row(
            cfg, 2 + t, FrameHints(motion_regions=(MotionRegion(
                0, 2 * t, cfg.mb_width, 2 * t + 4, ref_idx=t % 2,
                mv_y=-4 * t),))), device=dev),), k1)
    return paths


def _graphs_phase(dev, cfg, cases, batch, _kernels, timing_, Timer, schedule,
                  dn32, bits32, has_align):
    """Phase 11: every graphed path (utils/graphs, the port's jax.jit) at
    720p.  Each is captured afresh and driven over 8 calls with changing
    inputs, each call equal to its `.eager` byte for byte and its outputs
    unchanged by the next call, with one capture for the key; each replay
    is one graph launch that runs K1 (K2 on the exact paths).  Then per
    path, graphed against eager on the same inputs in one run: CUDA API
    launches and device kernels per call and device time (torch.profiler,
    medians of PROFILE_WINDOWS windows, each window's kernel count kept),
    host wall and CUDA-event time (Timer, in turns), capture ms and pool
    bytes; the sharded step's blocks against its .eager; the golden
    digests on replays; the batch-1 session's p50 and p90, graphed and
    eager; a step with an .item() refused at capture, with no eager
    fallback.  Returns the launch counts of the 8-call runs."""
    from h264_scroll_encoder_tpu_torch.session import ComposerSession
    from h264_scroll_encoder_tpu_torch.utils import graphs

    _log(f"phase 11: before: {torch.cuda.memory_reserved(dev)} B reserved on "
         f"the card")
    paths = _graph_paths(dev, cfg, cases, batch, schedule, dn32, bits32,
                         has_align)
    for step in {id(p[0]): p[0] for p in paths.values()}.values():
        step.reset()    # a step may serve two paths (B = 256 and 1,024)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    calls = {}
    for name, (step, args_at, _kernel) in paths.items():
        outs, captures = cases.graph_replays(step, args_at)
        if captures != 1:
            raise AssertionError(f"{name}: {captures} captures for one key")
        calls[name] = args_at(1, outs)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in _kernels.KERNELS}
    for k in (_kernels.COMPOSITE_GRID, _kernels.SCROLL_GRID,
              _kernels.P_SLICE_HEADER):
        if launches[k.symbol] == 0:
            raise AssertionError(f"{k.symbol} never launched in a graph")
    _log(f"phase 11: {len(paths)} graphed paths, 8 calls each with changing "
         f"inputs: every call equals its .eager byte for byte, its outputs "
         f"survive the next call, one capture per key; launches {launches}")

    rows = {}
    for name, (step, _args_at, kernel) in paths.items():
        args = calls[name]
        # Three profiler windows of 5 calls, graphed and eager in turns.
        # torch.profiler can drop device events (a window may record fewer
        # kernels than the graph has, in the parent's runs too), so each
        # window must record one graph launch a call and the kernel at
        # least once and at most once a replay, and the median window
        # exactly once a replay; the device numbers are the windows'
        # medians.
        wins = {"graphed": [], "eager": []}
        for _ in range(PROFILE_WINDOWS):
            for mode, fn in (("graphed", step), ("eager", step.eager)):
                got = timing_.profile_step(lambda: fn(*args), 5)
                if got is None:
                    raise AssertionError(f"{name}: torch.profiler saw no "
                                         "device time")
                wins[mode].append(got)
        runs = [sum(n for k, n in w["kernel_counts"].items() if kernel in k)
                for w in wins["graphed"]]
        graph_launches = [w["api_by_kind"].get("cudaGraphLaunch")
                          for w in wins["graphed"]]
        if (any(n != 1 for n in graph_launches) or not 1 <= min(runs)
                or max(runs) > 5 or statistics.median(runs) != 5):
            raise AssertionError(f"{name}: 5 replays a window made "
                                 f"{graph_launches} graph launches a call and "
                                 f"recorded {kernel} {runs} times")
        timers = {"graphed": Timer(), "eager": Timer()}
        for mode in ("graphed", "eager", "eager", "graphed"):
            fn = step if mode == "graphed" else step.eager
            fn(*args)
            for _ in range(10):
                timers[mode](lambda: fn(*args))
        stats = step.graphs[step.key(*args)]
        row = {"capture_ms": stats.capture_ms, "pool_bytes": stats.pool_bytes,
               "kernel_runs": runs}
        for mode in ("graphed", "eager"):
            cuda_ms, wall = timers[mode].medians()
            w = wins[mode]
            device_ms = statistics.median(p["device_ms"] for p in w)
            row[mode] = {"api_launches": w[0]["api_launches"],
                         "api_by_kind": w[0]["api_by_kind"],
                         "kernels": statistics.median(p["kernels"] for p in w),
                         "kernels_by_window": [p["kernels"] for p in w],
                         "device_ms": device_ms,
                         "device_ms_by_window": [p["device_ms"] for p in w],
                         "cuda_event_ms": cuda_ms, "wall_ms": wall,
                         "busy": device_ms / wall}
        rows[name] = row
        _log(f"phase 11: {name}: " + "; ".join(
            f"{mode} {r['api_launches']:.1f} CUDA API launches "
            f"({', '.join(f'{k} {v:.1f}' for k, v in r['api_by_kind'].items())})"
            f", {r['kernels']:.1f} kernels (windows {r['kernels_by_window']})"
            f", device {r['device_ms']:.4f} ms, "
            f"host wall {r['wall_ms']:.4f} ms, CUDA events "
            f"{r['cuda_event_ms']:.4f} ms, busy {r['busy']:.1%}"
            for mode, r in ((m, row[m]) for m in ("graphed", "eager")))
            + f"; {kernel} recorded {runs} times in the windows' 5 replays; "
              f"capture {row['capture_ms']:.1f} ms, pool "
              f"{row['pool_bytes']} B")

    # The sharded step: one graph per device, its blocks against .eager.
    devices, layout = _block_devices(dev)
    sstep = batch.make_sharded_step(cfg, devices)
    blocks = batch.shard_batch(batch.SessionState.create(
        schedule.shape[1], device=dev), devices)
    for offs in schedule[:8]:
        offs_b = batch.shard_batch(offs, devices)
        new, outs = sstep(blocks, offs_b)
        want_state, want = sstep.eager(blocks, offs_b)
        got_all = [*batch.gather_batch(outs, dev),
                   *vars(batch.gather_batch(new, dev)).values()]
        want_all = [*batch.gather_batch(want, dev),
                    *vars(batch.gather_batch(want_state, dev)).values()]
        if not all(torch.equal(a, b) for a, b in zip(got_all, want_all)):
            raise AssertionError("the sharded step's graphs differ from eager")
        blocks = new
    timers = {"graphed": Timer(), "eager": Timer()}
    offs_b = batch.shard_batch(schedule[0], devices)
    for mode in ("graphed", "eager", "eager", "graphed"):
        fn = sstep if mode == "graphed" else sstep.eager
        for _ in range(10):
            timers[mode](lambda: fn(blocks, offs_b))
    _log(f"phase 11: sharded scroll step over {layout}, 8 steps: blocks equal "
         f".eager (NAL, lengths, flags, next state); host wall graphed "
         f"{timers['graphed'].medians()[1]:.4f} ms, eager "
         f"{timers['eager'].medians()[1]:.4f} ms (medians of 20)")

    # Golden digests on replays: each golden run a second time, when every
    # step of it replays a graph captured by the first.
    for label, run, path in (
            ("scroll", lambda: cases.port_golden(dev), cases.GOLDEN_PATH),
            ("splice rows", lambda: cases.port_splice_golden(dev),
             cases.SPLICE_GOLDEN_PATH),
            ("splice dense", lambda: cases.port_dense_golden(dev),
             cases.DENSE_GOLDEN_PATH)):
        run()
        if run() != json.loads(path.read_text()):
            raise AssertionError(f"{label}: replayed digests differ from "
                                 f"{path.name}")
    hint_step = batch.make_batched_hint_step(cfg, compact_x=True, device=dev)
    for _ in range(2):
        nal, nal_len, _bits, ovf = cases.run_hint_step(
            hint_step, cases.hint_step_inputs())
    if cases.hint_step_digest(nal.cpu().numpy(), nal_len.cpu().numpy(),
                              ovf.cpu().numpy()) != json.loads(
            cases.SESSION_GOLDEN_PATH.read_text())["hint_step"]:
        raise AssertionError("hint step: replayed digest differs")
    _log("phase 11: golden digests hold on replays: scroll_720p, "
         "splice_rows_720p, splice_dense_720p, the hint step (the session "
         "streams of phase 7 were composed on the frame graphs)")

    # The batch-1 session, graphed and eager, in turns.
    offsets = cases.session_scroll_offsets()[:64]
    frame_ms = {"graphed": [], "eager": []}
    for mode in ("graphed", "eager", "eager", "graphed"):
        s = ComposerSession(cfg, device=dev)
        if mode == "eager":
            s._scroll_fn, s._waypoint_fn = (s._scroll_fn.eager,
                                            s._waypoint_fn.eager)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        for off in offsets:
            t0 = time.perf_counter()
            s.write_scroll_or_waypoint_frame(off)
            frame_ms[mode].append((time.perf_counter() - t0) * 1e3)
    for mode, ms in frame_ms.items():
        ms = sorted(ms)
        rows[f"session batch-1 {mode}"] = {
            "p50_ms": statistics.median(ms),
            "p90_ms": ms[int(0.9 * (len(ms) - 1))]}
        _log(f"phase 11: batch-1 session, {mode} frames: "
             f"write_scroll_or_waypoint_frame p50 "
             f"{rows[f'session batch-1 {mode}']['p50_ms']:.4f} ms, p90 "
             f"{rows[f'session batch-1 {mode}']['p90_ms']:.4f} ms "
             f"({len(ms)} frames, host wall, bytes on the host; tick "
             f"16.7 ms); card {_smi()}")

    pools = {step.name: sum(c["pool_bytes"] for c in step.stats())
             for step, _a, _k in paths.values()}
    _log(f"phase 11: pool bytes of the paths' live graphs: {pools}; "
         f"{torch.cuda.memory_reserved(dev)} B reserved on the card")
    nodes = {step.name: [c["nodes"] for c in step.stats()]
             for step, _a, _k in paths.values()}
    _log(f"phase 11: nodes of the paths' live graphs: {nodes}")
    for step in {id(p[0]): p[0] for p in paths.values()}.values():
        step.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _log(f"phase 11: after freeing the paths' graphs: "
         f"{torch.cuda.memory_reserved(dev)} B reserved")

    # A step that reads a device value on the host cannot be captured.
    bad = graphs.graphed(lambda x: x * int(x.sum().item()), "item step")
    x = torch.ones(4, device=dev)
    for _ in range(2):
        try:
            bad(x)
        except graphs.GraphCaptureError as e:
            if "item step" not in str(e):
                raise AssertionError(f"the capture error names no step: {e}")
        else:
            raise AssertionError("a step with .item() was captured, or ran "
                                 "eagerly without raising")
    if bad.captures or bad.graphs or not torch.equal(
            x + 1, torch.full((4,), 2.0, device=dev)):
        raise AssertionError("the refused capture left a graph or a fault")
    _log("phase 11: a step with .item() raises GraphCaptureError at capture "
         "on every call; no eager fallback; the card keeps working")
    print(json.dumps({"graphs": rows}), flush=True)
    return launches

if __name__ == "__main__":
    sys.exit(main())
