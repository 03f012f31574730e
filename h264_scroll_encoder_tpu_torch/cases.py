"""Seeded inputs and golden digests shared by the tests and chip_smoke.py.

The cases are plain numpy arrays, so the same inputs feed the JAX package
(in the tests), the port's plain PyTorch versions and the CUDA kernels
(on the card).  `golden/scroll_720p.json` holds the JAX package's output
digests for the 720p scroll schedule below, `golden/splice_rows_720p.json`
those of the 720p rows splice of seeded representative donors,
`golden/splice_dense_720p.json` the dense splice of the same donors (and
of I_PCM-bearing ones), `golden/session_720p.json` the session streams
and `golden/large_frames.json` two hint frames whose NAL buffer passes a
block's shared memory; `port_golden`, `port_splice_golden`,
`port_dense_golden`, `port_session_golden` and `large_golden` recompute
them with the port on any device.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from ._kernels import PACK_THREADS, resolve_device
from .config import ComposerConfig, MAX_EBSP_INSERTIONS, MAX_WAYPOINTS
from .models import scroll
from .ops import emit_fused
from .parallel import batch

GOLDEN_PATH = Path(__file__).resolve().parent / "golden" / "scroll_720p.json"

# Byte-stream cases: one fixed symbol count, as tests/test_emit_fused.py.
N_SYM = 203
N_RBSP = (N_SYM + 64 + 3) // 4 * 4
CAP = MAX_EBSP_INSERTIONS


def byte_stream_case(rng, kind: int, n_payload: int):
    """A payload of byte-wide symbols plus an aligned trailing-bits byte:
    kind 0 random bytes, 1 heavy zeros, 2 00 00 0x trigger soup, 3
    word-straddling 00 00 03 patterns.  Returns (pat u32[N_SYM],
    nbits i32[N_SYM])."""
    if kind == 0:
        vals = rng.integers(0, 256, n_payload)
    elif kind == 1:
        vals = rng.integers(0, 256, n_payload)
        vals[rng.random(n_payload) < 0.7] = 0
    elif kind == 2:
        vals = rng.choice([0, 0, 0, 1, 2, 3, 4, 255], n_payload)
    else:
        vals = np.tile([0, 0, 3, 9], n_payload // 4 + 1)[:n_payload]
    return _bytes_to_symbols(vals)


def _bytes_to_symbols(vals, n_sym: int = N_SYM):
    n_payload = len(vals)
    patterns = np.zeros(n_sym, np.uint32)
    nbits = np.zeros(n_sym, np.int32)
    patterns[:n_payload] = vals
    nbits[:n_payload] = 8
    patterns[n_payload] = 0x80          # trailing bits (aligned payload)
    nbits[n_payload] = 8
    return patterns, nbits


def byte_stream_cases(seed: int = 0, trials: int = 16):
    """[trials] mixed byte-stream cases, kinds in rotation."""
    rng = np.random.default_rng(seed)
    out = [byte_stream_case(rng, t % 4, int(rng.integers(5, N_SYM - 1)))
           for t in range(trials)]
    return np.stack([p for p, _ in out]), np.stack([n for _, n in out])


def overflow_case():
    """3 * (cap + 2) zero bytes then the trailing byte: one insertion per
    two zeros, beyond the insertion cap."""
    return _bytes_to_symbols(np.zeros(3 * (CAP + 2), np.int64))


def window_sweep_cases():
    """Zero runs of 60-72 bytes starting at all four byte phases, behind a
    nonzero prefix long enough (>= 17 words) for K1's 16-word window to
    saturate, ended by a byte that would take an insertion (0x01) or not
    (0x80).  Returns (pat u32[K, N_SYM], nbits i32[K, N_SYM], runs[K])."""
    pats, nbs, runs = [], [], []
    for phase in range(4):
        for run in range(60, 73):
            for end in (0x01, 0x80):
                vals = [0x55] * (72 + phase) + [0] * run + [end, 0x77, 0x21]
                p, n = _bytes_to_symbols(np.asarray(vals))
                pats.append(p)
                nbs.append(n)
                runs.append(run)
    return np.stack(pats), np.stack(nbs), np.asarray(runs)


def align_cases(seed: int = 11, batch: int = 12, with_sentinels: bool = True):
    """Random 1-16 bit symbols with a zero-width tail and, optionally, a
    few I_PCM alignment sentinels (nbits -1, pattern 0)."""
    rng = np.random.default_rng(seed)
    pats, nbs = [], []
    for _ in range(batch):
        nb = rng.integers(1, 17, N_SYM).astype(np.int32)
        pat = (rng.integers(0, 2 ** 31, N_SYM).astype(np.uint32)
               & ((1 << np.clip(nb, 0, 31)) - 1).astype(np.uint32))
        cut = int(rng.integers(N_SYM // 2, N_SYM))
        nb[cut:] = 0
        pat[cut:] = 0
        if with_sentinels:
            for _ in range(int(rng.integers(0, 5))):
                i = int(rng.integers(1, cut))
                nb[i] = -1
                pat[i] = 0
        pats.append(pat)
        nbs.append(nb)
    return np.stack(pats), np.stack(nbs)


def pack_cases(seed: int, batch: int, n: int, num_words: int):
    """Random widths in [0, 32] (60% absent) within a num_words budget."""
    rng = np.random.default_rng(seed)
    pats, nbs = [], []
    for _ in range(batch):
        nb = rng.integers(0, 33, n).astype(np.int32)
        nb[rng.random(n) < 0.6] = 0
        while int(nb.sum()) > num_words * 32:
            nb[rng.random(n) < 0.5] = 0
        pats.append(rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                    .astype(np.uint32))
        nbs.append(nb)
    return np.stack(pats), np.stack(nbs)


def pack_edge_case(seed: int, n: int, num_words: int):
    """One K4 edge case: random widths with every 7th lane 32 bits wide
    and every 5th 0, usually past the num_words budget (the pack drops the
    bits beyond it).  Returns (pat u32[n], nbits i32[n])."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 33, n).astype(np.int32)
    nb[::7] = 32
    nb[::5] = 0
    pat = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return pat, nb


# K3 byte-stream cases: payloads of up to EBSP_PAYLOAD bytes into
# EBSP_N_NAL-byte NAL buffers (room for the 1.5x worst case).
EBSP_PAYLOAD = 517
EBSP_N_NAL = 896
EBSP_LENGTHS = (0, 1, 5, 64, 127, 200, 517)


def ebsp_cases(seed: int = 11):
    """RBSP byte streams for K3, one per (kind, length) with kind 0
    random bytes and 1 zero-heavy (00 00 0x soup), lengths EBSP_LENGTHS:
    (rbsp u8[K, EBSP_PAYLOAD] zero past each length, lengths i32[K],
    header bytes i32[K])."""
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    for zero_heavy in (False, True):
        for n in EBSP_LENGTHS:
            b = (rng.choice([0, 0, 0, 1, 2, 3, 255], n) if zero_heavy
                 else rng.integers(0, 256, n))
            row = np.zeros(EBSP_PAYLOAD, np.uint8)
            row[:n] = b
            rows.append(row)
            lens.append(n)
    headers = 0x01 | (np.arange(len(rows)) % 4 << 5)
    return (np.stack(rows), np.asarray(lens, np.int32),
            headers.astype(np.int32))


def int32_bits(x):
    """int64 symbols (uint32 patterns, signed widths) -> int32 with the same
    low 32 bits: the kernels' int32 input route.  numpy or torch."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64) & 0xFFFFFFFF
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return ((np.asarray(x).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
            .view(np.int32))


# Boundary cases of the CUDA pack of K1 and K2/K4: each of the T =
# PACK_THREADS threads owns a contiguous run of k = items_per_thread(n)
# symbols of a staged chunk of T * k (csrc/emit_kernels.cu).  Lengths
# k*T - 1, k*T and k*T + 1 for k = 1, 19 (the 720p splice run) and
# PACK_MAX_ITEMS (one full chunk; one more symbol starts a second chunk),
# and one shorter than T.
PACK_BOUNDARY_LENGTHS = tuple(
    k * PACK_THREADS + d for k in (1, 19, emit_fused.PACK_MAX_ITEMS)
    for d in (-1, 0, 1)) + (100,)


def pack_boundary_cases(n: int, *, sentinels: bool = True):
    """Sessions of n symbols aimed at the run boundaries of the CUDA pack,
    with random uint32 patterns (unmasked) and widths:
      0  random 1-16 bit widths;
      1  32-bit and width-0 lanes at the first and last symbol of each run;
      2  stretches of 1-bit symbols three runs long, so that one word spans
         several threads' runs;
      3  I_PCM alignment sentinels (nbits -1, pattern 0) as the first and
         last symbol of every other run — width 0 there when not
         `sentinels` (the pack alone takes no sentinels).
    For n < PACK_THREADS, one session holding all four.  Returns
    (pat u32[B, n], nbits i32[B, n], n_rbsp) with n_rbsp, a multiple of 4,
    room for every session's bits and trailing bits."""
    rng = np.random.default_rng(n)
    k = emit_fused.items_per_thread(n)
    idx = np.arange(n)
    run = idx // k
    first, last = idx % k == 0, idx % k == k - 1
    nbs = [rng.integers(1, 17, n) for _ in range(4)]
    nbs[1][last] = np.where(run[last] % 2 == 0, 0, 32)
    nbs[1][first] = np.where(run[first] % 2 == 0, 32, 0)
    nbs[2][(run // 3) % 2 == 0] = 1
    ends = (first | last) & (run % 2 == 0)
    nbs[3][ends] = -1 if sentinels else 0
    if n < PACK_THREADS:
        nb = nbs[0]
        for j, kind in enumerate(nbs[1:]):
            part = slice(j * n // 3, (j + 1) * n // 3)
            nb[part] = kind[part]
        nbs = [nb]
    nb = np.stack(nbs).astype(np.int32)
    pat = rng.integers(0, 2 ** 32, nb.shape, dtype=np.uint64).astype(np.uint32)
    pat[nb < 0] = 0
    bits = np.where(nb < 0, 7, nb).sum(axis=1).max()
    return pat, nb, int(bits // 8 + 8) // 4 * 4


def chunk_zero_run_cases():
    """Zero runs of 63-67 bytes, around K1's 16-word window edge, starting
    at each of the 8 byte phases of a K1 thread's 8-byte RBSP chunk (a
    stream of 2,048-4,096 bytes gives each of the 512 threads two words),
    behind a nonzero prefix and ended by 0x01.  Returns (pat u32[K, n],
    nbits i32[K, n], runs[K], n_rbsp)."""
    rng = np.random.default_rng(7)
    n = 2600
    pats, nbs, runs = [], [], []
    for phase in range(8):
        for run in range(63, 68):
            vals = rng.integers(1, 256, n - 1)
            start = 2000 + phase
            vals[start:start + run] = 0
            vals[start + run] = 0x01
            p, b = _bytes_to_symbols(vals, n)
            pats.append(p)
            nbs.append(b)
            runs.append(run)
    return np.stack(pats), np.stack(nbs), np.asarray(runs), n + 64


# aten ops that only allocate or make views: no device work runs for them.
_NO_WORK_OPS = {"empty", "empty_strided", "select", "slice", "view", "reshape",
                "_reshape_alias", "expand", "as_strided", "alias", "detach",
                "unsqueeze", "squeeze", "t", "lift_fresh"}


def compute_ops(fn) -> list[str]:
    """Names of the aten ops fn() runs other than allocations and views, in
    order: the tensor work it does besides the hand-written kernels it
    launches through ctypes (which no dispatcher sees)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in _NO_WORK_OPS:
                seen.append(name)
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


# Boundary cases of the CUDA K3 (csrc/emit_kernels.cu): each of the
# PACK_THREADS threads owns a contiguous run of ops/ebsp_flat
# .items_per_thread(valid) bytes (11 at 5,000 bytes, 13 at 6,500; the card
# tests hold it equal to the built kernel's).  Rows of
# an odd EBSP_BOUNDARY_M bytes, so that row starts fall on every alignment,
# into 720p NAL buffers whose copy-out takes 16-byte, 4-byte and 1-byte
# stores.
EBSP_BOUNDARY_M = 8191
EBSP_BOUNDARY_N_NALS = (8224, 8228, 8221)


def ebsp_boundary_cases(seed: int = 3):
    """RBSP rows aimed at the run boundaries of the CUDA K3, on a base of
    random bytes in [4, 255] (which insert nothing by themselves), at 720p
    lengths:
      0-1  at every run boundary of a 5,000- and a 6,500-byte stream, a
           zero run of 1-3 bytes ending before, at or after the boundary,
           then one of 00, 01, 02, 03, 80: `00 00 0x` triples split across
           two threads' runs;
      2-3  zero runs of 62-63 bytes (resolved) and of 64-66 bytes
           (saturating) starting at every phase of a thread's run;
      4-7  the first nonzero byte at 63, 64, 65 and 66;
      8-9  a zero run that saturates inside the last thread's run, at the
           end of the stream and before a last 01;
      10   random bytes of all values at the full RBSP budget;
      11-16 one row ending in two zero bytes at lengths m - 1, m, m + 1,
           past padded_len(n_nal), 0 and -1.
    Returns (rbsp u8[17, EBSP_BOUNDARY_M], lengths i32[17], header bytes
    i32[17], among them values above 255, which keep their low byte)."""
    from .ops.ebsp_flat import items_per_thread, padded_len

    rng = np.random.default_rng(seed)
    m = EBSP_BOUNDARY_M
    rows, lens = [], []

    def add(row, n):
        rows.append(row)
        lens.append(n)

    def base():
        return rng.integers(4, 256, m).astype(np.uint8)

    for n in (5000, 6500):
        per, row = items_per_thread(n), base()
        for j, b in enumerate(range(per, n - 8, per)):
            r = 1 + j % 3
            start = b - r + (j // 3) % (r + 1)
            row[start:start + r] = 0
            row[start + r] = (0, 1, 2, 3, 0x80)[(j // 12) % 5]
        add(row, n)
    for runs in ((62, 63), (64, 65, 66)):
        n = 6500
        per, row = items_per_thread(n), base()
        pos, j = 100, 0
        while True:
            r = runs[j % len(runs)]
            start = (pos // per + 1) * per + j % per
            if start + r + 1 >= n:
                break
            row[start:start + r] = 0
            row[start + r] = (1, 3, 0x80)[j % 3]
            pos, j = start + r + 150, j + 1
        add(row, n)
    for first in (63, 64, 65, 66):
        row = base()
        row[:first] = 0
        add(row, 5000)
    n = 5000
    for tail in ((n - 70, n), (n - 66, n - 1)):
        row = base()
        row[tail[0]:tail[1]] = 0
        row[tail[1]:n] = 1
        add(row, n)
    add(rng.integers(0, 256, m).astype(np.uint8), m - 1)
    row = base()
    row[m - 2:] = 0
    for n in (m - 1, m, m + 1, padded_len(EBSP_BOUNDARY_N_NALS[0]) + 100,
              0, -1):
        add(row, n)
    headers = 0x01 | (np.arange(len(rows)) % 4 << 5)
    headers[-1] = 0x165
    return (np.stack(rows), np.asarray(lens, np.int32),
            headers.astype(np.int32))


# NAL sizes past one block's shared memory for K3 (staged row plus NAL):
# the dense I_PCM splice's default buffer and the 3840x2160 hint frame's at
# 64 bits per MB.
EBSP_LARGE_N_NALS = (237_600, 259_328)


def ebsp_large_cases(n_nal: int, seed: int = 4):
    """RBSP rows for K3 at a large NAL size: random bytes in [4, 255] with
    a `00 00 0x` triple every ~2,000 bytes (in-contract under a cap of
    1,000), a zero-heavy row past the cap of 16, a row of 64+ byte zero
    runs (saturating) and a short one, at lengths up to the buffer's
    payload room.  Returns (rbsp u8[4, n_nal - 5], int64 lengths [4])."""
    rng = np.random.default_rng(seed)
    m = n_nal - 5
    rows = rng.integers(4, 256, (4, m)).astype(np.uint8)
    for start in range(100, m - 4, 1999):
        rows[0, start:start + 2] = 0
        rows[0, start + 2] = start % 4
    heavy = rng.random(m) < 0.5
    rows[1, heavy] = rng.choice([0, 1, 2, 3], int(heavy.sum()))
    for start in range(5000, m - 200, 30_000):
        rows[2, start:start + 70] = 0
    lens = np.asarray([m - 1100, m - 16 - 5, m // 2, 4096], np.int64)
    return rows, lens


def ebsp_saturation_case():
    """A stream whose first nonzero byte lies past K3's 64-byte zero-run
    window (200 zeros, then 56 nonzero bytes): the count saturates past
    the insertion cap.  Returns (rbsp u8[384], rbsp_len)."""
    rb = np.zeros(384, np.uint8)
    rb[200:256] = np.arange(1, 57)
    return rb, 256


# ---------------------------------------------------------------------------
# The 720p scroll schedules.
# ---------------------------------------------------------------------------

GOLDEN_WIDTH, GOLDEN_HEIGHT = 1280, 720
GOLDEN_BATCH, GOLDEN_STEPS = 8, 12
# Per-session scroll speeds in px/step; 62, 124 and 248 divide 496, so
# those sessions land exactly on the waypoint offset and emit waypoints.
GOLDEN_SPEEDS = (62, 31, 124, 16, 8, 248, 4, 0)


def golden_schedule():
    """[GOLDEN_STEPS, GOLDEN_BATCH] int32 offsets of the golden 720p run."""
    t = np.arange(GOLDEN_STEPS)[:, None]
    return ((t * np.asarray(GOLDEN_SPEEDS)[None, :]) % GOLDEN_HEIGHT
            ).astype(np.int32)


def bench_schedule(height: int = 720, batch: int = 256, frames: int = 32):
    """bench.py's scroll schedule: a triangle wave per session, 4 px/step,
    phase-shifted 17 px per session.  [frames, batch] int32."""
    t = np.arange(frames)[:, None] + np.zeros((1, batch))
    cycle = (t * 4 + np.arange(batch)[None, :] * 17) % (2 * height)
    return np.where(cycle < height, cycle, 2 * height - cycle).astype(np.int32)


def golden_config() -> dict:
    return {"width": GOLDEN_WIDTH, "height": GOLDEN_HEIGHT,
            "batch": GOLDEN_BATCH, "steps": GOLDEN_STEPS,
            "speeds": list(GOLDEN_SPEEDS)}


def port_golden(device="cuda") -> dict:
    """The golden digests computed by the port on `device`: the batched
    step over golden_schedule(), then one `ebsp_exact` scroll frame per
    session at the last offsets."""
    cfg = ComposerConfig(GOLDEN_WIDTH, GOLDEN_HEIGHT)
    step = batch.make_batched_step(cfg)
    state = batch.SessionState.create(GOLDEN_BATCH, device=device)
    offsets = torch.as_tensor(golden_schedule(), device=device)
    steps = []
    for offs in offsets:
        state, (nal, nal_len, wp, _bits, ovf) = step(state, offs)
        steps.append(digest_step(*(x.cpu().numpy()
                                   for x in (nal, nal_len, wp, ovf))))
    nal, nal_len, _bits, ovf = scroll.scroll_frame(
        cfg, state.frame_num, offsets[-1], state.wp_offsets, state.wp_ltidx,
        state.wp_valid, state.wp_count, ebsp_exact=True)
    no_wp = np.zeros(GOLDEN_BATCH, bool)
    return {"config": golden_config(), "steps": steps,
            "ebsp_exact": digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                      no_wp, ovf.cpu().numpy())}


# ---------------------------------------------------------------------------
# The 720p rows splice (bench.py's `_splice_config` geometry).
# ---------------------------------------------------------------------------

SPLICE_GOLDEN_PATH = GOLDEN_PATH.parent / "splice_rows_720p.json"
# Rect at MB column 30, row 10, 23x23 MBs; two composite references.
SPLICE_C0, SPLICE_R0, SPLICE_C, SPLICE_R = 30, 10, 23, 23
SPLICE_NUM_REFS = 2
SPLICE_FRAME_NUM = 3
# Pinned wire classes: every representative 23x23 donor fits them, so one
# step serves all of them (rows <= 128 chunks, <= 1,536 chunks in all).
SPLICE_S_ROW, SPLICE_S_FLAT, SPLICE_S_EXC = 128, 1536, 32
SPLICE_DONOR_SEED = 1000
SPLICE_GOLDEN_BATCH = 8


def splice_donor_payload(k: int) -> bytes:
    """CAVLC P-slice payload (one reference) of representative donor k:
    fixtures.representative_donor_grid seeded SPLICE_DONOR_SEED + k."""
    from .models import mb_transcode as mbt
    from .ops.bitio import BitWriter
    from .utils import fixtures

    grid = fixtures.representative_donor_grid(
        np.random.default_rng(SPLICE_DONOR_SEED + k), SPLICE_C, SPLICE_R)
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def splice_budget(cfg: ComposerConfig, donor_bits: int, *,
                  static_bg: bool) -> int:
    """bench.py's RBSP budget: 4 bits per background MB for the compact
    program, no background allowance for the static-chrome one."""
    from .models import splice_device

    return splice_device.splice_rows_rbsp_budget(
        cfg, SPLICE_R * SPLICE_C, SPLICE_R, donor_bits,
        bg_bits_per_mb=None if static_bg else 4, static_bg=static_bg)


def splice_session_inputs(cfg: ComposerConfig, batch_size: int, device):
    """Header symbols and an all-skip, zero-motion background for
    `batch_size` sessions: (hp, hn, bg_ref, bg_mvx, bg_mvy, bg_coded)."""
    from .syntax.slice_headers import p_slice_header_symbols

    frame_num = torch.full((batch_size,), SPLICE_FRAME_NUM, dtype=torch.int64,
                           device=device)
    hp, hn = p_slice_header_symbols(
        cfg, frame_num, 2 * SPLICE_FRAME_NUM, False, -1, 0,
        torch.zeros((batch_size, MAX_WAYPOINTS), dtype=torch.int64,
                    device=device),
        torch.zeros((batch_size, MAX_WAYPOINTS), dtype=torch.bool,
                    device=device))
    zero = torch.zeros((batch_size, cfg.mb_height, cfg.mb_width),
                       dtype=torch.int32, device=device)
    return hp, hn, zero, zero, zero, zero.to(torch.bool)


def splice_steps(cfg: ComposerConfig, donor_bits: int, has_align: bool):
    """The three rows splice programs of the golden run, over the blob
    wire: {"compact": bench.py's representative program, "static": the
    static-chrome program, "ebsp_exact": the compact program's exact-EBSP
    retry}."""
    common = dict(num_refs=SPLICE_NUM_REFS, has_align=has_align,
                  s_row=SPLICE_S_ROW, s_flat=SPLICE_S_FLAT,
                  s_exc=SPLICE_S_EXC)
    rect = (cfg, SPLICE_C0, SPLICE_R0, SPLICE_C, SPLICE_R)
    compact = splice_budget(cfg, donor_bits, static_bg=False)
    static = splice_budget(cfg, donor_bits, static_bg=True)
    return {
        "compact": batch.make_batched_splice_step_rows(
            *rect, n_rbsp=compact, compact_x=True, **common),
        "static": batch.make_batched_splice_step_rows(
            *rect, n_rbsp=static, bg_static_skip=True, **common),
        "ebsp_exact": batch.make_batched_splice_step_rows(
            *rect, n_rbsp=compact, compact_x=True, ebsp_exact=True,
            **common),
    }


def prepare_splice_donors(payloads, *, engine: str, device):
    """Blob-wire donor tensors for the payloads: (dn, donor_bits i64[N],
    has_align bool[N])."""
    from .models import splice_device

    dn, (donor_bits, has_align) = splice_device.prepare_donor_rows_serving(
        payloads, [0] * len(payloads), SPLICE_R, SPLICE_C, 1, SPLICE_NUM_REFS,
        s_row=SPLICE_S_ROW, blob_wire=True, s_flat=SPLICE_S_FLAT,
        s_exc=SPLICE_S_EXC, engine=engine, device=device)
    return dn, donor_bits, has_align


def splice_symbols(cfg: ComposerConfig, dn: dict, batch_size: int,
                   n_rbsp: int, device):
    """K1's input on the compact splice step: (patterns int64[B, n], nbits
    int64[B, n]) of `batch_size` sessions carrying the prepared donors of
    `dn` in turn."""
    from .models import splice_device

    blob = dn["blob"]
    tiled = {"blob": blob[torch.arange(batch_size, device=blob.device)
                          % blob.shape[0]]}
    pat, nb, _ = splice_device.rows_splice_symbols(
        cfg, SPLICE_C0, SPLICE_R0, SPLICE_R, SPLICE_C, SPLICE_NUM_REFS,
        *splice_session_inputs(cfg, batch_size, device), tiled, n_rbsp=n_rbsp,
        compact_x=True, s_row=SPLICE_S_ROW, s_flat=SPLICE_S_FLAT,
        s_exc=SPLICE_S_EXC)
    return pat, nb


def splice_golden_config() -> dict:
    return {"width": GOLDEN_WIDTH, "height": GOLDEN_HEIGHT,
            "rect": [SPLICE_C0, SPLICE_R0, SPLICE_C, SPLICE_R],
            "num_refs": SPLICE_NUM_REFS, "frame_num": SPLICE_FRAME_NUM,
            "batch": SPLICE_GOLDEN_BATCH, "donor_seed": SPLICE_DONOR_SEED}


def port_splice_golden(device="cuda", engine: str = "native") -> dict:
    """The splice golden digests computed by the port on `device`: donors
    0..SPLICE_GOLDEN_BATCH-1 prepared by `engine`, one frame per session
    through each program of splice_steps()."""
    cfg = ComposerConfig(GOLDEN_WIDTH, GOLDEN_HEIGHT)
    payloads = [splice_donor_payload(k) for k in range(SPLICE_GOLDEN_BATCH)]
    dn, donor_bits, has_align = prepare_splice_donors(
        payloads, engine=engine, device=device)
    inputs = splice_session_inputs(cfg, SPLICE_GOLDEN_BATCH, device)
    out = {"config": splice_golden_config()}
    no_wp = np.zeros(SPLICE_GOLDEN_BATCH, bool)
    for name, step in splice_steps(cfg, int(donor_bits.max()),
                                   bool(has_align.any())).items():
        nal, nal_len, _bits, ovf = step(*inputs, dn)
        out[name] = digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                no_wp, ovf.cpu().numpy())
    return out


# ---------------------------------------------------------------------------
# The 720p dense splice (the same geometry and donors, per-MB layout).
# ---------------------------------------------------------------------------

DENSE_GOLDEN_PATH = GOLDEN_PATH.parent / "splice_dense_720p.json"
# The 32 seeded representative donors (seeds SPLICE_DONOR_SEED + k), as
# bench.py's _splice_config builds them; the I_PCM-bearing configuration
# gives each one I_PCM MB at [0][0].
DENSE_DONORS = 32
DENSE_CONFIGS = ("representative", "ipcm")


def dense_donor_payload(k: int, ipcm: bool = False) -> bytes:
    """CAVLC P-slice payload (one reference) of dense donor k: the
    representative donor grid seeded SPLICE_DONOR_SEED + k, with one I_PCM
    macroblock at [0][0] (drawn from the same generator) when `ipcm`."""
    from .models import mb_transcode as mbt
    from .ops.bitio import BitWriter
    from .utils import fixtures

    rng = np.random.default_rng(SPLICE_DONOR_SEED + k)
    grid = fixtures.representative_donor_grid(rng, SPLICE_C, SPLICE_R)
    if ipcm:
        grid[0][0] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def stack_dense(dds) -> dict:
    """Either package's DonorDense list -> the dense wire as numpy arrays
    with a leading donor axis, every donor's chunks padded with zero-width
    slots to the widest chunk class (padding adds no bits)."""
    S = max(dd.patterns.shape[1] for dd in dds)

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, ((0, 0), (0, S - a.shape[1])))

    from .models.splice_device import ROLE_FIELDS

    out = {"patterns": np.stack([pad(dd.patterns) for dd in dds]).astype(np.uint32),
           "nbits": np.stack([pad(dd.nbits) for dd in dds]).astype(np.int32),
           "coded": np.stack([np.asarray(dd.coded, bool) for dd in dds])}
    for f in ROLE_FIELDS:
        out[f] = np.stack([np.asarray(getattr(dd, f), np.int32) for dd in dds])
    return out


def dense_budget(cfg: ComposerConfig, config: str, donor_bits: int):
    """The dense step's n_rbsp: the honest budget of the widest donor for
    "representative", the emitter's default (None: the chunk class's) for
    "ipcm"."""
    from .models import splice_device

    if config == "ipcm":
        return None
    return splice_device.splice_rbsp_budget(cfg, SPLICE_R * SPLICE_C,
                                            donor_bits)


def prepare_dense_donors(config: str, *, engine: str, device,
                         n: int = DENSE_DONORS):
    """The dense wire of donors 0..n-1 of `config` on `device`: (dn
    {field: tensor [n, ...]}, max donor_bits, any has_align)."""
    from .models import splice_device

    dds = [splice_device.prepare_donor_dense_from_slice(
               dense_donor_payload(k, config == "ipcm"), 0, SPLICE_C,
               SPLICE_R, 1, SPLICE_NUM_REFS, engine=engine)
           for k in range(n)]
    dn = splice_device.donor_arrays_from_numpy(stack_dense(dds), device)
    return (dn, max(dd.donor_bits for dd in dds),
            any(dd.has_align for dd in dds))


def dense_step(cfg: ComposerConfig, config: str, donor_bits: int,
               has_align: bool, *, ebsp_exact: bool = False):
    """The dense splice step of `config` at bench.py's geometry."""
    return batch.make_batched_splice_step_dense(
        cfg, SPLICE_C0, SPLICE_R0, SPLICE_C, SPLICE_R, SPLICE_NUM_REFS,
        has_align=has_align, n_rbsp=dense_budget(cfg, config, donor_bits),
        ebsp_exact=ebsp_exact)


def dense_symbols(cfg: ComposerConfig, config: str, dn: dict,
                  donor_bits: int, device):
    """K1's input on the dense step of `config`, one session per donor of
    `dn`: (patterns int64[B, n], nbits int64[B, n], n_rbsp)."""
    from .models import splice_device

    B = next(iter(dn.values())).shape[0]
    return splice_device.dense_splice_symbols(
        cfg, SPLICE_C0, SPLICE_R0, SPLICE_R, SPLICE_C, SPLICE_NUM_REFS,
        *splice_session_inputs(cfg, B, device), dn,
        n_rbsp=dense_budget(cfg, config, donor_bits))


def tile_donors(dn: dict, batch_size: int) -> dict:
    """`batch_size` sessions carrying the donors of `dn` in turn."""
    n = next(iter(dn.values())).shape[0]
    idx = torch.arange(batch_size) % n
    return {k: v[idx.to(v.device)] for k, v in dn.items()}


def dense_golden_config() -> dict:
    return {"width": GOLDEN_WIDTH, "height": GOLDEN_HEIGHT,
            "rect": [SPLICE_C0, SPLICE_R0, SPLICE_C, SPLICE_R],
            "num_refs": SPLICE_NUM_REFS, "frame_num": SPLICE_FRAME_NUM,
            "donors": DENSE_DONORS, "donor_seed": SPLICE_DONOR_SEED,
            "configs": {"representative": "honest budget of the widest donor",
                        "ipcm": "one I_PCM MB at [0][0], the chunk class's "
                                "default budget"}}


def port_dense_golden(device="cuda", engine: str = "native") -> dict:
    """The dense golden digests computed by the port on `device`: one
    frame per donor (B = DENSE_DONORS) of each configuration."""
    device = resolve_device(device)
    cfg = ComposerConfig(GOLDEN_WIDTH, GOLDEN_HEIGHT)
    out = {"config": dense_golden_config()}
    inputs = splice_session_inputs(cfg, DENSE_DONORS, device)
    no_wp = np.zeros(DENSE_DONORS, bool)
    for config in DENSE_CONFIGS:
        dn, bits, align = prepare_dense_donors(config, engine=engine,
                                               device=device)
        nal, nal_len, _bits, ovf = dense_step(cfg, config, bits, align)(
            *inputs, dn)
        out[config] = digest_step(nal.cpu().numpy(), nal_len.cpu().numpy(),
                                  no_wp, ovf.cpu().numpy())
    return out


def digest_step(nal, nal_len, emitted_waypoint, overflow):
    """Per-session digest of one step's outputs (numpy arrays): the sha256
    of the valid NAL bytes, the length and both flags."""
    nal = np.asarray(nal)
    return [{"sha256": hashlib.sha256(
                 nal[b, :int(nal_len[b])].tobytes()).hexdigest(),
             "nal_len": int(nal_len[b]),
             "emitted_waypoint": bool(emitted_waypoint[b]),
             "overflow": bool(overflow[b])}
            for b in range(nal.shape[0])]


# ---------------------------------------------------------------------------
# The 720p session streams (the per-session composer and its CLIs).
# ---------------------------------------------------------------------------

SESSION_GOLDEN_PATH = GOLDEN_PATH.parent / "session_720p.json"
# The scroll-encoder schedule: 64 frames at 4 px/frame from 496 px, up to
# height - 16 (it crosses the 496 px waypoint on its first frame).
SESSION_SCROLL = (64, 4, GOLDEN_HEIGHT - 16, 496)
SESSION_SLICED_OFFSETS = (100, 348)
SESSION_ROWS_PER_SLICE = 9
SESSION_HINT_FRAMES = 8
SESSION_HINT_SEED = 2000
SESSION_SPLICED_FRAMES = 2
# Offsets of the partitioned and nearest sessions: seams in MB rows 38-44
# (K1's second chunk of partitioned symbols) at 9, 40, 71 and 102, a
# waypoint at 496, and offsets past it.
SESSION_POLICY_OFFSETS = (9, 40, 71, 102, 133, 250, 380, 496, 503, 620, 700,
                          650, 24, 7, 300, 0)
HINT_STEP_BATCH = 256
HINT_STEP_SEED = 3000


def session_scroll_offsets() -> list:
    """The main session's scroll-encoder offsets (cli.triangle_offsets)."""
    from .cli import triangle_offsets

    n, speed, max_offset, start = SESSION_SCROLL
    return list(triangle_offsets(n, speed, max_offset, start_offset=start))


def hint_region_specs(k: int, mb_width: int, mb_height: int,
                      num_refs: int) -> list:
    """Seeded motion regions of hint frame k: 1-3 rects inside the frame,
    refs in the active list, MVs within the 496 px budget.  A list of
    (mb_x0, mb_y0, mb_x1, mb_y1, ref_idx, mv_x, mv_y) — MotionRegion's
    fields in order, for either package's class."""
    rng = np.random.default_rng(SESSION_HINT_SEED + k)
    specs = []
    for _ in range(int(rng.integers(1, 4))):
        x0 = int(rng.integers(0, mb_width - 1))
        y0 = int(rng.integers(0, mb_height - 1))
        x1 = int(rng.integers(x0 + 1, mb_width + 1))
        y1 = int(rng.integers(y0 + 1, mb_height + 1))
        specs.append((x0, y0, x1, y1, int(rng.integers(0, num_refs)),
                      int(rng.integers(-32, 33)), int(rng.integers(-120, 121))))
    return specs


def _splice_hints(k: int, motion_region, frame_hints):
    """FrameHints of spliced frame k: a scrolling band above the donor rect
    at bench.py's geometry."""
    band = motion_region(0, 1, 80, SPLICE_R0 - 1, 0, 0, 8 * (k + 1))
    return frame_hints(motion_regions=(band,), dynamic_mb_x=SPLICE_C0,
                       dynamic_mb_y=SPLICE_R0)


def drive_session(s, pkg, *, timed=None) -> None:
    """Script the main 720p session `s` (either package's ComposerSession):
    parameter sets, striped test atlases, the scroll-encoder schedule
    through write_scroll_or_waypoint_frame (each call through timed(fn)
    when given), two sliced frames, the hint frames and the spliced frames
    with representative donors.  `pkg` names that package's MotionRegion,
    FrameHints and fixtures module."""
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    for off in session_scroll_offsets():
        call = lambda off=off: s.write_scroll_or_waypoint_frame(off)
        timed(call) if timed else call()
    for off in SESSION_SLICED_OFFSETS:
        s.write_scroll_frame_sliced(off, SESSION_ROWS_PER_SLICE)
    for k in range(SESSION_HINT_FRAMES):
        specs = hint_region_specs(k, s.cfg.mb_width, s.cfg.mb_height,
                                  2 + s.waypoints.count)
        s.write_hint_frame(pkg.FrameHints(motion_regions=tuple(
            pkg.MotionRegion(*spec) for spec in specs)))
    for k in range(SESSION_SPLICED_FRAMES):
        grid = pkg.fixtures.representative_donor_grid(
            np.random.default_rng(SPLICE_DONOR_SEED + k), SPLICE_C, SPLICE_R)
        s.write_spliced_frame(_splice_hints(k, pkg.MotionRegion,
                                            pkg.FrameHints), grid)


def drive_policy_session(s) -> None:
    """A scroll session (either package's) over SESSION_POLICY_OFFSETS
    with composer semantics (write_scroll_frame)."""
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    for off in SESSION_POLICY_OFFSETS:
        s.write_scroll_frame(off)


# The 1920x1088 hint frame's regions (tests/test_hints.py's wide layout
# case), as hint_region_specs tuples.
LARGE_HINT_REGIONS = ((0, 0, 120, 12, 0, 0, 40), (20, 40, 60, 60, 1, 0, -16))


SESSION_STREAMS = ("session", "partitioned", "nearest", "scroll_encoder_cli",
                   "composer_cli", "hint_1080p", "scroll_4k")


def session_streams(pkg, workdir, names=SESSION_STREAMS,
                    **session_kw) -> dict:
    """Golden session streams composed by one package: {name: bytes} for
    `names` (of SESSION_STREAMS).  `pkg` names that package's
    ComposerConfig, ComposerSession, MotionRegion, FrameHints, fixtures,
    ipcm and cli; `session_kw` (the port's device) goes to every session,
    and as --device to the CLIs, which write their files into `workdir`."""
    from pathlib import Path

    workdir = Path(workdir)
    cfg = pkg.ComposerConfig(GOLDEN_WIDTH, GOLDEN_HEIGHT)
    dev_args = (["--device", str(session_kw["device"])]
                if "device" in session_kw else [])

    def main_session():
        s = pkg.ComposerSession(cfg, **session_kw)
        drive_session(s, pkg)
        return s.getvalue()

    def policy(name):
        s = pkg.ComposerSession(cfg, boundary_policy=name, **session_kw)
        drive_policy_session(s)
        return s.getvalue()

    def scroll_encoder_cli():
        enc = workdir / "scroll_encoder.h264"
        pkg.cli.scroll_encoder_main(["-n", "16", "-S", "31", "-w",
                                     str(cfg.width), "-H", str(cfg.height),
                                     "-o", str(enc)] + dev_args)
        return enc.read_bytes()

    def composer_cli():
        donors = []
        for name, color in (("a", (81, 90, 240)), ("b", (41, 240, 110))):
            d = pkg.ComposerSession(cfg, **session_kw)
            d.write_parameter_sets()
            d.writer.append_raw(pkg.ipcm.idr_frame_color(cfg, *color))
            donors.append(workdir / f"donor_{name}.h264")
            d.write_to_file(donors[-1])
        comp = workdir / "composer.h264"
        pkg.cli.composer_main(["--ref-a", str(donors[0]), "--ref-b",
                               str(donors[1]), "-n", "16", "-s", "31",
                               "--safe-mv", "-o", str(comp)] + dev_args)
        return comp.read_bytes()

    def hint_1080p():
        s = pkg.ComposerSession(pkg.ComposerConfig(1920, 1088), **session_kw)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        s.write_hint_frame(pkg.FrameHints(motion_regions=tuple(
            pkg.MotionRegion(*spec) for spec in LARGE_HINT_REGIONS)))
        return s.getvalue()

    def scroll_4k():
        s = pkg.ComposerSession(pkg.ComposerConfig(3840, 2160),
                                enable_pskip=True, **session_kw)
        s.write_parameter_sets()
        s.write_test_atlases(striped=True)
        s.write_scroll_frame(48)
        return s.getvalue()

    build = {"session": main_session,
             "partitioned": lambda: policy("partitioned"),
             "nearest": lambda: policy("nearest"),
             "scroll_encoder_cli": scroll_encoder_cli,
             "composer_cli": composer_cli, "hint_1080p": hint_1080p,
             "scroll_4k": scroll_4k}
    return {name: build[name]() for name in names}


# Hint frames whose NAL buffer passes a block's shared memory on the card
# (K1 builds the NAL in global memory): 3840x2160 at 64 bits per MB (NAL
# buffer 259,328 B) and 5120x3200 at the default 32 (256,128 B).
LARGE_GOLDEN_PATH = GOLDEN_PATH.parent / "large_frames.json"
LARGE_FRAMES = {"hint_3840x2160_64": (3840, 2160, 64),
                "hint_5120x3200": (5120, 3200, 32)}


def large_frame_stream(pkg, name: str, **session_kw) -> bytes:
    """One package's stream of LARGE_FRAMES[name]: parameter sets, the
    striped test atlases and one hint frame of LARGE_HINT_REGIONS."""
    w, h, bits = LARGE_FRAMES[name]
    s = pkg.ComposerSession(pkg.ComposerConfig(w, h, rbsp_bits_per_mb=bits),
                            **session_kw)
    s.write_parameter_sets()
    s.write_test_atlases(striped=True)
    s.write_hint_frame(pkg.FrameHints(motion_regions=tuple(
        pkg.MotionRegion(*spec) for spec in LARGE_HINT_REGIONS)))
    return s.getvalue()


def large_golden(pkg, names=tuple(LARGE_FRAMES), **session_kw) -> dict:
    """The large-frame digests composed by one package."""
    return {name: stream_digest(large_frame_stream(pkg, name, **session_kw))
            for name in names}


def stream_digest(data: bytes) -> dict:
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def hint_step_inputs(batch: int = HINT_STEP_BATCH) -> dict:
    """The batched hint step's inputs at 720p (numpy, int32 and bool):
    static chrome with one full-width vertical-scroll band per session, of
    seeded rows, reference and speed, over registries of 0-8 waypoints
    (so the reference lists, and te()'s width, differ per session)."""
    rng = np.random.default_rng(HINT_STEP_SEED)
    H, W = GOLDEN_HEIGHT // 16, GOLDEN_WIDTH // 16
    count = rng.integers(0, MAX_WAYPOINTS + 1, batch)
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    valid = slot < count[:, None]
    ref = np.zeros((batch, H, W), np.int32)
    mv_y = np.zeros((batch, H, W), np.int32)
    for b in range(batch):
        y0 = int(rng.integers(0, H - 8))
        y1 = int(rng.integers(y0 + 4, H + 1))
        ref[b, y0:y1] = rng.integers(0, 2 + count[b])
        mv_y[b, y0:y1] = 4 * rng.integers(-120, 121)
    return {"frame_num": rng.integers(2, 40, batch).astype(np.int32),
            "ref": ref, "mv_x": np.zeros_like(ref), "mv_y": mv_y,
            "wp_count": count.astype(np.int32),
            "wp_ltidx": np.where(valid, 2 + slot, 0).astype(np.int32),
            "wp_valid": valid}


def run_hint_step(step, inputs: dict):
    """step (either package's batched hint step) over hint_step_inputs."""
    return step(*(inputs[k] for k in ("frame_num", "ref", "mv_x", "mv_y",
                                      "wp_count", "wp_ltidx", "wp_valid")))


def hint_step_digest(nal, nal_len, overflow) -> dict:
    """Digest of a hint step's outputs (numpy): the sha256 of the sessions'
    valid bytes concatenated (what compact_batch_nal packs), their total,
    the sha256 of the int32 lengths, and whether any frame overflowed."""
    nal = np.asarray(nal)
    lens = np.asarray(nal_len).astype(np.int32)
    data = b"".join(nal[b, :lens[b]].tobytes() for b in range(len(lens)))
    return {"sha256": hashlib.sha256(data).hexdigest(), "total": len(data),
            "nal_len_sha256": hashlib.sha256(lens.tobytes()).hexdigest(),
            "overflow": bool(np.asarray(overflow).any())}


def session_golden_config() -> dict:
    return {"width": GOLDEN_WIDTH, "height": GOLDEN_HEIGHT,
            "scroll": list(SESSION_SCROLL),
            "sliced_offsets": list(SESSION_SLICED_OFFSETS),
            "rows_per_slice": SESSION_ROWS_PER_SLICE,
            "hint_frames": SESSION_HINT_FRAMES, "hint_seed": SESSION_HINT_SEED,
            "spliced_frames": SESSION_SPLICED_FRAMES,
            "policy_offsets": list(SESSION_POLICY_OFFSETS),
            "hint_step_batch": HINT_STEP_BATCH,
            "hint_step_seed": HINT_STEP_SEED}


def port_package():
    """The port's modules as session_streams' `pkg`."""
    import types

    from . import cli
    from .models import ipcm
    from .models.splice import FrameHints, MotionRegion
    from .session import ComposerSession
    from .utils import fixtures

    return types.SimpleNamespace(
        ComposerConfig=ComposerConfig, ComposerSession=ComposerSession,
        MotionRegion=MotionRegion, FrameHints=FrameHints, fixtures=fixtures,
        ipcm=ipcm, cli=cli)


def session_golden(pkg, hint_step, workdir, **session_kw) -> dict:
    """The session golden digests composed by one package: every stream of
    session_streams, and the batched hint step (compact_x) over
    hint_step_inputs — `hint_step` is that package's
    make_batched_hint_step(cfg, compact_x=True)."""
    out = {"config": session_golden_config()}
    for name, data in session_streams(pkg, workdir, **session_kw).items():
        out[name] = stream_digest(data)
    nal, nal_len, _bits, ovf = run_hint_step(hint_step, hint_step_inputs())
    out["hint_step"] = hint_step_digest(*(np.asarray(x.cpu()) if isinstance(
        x, torch.Tensor) else np.asarray(x) for x in (nal, nal_len, ovf)))
    return out


def port_session_golden(device="cuda", workdir=None) -> dict:
    """The session golden digests computed by the port on `device`, the
    CLIs writing into `workdir` (a temporary directory when None)."""
    import tempfile

    device = resolve_device(device)
    cfg = ComposerConfig(GOLDEN_WIDTH, GOLDEN_HEIGHT)
    step = batch.make_batched_hint_step(cfg, compact_x=True, device=device)
    if workdir is not None:
        return session_golden(port_package(), step, workdir, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        return session_golden(port_package(), step, tmp, device=device)
