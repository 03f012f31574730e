"""Seeded inputs and golden digests shared by the tests and chip_smoke.py.

The cases are plain numpy arrays, so the same inputs feed the JAX package
(in the tests), the port's plain PyTorch versions and the CUDA kernels
(on the card).  `golden/scroll_720p.json` holds the JAX package's output
digests for the 720p schedule below; `port_golden` recomputes them with
the port on any device.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from .config import ComposerConfig, MAX_EBSP_INSERTIONS
from .models import scroll
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


def _bytes_to_symbols(vals):
    n_payload = len(vals)
    patterns = np.zeros(N_SYM, np.uint32)
    nbits = np.zeros(N_SYM, np.int32)
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


def port_golden(device="cpu") -> dict:
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
