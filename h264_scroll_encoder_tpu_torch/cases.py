"""Seeded inputs and golden digests shared by the tests and chip_smoke.py.

The cases are plain numpy arrays, so the same inputs feed the JAX package
(in the tests), the port's plain PyTorch versions and the CUDA kernels
(on the card).  `golden/scroll_720p.json` holds the JAX package's output
digests for the 720p scroll schedule below, `golden/splice_rows_720p.json`
those of the 720p rows splice of seeded representative donors;
`port_golden` and `port_splice_golden` recompute them with the port on
any device.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from .config import ComposerConfig, MAX_EBSP_INSERTIONS, MAX_WAYPOINTS
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
