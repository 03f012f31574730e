"""Lockstep CAVLC residual-block decode of a batch of donor streams (P4).

Port of scripts/cavlc_device_probe.py, which asks whether the bit-serial
residual grammar (coeff_token, trailing-one signs, levels with the
adaptive suffix, total_zeros, run_before) can run on the accelerator
instead of the host: B donor lanes walk their own bitstreams in lockstep,
one residual block per lane a step, with a bit cursor per lane.  The
sequential dependency is per stream, so the batch supplies the
parallelism the grammar denies within a stream.

  build_luts()             the probe's peek-indexed tables, from the
                           port's ops/cavlc_tables (nc0 coeff_token, luma
                           4x4 total_zeros, run_before), with the probe's
                           packing: coeff_token len | tc << 5 | t1 << 10
                           (uint16), total_zeros and run_before len |
                           value << 4 (uint8).
  random_stream(rng, k)    the probe's k random blocks (the same draws),
                           through ops/cavlc: (bytes, truth).
  stream_batch(streams)    uint8 [B, longest + 8]: rows zero-padded.
  decode_lockstep_plain    the plain PyTorch decoder of the probe's body.
  decode_lockstep_batch    the plain version for CPU tensors, the CUDA
                           kernel h264t_cavlc_lockstep
                           (csrc/cavlc_lockstep.cu) for CUDA tensors.

The decode is the JAX probe's, level prefix clamped at 15 included, and
each lane's output per block is (total_coeff, trailing_ones, sum of the
levels, total_zeros, sum of the runs).  A peek reads the 8 bytes at
pos >> 3 of the lane's row; bytes past the row read as zero, so a lane
that runs off its stream (a corrupted one) reads zeros, in both versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from . import cavlc
from . import cavlc_tables as T
from .emit_fused import row_stride

NC_CLASS = "nc0"      # the coeff_token context class decoded (nC 0..1)
CT_PEEK, TZ_PEEK, RB_PEEK = 16, 9, 11
# The probe's lane count and blocks per stream, and its seed.
LANES, BLOCKS, SEED = 256, 256, 5


def _fill_prefix_lut(lut, code: str, value: int, peek_bits: int) -> None:
    lo = int(code, 2) << (peek_bits - len(code))
    lut[lo:lo + (1 << (peek_bits - len(code)))] = value


def build_luts():
    """(ct uint16[65536], tz uint8[15 * 512], rb uint8[7 * 2048]) numpy:
    ct[peek16] = len | tc << 5 | t1 << 10 (nc0); tz[(tc - 1) * 512 +
    peek9] = len | total_zeros << 4; rb[(min(zeros_left, 7) - 1) * 2048 +
    peek11] = len | run << 4; 0 where no code matches."""
    ct = np.zeros(1 << CT_PEEK, np.uint16)
    for code, (tc, t1) in T.coeff_token_decode_table(NC_CLASS).items():
        _fill_prefix_lut(ct, code, len(code) | (tc << 5) | (t1 << 10), CT_PEEK)
    tz = np.zeros(15 << TZ_PEEK, np.uint8)
    for tc in range(1, 16):
        row = tz[(tc - 1) << TZ_PEEK:tc << TZ_PEEK]
        for zeros, code in enumerate(T.total_zeros_codes(tc, 16)):
            _fill_prefix_lut(row, code, len(code) | (zeros << 4), TZ_PEEK)
    rb = np.zeros(7 << RB_PEEK, np.uint8)
    for zl in range(1, 8):
        row = rb[(zl - 1) << RB_PEEK:zl << RB_PEEK]
        for run, code in enumerate(T.run_before_codes(zl)):
            if zl < 7 and run > zl:
                break
            _fill_prefix_lut(row, code, len(code) | (run << 4), RB_PEEK)
    return ct, tz, rb


def device_luts(device):
    """build_luts() as tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device) for a in build_luts())


def encode_stream(blocks):
    """Blocks (levels in decode order, total_zeros, runs) written with nC
    0 and trailing bits: (bytes, truth [(tc, t1, sum levels, total_zeros,
    sum runs)]).  The bits are write_residual_block's (coeff_token, then
    the block's tail), joined as one bit string for speed."""
    bits = []
    truth = []
    for levels, zeros, runs in blocks:
        blk = (cavlc.encode_residual_block(levels, zeros, runs, 16, 0)
               if levels else cavlc.EMPTY_BLOCK)
        bits.append(T.coeff_token_code(0, blk.total_coeff, blk.trailing_ones))
        bits.append(blk.tail)
        truth.append((blk.total_coeff, blk.trailing_ones, sum(blk.levels),
                      blk.total_zeros, sum(blk.runs)))
    s = "".join(bits)
    s += "1" + "0" * (-(len(s) + 1) % 8)    # rbsp_trailing_bits
    return int(s, 2).to_bytes(len(s) // 8, "big"), truth


_SIGN = (-1, 1)


def random_blocks(rng, k: int):
    """The JAX probe's k random blocks, drawn in its order: tc in 0..16,
    t1 in 0..min(3, tc), signs, levels of 2..39, total_zeros, runs."""
    blocks = []
    for _ in range(k):
        tc = int(rng.integers(0, 17))
        if tc == 0:
            blocks.append(((), 0, ()))
            continue
        t1 = int(rng.integers(0, min(3, tc) + 1))
        # rng.choice([-1, 1]) draws integers(0, 2) and picks by it; drawn so
        # directly, at a fraction of choice's cost.
        levels = [_SIGN[rng.integers(0, 2)] for _ in range(t1)]
        levels += [_SIGN[rng.integers(0, 2)] * int(rng.integers(2, 40))
                   for _ in range(tc - t1)]
        zeros = int(rng.integers(0, 16 - tc + 1))
        runs, zl = [], zeros
        for _ in range(tc - 1):
            if zl <= 0:
                break
            r = int(rng.integers(0, zl + 1))
            runs.append(r)
            zl -= r
        blocks.append((tuple(levels), zeros, tuple(runs)))
    return blocks


def random_stream(rng, k: int):
    """The JAX probe's random_stream: (bytes, truth) of k random blocks."""
    return encode_stream(random_blocks(rng, k))


def stream_batch(streams) -> np.ndarray:
    """uint8 [B, longest + 8]: each stream zero-padded, so a lane's 8-byte
    peek never leaves its row while it decodes its own stream."""
    data = np.zeros((len(streams), max(map(len, streams)) + 8), np.uint8)
    for b, s in enumerate(streams):
        data[b, :len(s)] = np.frombuffer(s, np.uint8)
    return data


@functools.lru_cache(maxsize=4)
def _probe_streams(lanes: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    streams, truths = zip(*(random_stream(rng, k) for _ in range(lanes)))
    return (stream_batch(streams),
            np.asarray(truths, np.int32).reshape(lanes, k, 5),
            float(np.mean([len(s) * 8 / k for s in streams])))


def probe_streams(lanes: int = LANES, k: int = BLOCKS, seed: int = SEED):
    """The JAX probe's input: `lanes` random streams of k blocks from
    `seed`, drawn one after the other: (data uint8 [lanes, nbytes], truth
    int32 [lanes, k, 5], mean bits a block).  The draws (seconds of host
    time at 256 x 256) are cached; each call returns copies."""
    data, truth, bits = _probe_streams(lanes, k, seed)
    return data.copy(), truth.copy(), bits


def _windows(data):
    """(w0, w1) int64 [B, nbytes + 1]: bytes j..j+3 and j+4..j+7 of each
    row as big-endian 32-bit values, zeros past the row."""
    B, nbytes = data.shape
    d = torch.zeros((B, nbytes + 8), dtype=torch.int64, device=data.device)
    d[:, :nbytes] = data
    word = lambda o: ((d[:, o:o + nbytes + 1] << 24)  # noqa: E731
                      | (d[:, o + 1:o + nbytes + 2] << 16)
                      | (d[:, o + 2:o + nbytes + 3] << 8)
                      | d[:, o + 3:o + nbytes + 4])
    return word(0), word(4)


def decode_lockstep_plain(data, k: int, luts):
    """Plain PyTorch version of the lockstep decoder on data's device.

    Args:
      data: uint8 [B, nbytes] streams (stream_batch).
      k: residual blocks decoded per lane.
      luts: build_luts()'s three tables (numpy or tensors).

    Returns (end int32[B]: each lane's bit cursor after k blocks, out
    int32[B, k, 5]: total_coeff, trailing_ones, the sum of the levels,
    total_zeros and the sum of the runs of each block).
    """
    dev = data.device
    B, nbytes = data.shape
    ct, tzl, rbl = (torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                                    else t, device=dev).to(torch.int64)
                    for t in luts)
    w0, w1 = _windows(data.to(torch.int64))
    # clz(x) >= p iff x < 2 ** (32 - p): 15 - (the count of these bounds
    # at or below x) is clz(x) clamped at 15.
    clz_bounds = torch.tensor([1 << b for b in range(17, 32)], device=dev)

    def peek(pos):
        j = torch.clamp(pos >> 3, max=nbytes)[:, None]
        s = pos & 7
        return (((w0.gather(1, j)[:, 0] << s) | (w1.gather(1, j)[:, 0] >> (32 - s)))
                & 0xFFFFFFFF)

    def bits(pk, off, n):
        shifted = (pk << off) & 0xFFFFFFFF
        return torch.where(n > 0, shifted >> (32 - torch.clamp(n, min=1)), 0)

    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    out = torch.zeros((B, k, 5), dtype=torch.int64, device=dev)
    for blk in range(k):
        rec = ct[peek(pos) >> 16]
        tc, t1 = (rec >> 5) & 31, (rec >> 10) & 3
        pos = pos + (rec & 31)
        pk = peek(pos)
        lsum = torch.zeros_like(tc)
        for i in range(3):
            bit = (pk >> (31 - i)) & 1
            lsum = lsum + torch.where(i < t1, 1 - 2 * bit, 0)
        pos = pos + t1
        sl = ((tc > 10) & (t1 < 3)).to(torch.int64)
        for i in range(16):
            active = i < tc - t1
            pk = peek(pos)
            prefix = 15 - torch.bucketize(pk, clz_bounds, right=True)
            lc = prefix << sl
            ssz = torch.where((prefix == 14) & (sl == 0), 4, sl)
            lc = lc + torch.where((prefix == 15) & (sl == 0), 15, 0)
            ssz = torch.where(prefix == 15, 12, ssz)
            lc = lc + bits(pk, prefix + 1, ssz)
            if i == 0:
                lc = lc + torch.where(t1 < 3, 2, 0)
            level = torch.where(lc % 2 == 0, lc // 2 + 1, -((lc + 1) // 2))
            lsum = lsum + torch.where(active, level, 0)
            sl_new = torch.clamp(sl, min=1)
            grow = (level.abs() > (3 << torch.clamp(sl_new - 1, min=0))) & (sl_new < 6)
            sl = torch.where(active, sl_new + grow.to(torch.int64), sl)
            pos = pos + torch.where(active, prefix + 1 + ssz, 0)
        pk = peek(pos)
        has_tz = (tc > 0) & (tc < 16)
        rec = tzl[((torch.clamp(tc, 1, 15) - 1) << TZ_PEEK) + (pk >> 23)]
        zeros = torch.where(has_tz, rec >> 4, 0)
        pos = pos + torch.where(has_tz, rec & 15, 0)
        zl, rsum = zeros, torch.zeros_like(zeros)
        for i in range(15):
            active = (i < tc - 1) & (zl > 0)
            pk = peek(pos)
            rec = rbl[((torch.clamp(zl, 1, 7) - 1) << RB_PEEK) + (pk >> 21)]
            run = torch.where(active, rec >> 4, 0)
            pos = pos + torch.where(active, rec & 15, 0)
            zl, rsum = zl - run, rsum + run
        out[:, blk] = torch.stack([tc, t1, lsum, zeros, rsum], dim=1)
    return pos.to(torch.int32), out.to(torch.int32)


def check_luts(luts, device) -> None:
    """The kernel's tables: build_luts()'s dtypes and sizes on `device`."""
    want = ((torch.uint16, 1 << CT_PEEK), (torch.uint8, 15 << TZ_PEEK),
            (torch.uint8, 7 << RB_PEEK))
    for name, t, (dtype, n) in zip(("ct", "tz", "rb"), luts, want):
        if (not torch.is_tensor(t) or t.dtype != dtype or t.shape != (n,)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"the {name} table must be a contiguous {dtype}"
                             f"[{n}] tensor on {device} (device_luts)")


def decode_lockstep_batch(data, k: int, luts):
    """The lockstep decoder over a [B, nbytes] batch: the plain version
    for CPU tensors, the CUDA kernel (one thread a lane) for CUDA tensors;
    a build or launch failure raises.  On the card `data` is uint8 with
    unit stride along each row and `luts` are device_luts(data.device).
    Returns as decode_lockstep_plain."""
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8 [B, nbytes], not {data.dtype}"
                         f"{tuple(data.shape)}")
    if k < 0:
        raise ValueError(f"k must be >= 0, not {k}")
    if data.device.type == "cpu":
        return decode_lockstep_plain(data, k, luts)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    check_luts(luts, data.device)
    B, nbytes = data.shape
    end = torch.empty((B,), dtype=torch.int32, device=data.device)
    out = torch.empty((B, k, 5), dtype=torch.int32, device=data.device)
    if B:
        with torch.cuda.device(data.device):
            _kernels.CAVLC_LOCKSTEP.launch(
                data.data_ptr(), row_stride(data), nbytes, B, k,
                *(t.data_ptr() for t in luts), end.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(data.device).cuda_stream)
    return end, out
