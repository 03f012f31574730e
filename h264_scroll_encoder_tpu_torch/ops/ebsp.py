"""RBSP <-> EBSP emulation prevention, batched.

Port of h264_scroll_encoder_tpu/ops/ebsp.py.  The reference's serial
3-state zero-count automaton reduces to a closed form over t_i, the run of
zero bytes immediately before byte i:

  insert 0x03 before byte i  iff  b[i] <= 3 and t_i >= 2 and t_i even
  remove byte i              iff  b[i] == 3 and b[i+1] <= 3 and t_i >= 2

so emulation prevention is a running max (last nonzero index), a prefix
sum of insertions and one scatter.

Two device forms over [B, n] byte tensors:

  rbsp_to_ebsp          exact: the staged `ebsp_exact` retry path.
  rbsp_to_ebsp_bounded  the bounded rule of the fused emit kernel (K1,
                        ops/emit_fused): a byte whose zero run it cannot
                        resolve inside a 16-word window flags the frame.

plus numpy host versions for tests.
"""

from __future__ import annotations

import numpy as np
import torch

# K1's zero-run window, in 4-byte words (h264_scroll_encoder_tpu
# ops/emit_fused.EBSP_WINDOW_WORDS).
EBSP_WINDOW_WORDS = 16


def _zero_run_before(b, valid):
    """t[B, n]: number of consecutive zero bytes immediately before byte i."""
    n = b.shape[1]
    idx = torch.arange(n, device=b.device).expand(b.shape)
    nz = torch.where(valid & (b != 0), idx, -1)
    last_nz = torch.cummax(nz, dim=1).values
    last_nz_before = torch.cat([torch.full_like(last_nz[:, :1], -1),
                                last_nz[:, :-1]], dim=1)
    return idx - 1 - last_nz_before


def _insertion_flags(b, n):
    """(valid, t, ins) for bytes b[B, size] with n[B] valid bytes."""
    size = b.shape[1]
    idx = torch.arange(size, device=b.device)
    valid = idx[None, :] < n.to(torch.int64)[:, None]
    t = _zero_run_before(b, valid)
    ins = valid & (b <= 3) & (t >= 2) & (t % 2 == 0)
    return valid, t, ins


def _expand(b, valid, ins, max_out: int):
    """Scatter each valid byte to i + (insertions up to i) and 0x03 into
    the hole before each inserting byte; positions >= max_out drop."""
    B = b.shape[0]
    pos = torch.arange(b.shape[1], device=b.device) + torch.cumsum(
        ins.to(torch.int64), dim=1)
    out = torch.zeros((B, max_out + 1), dtype=torch.uint8, device=b.device)
    out.scatter_(1, torch.where(valid & (pos < max_out), pos, max_out), b)
    out.scatter_(1, torch.where(ins & (pos - 1 < max_out), pos - 1, max_out),
                 torch.full_like(b, 3))
    return out[:, :max_out]


def rbsp_to_ebsp(rbsp, n, max_out: int):
    """Insert emulation-prevention bytes, exactly.

    Args:
      rbsp: uint8[B, size] padded payloads.
      n: int[B] valid lengths.
      max_out: output capacity (worst case n + n//2).

    Returns (ebsp uint8[B, max_out], out_len int64[B]).
    """
    valid, _, ins = _insertion_flags(rbsp, n)
    out_len = n.to(torch.int64) + ins.sum(dim=1)
    return _expand(rbsp, valid, ins, max_out), out_len


def rbsp_to_ebsp_bounded(rbsp, n, max_out: int, max_insertions: int):
    """Emulation prevention with K1's bounded flag rule.

    Byte i (word k = i // 4, slot j = i % 4) is *unresolved* iff k >= 17
    and its zero run is >= 64 + j, i.e. the 16 words before its word and
    its own leading bytes are all zero — the run K1's 16-word window scan
    cannot see the start of.  Unresolved bytes never insert; any valid
    unresolved byte adds max_insertions + 1 to the count, so the frame
    flags overflow and the caller retries through the exact path.

    Returns (ebsp uint8[B, max_out], out_len int64[B]) where out_len =
    n + insertions (+ max_insertions + 1 when any byte is unresolved).
    """
    valid, t, ins = _insertion_flags(rbsp, n)
    i = torch.arange(rbsp.shape[1], device=rbsp.device)
    unresolved = (((i >> 2) > EBSP_WINDOW_WORDS)[None, :]
                  & (t >= 4 * EBSP_WINDOW_WORDS + (i & 3)[None, :]))
    ins = ins & ~unresolved
    sat = (valid & unresolved).any(dim=1)
    out_len = (n.to(torch.int64) + ins.sum(dim=1)
               + sat.to(torch.int64) * (max_insertions + 1))
    return _expand(rbsp, valid, ins, max_out), out_len


# ---------------------------------------------------------------------------
# Host (numpy) versions.
# ---------------------------------------------------------------------------

def _zero_run_before_np(b):
    n = b.shape[0]
    idx = np.arange(n, dtype=np.int64)
    nz = np.where(b != 0, idx, -1)
    last_nz = np.maximum.accumulate(nz)
    last_nz_before = np.concatenate([[-1], last_nz[:-1]])
    return idx - 1 - last_nz_before


def rbsp_to_ebsp_np(rbsp: np.ndarray) -> np.ndarray:
    b = np.asarray(rbsp, np.uint8)
    if b.size == 0:
        return b.copy()
    t = _zero_run_before_np(b)
    ins = (b <= 3) & (t >= 2) & (t % 2 == 0)
    out = np.empty(b.size + int(ins.sum()), np.uint8)
    pos = np.arange(b.size) + np.cumsum(ins)
    out[pos] = b
    out[pos[ins] - 1] = 3
    return out


def ebsp_to_rbsp_np(ebsp: np.ndarray) -> np.ndarray:
    b = np.asarray(ebsp, np.uint8)
    if b.size == 0:
        return b.copy()
    t = _zero_run_before_np(b)
    nxt = np.concatenate([b[1:], [0xFF]])
    has_next = np.arange(b.size) + 1 < b.size
    remove = (b == 3) & has_next & (nxt <= 3) & (t >= 2)
    return b[~remove]
