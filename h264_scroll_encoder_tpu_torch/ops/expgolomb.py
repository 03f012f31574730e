"""Closed-form Exp-Golomb coding as (pattern, nbits) symbol pairs.

Port of h264_scroll_encoder_tpu/ops/expgolomb.py.  ue(v) codeword =
[M zeros][1][INFO] with M = floor(log2(v+1)); writing the (2M+1)-bit value
v+1 reproduces it exactly.  se maps v>0 -> 2v-1, v<=0 -> -2v, then ue.
te (truncated Exp-Golomb for ref_idx) is one inverted bit when two values
are possible, zero bits for one, else ue.

Patterns are int64 tensors holding uint32 values (wrapped mod 2**32 where
the JAX version relies on uint32 wrap); nbits are int64.  Every function
works on any shape.
"""

from __future__ import annotations

import torch

from .bitpack import U32


def _ilog2(x):
    """floor(log2(x)) for 1 <= x < 2**32 by exact binary search; -1 for
    x == 0 (the JAX version's 31 - clz(0))."""
    x = x.to(torch.int64)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        m = x >= (1 << s)
        r = r + m * s
        x = torch.where(m, x >> s, x)
    return r - (x == 0).to(torch.int64)


def ue(v):
    """Unsigned Exp-Golomb: (pattern = v+1 mod 2**32, nbits = 2*floor(log2(v+1))+1)."""
    vp1 = (torch.as_tensor(v).to(torch.int64) + 1) & U32
    return vp1, 2 * _ilog2(vp1) + 1


def se_mapped(v):
    """Signed value -> unsigned Exp-Golomb domain (int32 wrap semantics)."""
    v = torch.as_tensor(v).to(torch.int64)
    return torch.where(v > 0, 2 * v - 1, -2 * v) & U32


def se(v):
    """Signed Exp-Golomb: (pattern, nbits)."""
    return ue(se_mapped(v))


def te(v, num_values):
    """Truncated Exp-Golomb for ref_idx given `num_values` possible values
    (broadcastable against v, e.g. [B, 1] per-session counts).

    num_values == 1: zero bits; == 2: one inverted bit; > 2: ue(v).
    """
    v = torch.as_tensor(v).to(torch.int64) & U32
    num_values = torch.as_tensor(num_values, device=v.device).to(torch.int64)
    ue_pat, ue_n = ue(v)
    one_bit_pat = 1 - (v & 1)
    pat = torch.where(num_values <= 2, one_bit_pat, ue_pat)
    nbits = torch.where(num_values <= 1, 0,
                        torch.where(num_values == 2, 1, ue_n))
    return pat, nbits


def ue_bit_length(v):
    """Bit length of ue(v) without the pattern."""
    v = torch.as_tensor(v).to(torch.int64) & U32
    return 2 * _ilog2((v + 1) & U32) + 1
