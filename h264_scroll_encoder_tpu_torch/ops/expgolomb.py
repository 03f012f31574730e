"""Closed-form Exp-Golomb coding as (pattern, nbits) symbol pairs.

Port of h264_scroll_encoder_tpu/ops/expgolomb.py.  ue(v) codeword =
[M zeros][1][INFO] with M = floor(log2(v+1)); writing the (2M+1)-bit value
v+1 reproduces it exactly.  se maps v>0 -> 2v-1, v<=0 -> -2v, then ue.
te (truncated Exp-Golomb for ref_idx) is one inverted bit when two values
are possible, zero bits for one, else ue.

Widths, here and in every symbol stage of the port, are the JAX
package's (it runs without jax_enable_x64):
  - jnp.int32 is torch.int32, and jnp.uint32 is torch.int32 holding the
    same 32 bits (torch has no uint32 arithmetic); bool and uint8 stay.
    So patterns are int32 bit patterns (v + 1 and 2v - 1 wrap in 32 bits
    as the JAX uint32 and int32 do) and nbits are int32.
  - A logical right shift of a bit pattern goes through
    ops/bitpack.lsr32; a widening for unsigned meaning is local
    (`x.to(torch.int64) & U32`, then narrowed back).
  - Integer reductions pass dtype=torch.int32 where the JAX result is
    int32 (torch's cumsum and sum promote to int64), and arange, zeros
    and full name their dtype.
  - An index tensor is int64 only at the op that consumes it (gather,
    scatter_), never carried at grid size between ops.
Every function works on any shape.
"""

from __future__ import annotations

import torch

from .bitpack import as_u32_bits


def _ilog2(x):
    """floor(log2(x)) of uint32 bits x (int32) by exact binary search; -1
    for x == 0 (the JAX version's 31 - clz(0))."""
    x = as_u32_bits(x)
    # The top half by a logical shift, so that bit 31 counts as a bit and
    # the steps below see non-negative values.
    hi = (x >> 16) & 0xFFFF
    m = hi != 0
    r = m.to(torch.int32) << 4
    x = torch.where(m, hi, x)
    for s in (8, 4, 2, 1):
        m = x >= (1 << s)
        r = torch.add(r, m, alpha=s)
        x = torch.where(m, x >> s, x)
    return torch.add(r, x == 0, alpha=-1)


def ue(v):
    """Unsigned Exp-Golomb: (pattern = v+1 mod 2**32, nbits = 2*floor(log2(v+1))+1)."""
    vp1 = as_u32_bits(v) + 1
    return vp1, 2 * _ilog2(vp1) + 1


def se_mapped(v):
    """Signed value -> unsigned Exp-Golomb domain (int32 wrap semantics)."""
    v = as_u32_bits(v)
    return torch.where(v > 0, 2 * v - 1, -2 * v)


def se(v):
    """Signed Exp-Golomb: (pattern, nbits)."""
    return ue(se_mapped(v))


def te(v, num_values):
    """Truncated Exp-Golomb for ref_idx given `num_values` possible values
    (broadcastable against v, e.g. [B, 1] per-session counts).

    num_values == 1: zero bits; == 2: one inverted bit; > 2: ue(v).
    """
    v = as_u32_bits(v)
    if isinstance(num_values, int):
        # Filled on the device: a CUDA graph captures the fill, where it
        # refuses a host copy.
        num_values = torch.full((), num_values, dtype=torch.int32,
                                device=v.device)
    num_values = as_u32_bits(torch.as_tensor(num_values, device=v.device))
    ue_pat, ue_n = ue(v)
    one_bit_pat = 1 - (v & 1)
    pat = torch.where(num_values <= 2, one_bit_pat, ue_pat)
    nbits = torch.where(num_values <= 1, 0,
                        torch.where(num_values == 2, 1, ue_n))
    return pat, nbits


def ue_bit_length(v):
    """Bit length of ue(v) without the pattern."""
    return 2 * _ilog2(as_u32_bits(v) + 1) + 1
