"""Bit packing of (pattern, nbits) symbol streams into big-endian words.

Port of the scatter form of h264_scroll_encoder_tpu/ops/bitpack.py: a
frame's syntax elements arrive as fixed-shape symbol arrays (nbits == 0
marks an absent slot) and pack MSB-first into big-endian uint32 words.
`pack_words` is the plain reference for both CUDA kernels (K1 in
ops/emit_fused, K2 in ops/bitpack_flat).  The JAX package's tree, gather,
place and monotone packers are TPU formulations of the same function and
are not ported.

All functions take a leading session dimension: patterns/nbits are
[B, n].  Words are int64 tensors holding uint32 values.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def bit_offsets(nbits):
    """Exclusive prefix sum of symbol bit lengths along dim 1, plus the
    per-session total: ([B, n], [B])."""
    nbits = nbits.to(torch.int64)
    incl = torch.cumsum(nbits, dim=1)
    total = incl[:, -1] if nbits.shape[1] else nbits.new_zeros(nbits.shape[0])
    return incl - nbits, total


def _mask_patterns(patterns, nbits):
    """Keep only the low nbits bits of each pattern (nbits >= 32: all)."""
    width = nbits.clamp(0, 31)
    mask = torch.where(nbits >= 32, U32, (1 << width) - 1)
    return patterns.to(torch.int64) & mask


def pack_words(patterns, nbits, num_words: int, start_bit: int = 0):
    """Pack symbols into big-endian uint32 words.

    Args:
      patterns: int64[B, n] codeword patterns (only the low nbits bits used).
      nbits:    int[B, n] codeword lengths in [0, 32].
      num_words: output word count (words beyond the stream are 0; bits
        beyond num_words are dropped).
      start_bit: bit offset at which the first symbol starts.

    Returns (words int64[B, num_words], total_bits int64[B]) — total_bits
    excludes start_bit.
    """
    nbits = nbits.to(torch.int64)
    patterns = _mask_patterns(patterns, nbits)
    offsets, total = bit_offsets(nbits)
    offsets = offsets + start_bit

    bit_in_word = offsets & 31
    w0 = offsets >> 5
    # Split each symbol into the part landing in word w0 (n0 bits) and the
    # spill into w0 + 1 (n1 bits).
    n0 = torch.minimum(nbits, 32 - bit_in_word)
    n1 = nbits - n0
    sh0 = (32 - bit_in_word - n0).clamp(0, 31)
    c0 = torch.where(nbits > 0, ((patterns >> n1.clamp(0, 31)) << sh0) & U32, 0)
    m1 = (1 << n1.clamp(0, 31)) - 1
    sh1 = (32 - n1).clamp(1, 32) & 31
    c1 = torch.where(n1 > 0, ((patterns & m1) << sh1) & U32, 0)

    # Scatter-add with out-of-range words dropped into a spill column.
    B = patterns.shape[0]
    words = patterns.new_zeros((B, num_words + 1))
    for w, c in ((w0, c0), (w0 + 1, c1)):
        idx = torch.where((w >= 0) & (w < num_words), w, num_words)
        words.scatter_add_(1, idx, c)
    return words[:, :num_words] & U32, total


def words_to_bytes(words):
    """Big-endian uint32 words [..., W] -> uint8 bytes [..., 4W]."""
    words = words.to(torch.int64)
    b = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                     (words >> 8) & 0xFF, words & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(*words.shape[:-1], -1)


def pack_bytes(patterns, nbits, num_bytes: int):
    """Pack symbols straight to a padded byte buffer (`num_bytes` a
    multiple of 4): (uint8[B, num_bytes], total_bits[B])."""
    if num_bytes % 4:
        raise ValueError("num_bytes must be a multiple of 4")
    words, total = pack_words(patterns, nbits, num_bytes // 4)
    return words_to_bytes(words), total


def merge_symbol_pairs(p1, n1, p2, n2):
    """Concatenate two codes per lane: (p1,n1)||(p2,n2), total <= 32 bits."""
    return ((p1 << n2.clamp(0, 31)) | p2) & U32, n1 + n2


def trailing_bits_symbol(total_bits):
    """rbsp_trailing_bits as one symbol appended at `total_bits`: a stop
    '1' bit plus zero padding to the next byte boundary."""
    total_bits = total_bits.to(torch.int64)
    nbits = 1 + ((8 - ((total_bits + 1) % 8)) % 8)
    return 1 << (nbits - 1), nbits
