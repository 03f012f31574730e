"""Batched bit packs (K2, K4).

Port of h264_scroll_encoder_tpu/ops/bitpack_flat.py: (patterns,
nbits)[B, n] -> (words[B, num_words], total_bits[B]), bit-exact with
ops/bitpack.pack_words for widths in [0, 32] (bits past num_words drop).

  K2  `pack_words_place_batch` — the direct-placement pack
      (`pack_words_place_pallas`, Pallas kernels `_pack_kernel3` and
      `_place_kernel`) of the staged exact-EBSP path.
  K4  `pack_words_batch` — the merge-tree pack (`pack_words_pallas`,
      Pallas kernel `_pack_kernel`), the same function by another TPU
      algorithm.

Both run one batched CUDA block per session (csrc/emit_kernels.cu, K1's
pack stage on its own): `h264t_pack_place` for K2 and `h264t_pack_words`,
the same block behind its own entry point and launch counter, for K4.
The kernel reads int64 (or int32) symbols as they are and writes the
int64 words and totals the plain version returns.  The TPU merge tree is
not carried over.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bitpack import pack_words
from .emit_fused import check_symbols, items_per_thread, row_stride


def pack_words_place_plain(patterns, nbits, num_words: int):
    """Plain PyTorch version of K2 on any device: (words int64[B,
    num_words] holding uint32 values, total_bits int64[B])."""
    return pack_words(patterns, nbits, num_words)


def pack_words_place_batch(patterns, nbits, num_words: int):
    """K2 over a [B, n] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises)."""
    return _batch(patterns, nbits, num_words, _kernels.PACK_PLACE)


def pack_words_batch(patterns, nbits, num_words: int):
    """K4 over a [B, n] batch (the port of `pack_words_pallas`): the plain
    version (pack_words_place_plain) for CPU tensors, the CUDA kernel for
    CUDA tensors.  Returns (words int64[B, num_words], total_bits
    int64[B])."""
    return _batch(patterns, nbits, num_words, _kernels.PACK_WORDS)


def _batch(patterns, nbits, num_words: int, kernel):
    check_symbols(patterns, nbits)
    if patterns.device.type == "cpu":
        return pack_words_place_plain(patterns, nbits, num_words)
    return launch_kernel(patterns, nbits, num_words, kernel)


def launch_kernel(pat, nb, num_words: int, kernel=_kernels.PACK_PLACE):
    """Launch K2 (or K4, the same block: kernel=_kernels.PACK_WORDS) on
    int64 or int32 CUDA tensors pat[B, n] (uint32 bit patterns in the low
    32 bits) and nb[B, n], read as they are: (words int64[B, num_words]
    holding uint32 values, total_bits int64[B])."""
    dev = pat.device
    B, n = pat.shape
    words = torch.empty((B, num_words), dtype=torch.int64, device=dev)
    total = torch.empty((B,), dtype=torch.int64, device=dev)
    if B:
        with torch.cuda.device(dev):
            k = items_per_thread(n)
            # Large frames: the words packed in global scratch (see the .cu).
            scratch = (torch.empty((B, num_words), dtype=torch.int32,
                                   device=dev)
                       if _kernels.pack_words_in_global(pat.element_size(), k,
                                                        num_words) else None)
            kernel.launch(
                pat.data_ptr(), nb.data_ptr(), pat.element_size(),
                row_stride(pat), row_stride(nb), B, n, k, num_words,
                None if scratch is None else scratch.data_ptr(),
                words.data_ptr(), total.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return words, total
