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
The kernel reads int32 (or int64) symbols as they are and writes what
the plain version returns and the JAX package's kernels write: 32-bit
words (uint32 bits in an int32 tensor) and int32 totals.  The TPU merge tree is
not carried over.  Past one block's shared memory (the exact retry of
frames past about 33,500 MBs) a session runs on a thread-block cluster,
as K1's (ops/emit_fused); `pack_words_split_plain` is the pack computed
from the cluster's shares.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bitpack import pack_words
from .emit_fused import (check_symbols, items_per_thread, launch_geometry,
                         pack_split, row_stride)


def pack_words_place_plain(patterns, nbits, num_words: int):
    """Plain PyTorch version of K2 on any device: (words int32[B,
    num_words] holding uint32 bits, total_bits int32[B])."""
    return pack_words(patterns, nbits, num_words)


def pack_words_split_plain(patterns, nbits, num_words: int, parts: int = 1):
    """K2's contract computed as the cluster plan computes it, from
    `parts` contiguous shares (ops/emit_fused.pack_split); equals
    pack_words_place_plain for widths in [0, 32]."""
    words, total, _bad = pack_split(patterns, nbits, num_words, parts)
    return words, total


def pack_words_place_batch(patterns, nbits, num_words: int, *,
                           cluster: int | None = None):
    """K2 over a [B, n] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  `cluster`
    (tests only) forces the blocks a session, as in
    ops/emit_fused.emit_nal_fused_batch."""
    return _batch(patterns, nbits, num_words, _kernels.PACK_PLACE, cluster)


def pack_words_batch(patterns, nbits, num_words: int):
    """K4 over a [B, n] batch (the port of `pack_words_pallas`): the plain
    version (pack_words_place_plain) for CPU tensors, the CUDA kernel for
    CUDA tensors.  Returns (words int32[B, num_words] holding uint32 bits,
    total_bits int32[B])."""
    return _batch(patterns, nbits, num_words, _kernels.PACK_WORDS)


def _batch(patterns, nbits, num_words: int, kernel, cluster=None):
    check_symbols(patterns, nbits)
    if patterns.device.type == "cpu":
        return pack_words_place_plain(patterns, nbits, num_words)
    return launch_kernel(patterns, nbits, num_words, kernel, cluster)


def launch_kernel(pat, nb, num_words: int, kernel=_kernels.PACK_PLACE,
                  cluster: int | None = None):
    """Launch K2 (or K4, the same block: kernel=_kernels.PACK_WORDS) on
    int32 or int64 CUDA tensors pat[B, n] (uint32 bit patterns in the low
    32 bits) and nb[B, n], read as they are: (words int32[B, num_words]
    holding uint32 bits, total_bits int32[B]).  One block a session, or
    the cluster plan where the library's plan (or `cluster`) says so."""
    dev = pat.device
    B, n = pat.shape
    words = torch.empty((B, num_words), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            c, k = launch_geometry(
                lambda: _kernels.pack_plan(pat.element_size(), n,
                                           items_per_thread(n), num_words),
                n, cluster)
            kernel.launch(
                pat.data_ptr(), nb.data_ptr(), pat.element_size(),
                row_stride(pat), row_stride(nb), B, n, k, num_words, c,
                words.data_ptr(), total.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return words, total
