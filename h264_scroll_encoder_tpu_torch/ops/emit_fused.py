"""Fused emit back end (K1): symbols -> framed Annex-B NAL in one kernel.

Port of h264_scroll_encoder_tpu/ops/emit_fused.py.  Per session, from raw
(pattern, nbits) symbols:

  1. `align`: each I_PCM alignment sentinel (nbits < 0) becomes
     (-pos) mod 8 zero bits at its running bit position.  Without `align`
     a sentinel is out of contract: it packs as zero bits and the frame
     flags overflow.  (The JAX kernel packs it as a huge width and raises
     no flag; the port deliberately does not copy that.)
  2. `append_tb`: the rbsp_trailing_bits symbol follows the last symbol.
  3. MSB-first pack into big-endian words (ops/bitpack.pack_words).
  4. Bounded emulation prevention with K1's 16-word zero-run window
     (ops/ebsp.rbsp_to_ebsp_bounded): a frame with more than `cap`
     insertions, or a zero run the window cannot resolve, flags overflow
     for the caller's exact-path retry.
  5. Annex-B framing: 00 00 00 01, the NAL header byte from nal_ref_idc
     (type 1, coded slice), then the escaped payload; zeros after.

`emit_nal_fused_plain` is the plain PyTorch version of that contract.
`emit_nal_fused_batch` runs it for CPU tensors and launches the CUDA
kernel `h264t_emit_fused` (csrc/emit_kernels.cu) for CUDA tensors, on
the int64 (or int32) symbols as they are: no conversion pass first.
Bytes of flagged frames are unspecified beyond being deterministic; the
kernel and the plain version agree on every output of every frame.
"""

from __future__ import annotations

import numbers

import torch

from .. import _kernels
from .bitpack import pack_words, trailing_bits_symbol, words_to_bytes
from .ebsp import rbsp_to_ebsp_bounded

# The most symbols a thread of K1 or K2/K4 owns per staged chunk: it caps
# the staging area at 8 B * 24 * _kernels.PACK_THREADS = 96 KB a block.
PACK_MAX_ITEMS = 24
# Symbol dtypes the kernels read in place.
SYMBOL_DTYPES = (torch.int64, torch.int32)


def nal_bytes(n_rbsp: int, cap: int) -> int:
    """NAL buffer size for an RBSP budget and insertion cap
    (h264_scroll_encoder_tpu ops/emit_fused.finish_nal_fused)."""
    return (5 + n_rbsp + cap + 11) // 4 * 4


def _resolve_align(nbits):
    """Replace each negative sentinel by (-pos) mod 8 at its running bit
    position: the phase before lane i is the sum of widths since the last
    sentinel before it, mod 8."""
    is_align = nbits < 0
    widths = torch.where(is_align, 0, nbits)
    incl = torch.cumsum(widths, dim=1)
    idx = torch.arange(nbits.shape[1], device=nbits.device).expand(nbits.shape)
    last = torch.cummax(torch.where(is_align, idx, -1), dim=1).values
    last_before = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    since = incl - widths - torch.where(
        last_before >= 0, torch.gather(incl, 1, last_before.clamp(min=0)), 0)
    return torch.where(is_align, (8 - (since & 7)) & 7, nbits)


def nal_prefix(nal_ref_idc, batch: int, device):
    """Annex-B start code plus the NAL header byte (coded slice, the given
    nal_ref_idc): uint8[batch, 5]."""
    idc = torch.as_tensor(nal_ref_idc, device=device).to(torch.int64)
    header = ((idc & 3) << 5) | 1
    prefix = torch.zeros((batch, 5), dtype=torch.int64, device=device)
    prefix[:, 3] = 1
    prefix[:, 4] = header.expand(batch)
    return prefix.to(torch.uint8)


def emit_nal_fused_plain(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False):
    """Plain PyTorch version of K1 on any device.

    Args:
      patterns: int[B, n] symbol patterns (uint32 values).
      nbits: int[B, n] widths in [0, 32]; negative = alignment sentinel.
      nal_ref_idc: int or int[B].
      n_rbsp: RBSP budget in bytes (frames above it flag overflow).
      cap: emulation-prevention insertion cap.

    Returns (nal u8[B, n_nal], nal_len i32[B], total_bits i32[B],
    overflow bool[B]) with n_nal = nal_bytes(n_rbsp, cap).
    """
    patterns = patterns.to(torch.int64)
    nbits = nbits.to(torch.int64)
    B = nbits.shape[0]
    n_nal = nal_bytes(n_rbsp, cap)
    if align:
        nbits = _resolve_align(nbits)
        bad = torch.zeros(B, dtype=torch.bool, device=nbits.device)
    else:
        bad = (nbits < 0).any(dim=1)
        nbits = nbits.clamp(min=0)
    if append_tb:
        tb_pat, tb_n = trailing_bits_symbol(nbits.sum(dim=1))
        patterns = torch.cat([patterns, tb_pat[:, None]], dim=1)
        nbits = torch.cat([nbits, tb_n[:, None]], dim=1)

    words, total_bits = pack_words(patterns, nbits, n_nal // 4)
    rbsp_len = total_bits >> 3
    ebsp, ebsp_len = rbsp_to_ebsp_bounded(words_to_bytes(words), rbsp_len,
                                          n_nal - 5, cap)
    nal = torch.cat([nal_prefix(nal_ref_idc, B, nbits.device), ebsp],
                    dim=1)
    overflow = (total_bits > n_rbsp * 8) | (ebsp_len - rbsp_len > cap) | bad
    return (nal, (5 + ebsp_len).to(torch.int32), total_bits.to(torch.int32),
            overflow)


def check_symbols(patterns, nbits):
    """Raise unless patterns and nbits are [B, n] tensors of one dtype,
    int64 (as the symbol stage makes them) or int32, on one CPU or CUDA
    device.  Nothing is converted: any other dtype raises."""
    if patterns.dim() != 2 or patterns.shape != nbits.shape:
        raise ValueError(f"patterns {tuple(patterns.shape)} and nbits "
                         f"{tuple(nbits.shape)} must both be [B, n]")
    if patterns.dtype not in SYMBOL_DTYPES or nbits.dtype != patterns.dtype:
        raise TypeError(f"patterns ({patterns.dtype}) and nbits ({nbits.dtype}) "
                        "must both be int64 or both int32")
    if patterns.device != nbits.device:
        raise ValueError("patterns and nbits must be on one device")
    if patterns.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {patterns.device}")


def items_per_thread(n: int) -> int:
    """Symbols each of the _kernels.PACK_THREADS threads of K1 and K2/K4
    owns per staged chunk, for n symbols per session (the kernels take it
    as an argument)."""
    return min(max(-(-n // _kernels.PACK_THREADS), 1), PACK_MAX_ITEMS)


def row_stride(x) -> int:
    """Row stride of a [B, n] CUDA tensor the kernels read in place; they
    need unit stride along each row."""
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"the kernels need unit stride along each row, "
                         f"not strides {tuple(x.stride())}")
    return x.stride(0)


def emit_nal_fused_batch(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False):
    """K1 over a [B, n] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  Same
    arguments and returns as emit_nal_fused_plain; patterns and nbits are
    int64 or int32, and the kernel reads them as they are."""
    check_symbols(patterns, nbits)
    if patterns.device.type == "cpu":
        return emit_nal_fused_plain(patterns, nbits, nal_ref_idc, n_rbsp, cap,
                                    align=align, append_tb=append_tb)
    dev = patterns.device
    B, n = patterns.shape
    n_nal = nal_bytes(n_rbsp, cap)
    if isinstance(nal_ref_idc, numbers.Integral):
        idc, idc_row, idc_value = None, 0, int(nal_ref_idc)
    else:
        idc = torch.as_tensor(nal_ref_idc, device=dev)
        if idc.dtype != torch.int64:
            idc = idc.to(torch.int64)
        idc = idc.reshape(-1).expand(B)
        idc_row, idc_value = idc.stride(0), 0
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    meta = torch.empty((2, B), dtype=torch.int32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        with torch.cuda.device(dev):
            k = items_per_thread(n)
            # Large frames: the RBSP words in global scratch, and past that
            # the NAL built in place in `nal` (the kernel's plan; see the .cu).
            plan = _kernels.emit_plan(patterns.element_size(), k, n_nal)
            scratch = (torch.empty((B, n_nal // 4), dtype=torch.int32,
                                   device=dev)
                       if plan.words_in_global else None)
            _kernels.EMIT_FUSED.launch(
                patterns.data_ptr(), nbits.data_ptr(), patterns.element_size(),
                row_stride(patterns), row_stride(nbits),
                None if idc is None else idc.data_ptr(), idc_row, idc_value,
                B, n, k, n_nal, n_rbsp, cap, int(align), int(append_tb),
                None if scratch is None else scratch.data_ptr(),
                int(plan.nal_in_global),
                nal.data_ptr(), meta[0].data_ptr(), meta[1].data_ptr(),
                overflow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return nal, meta[0], meta[1], overflow


def finish_nal_fused(patterns, nbits, n_rbsp: int, nal_ref_idc, *,
                     max_insertions: int, has_align: bool = False,
                     append_trailing: bool = False):
    """The bounded back end of models/scroll.finish_slice: returns
    (nal u8[B, n_nal], nal_len, total_bits, overflow), byte-identical to
    the JAX package's for in-contract frames."""
    return emit_nal_fused_batch(patterns, nbits, nal_ref_idc, n_rbsp,
                                max_insertions, align=has_align,
                                append_tb=append_trailing)
