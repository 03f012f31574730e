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
kernel `h264t_emit_fused` (csrc/emit_kernels.cu) for CUDA tensors.
Bytes of flagged frames are unspecified beyond being deterministic; the
kernel and the plain version agree on every output of every frame.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bitpack import pack_words, trailing_bits_symbol, words_to_bytes
from .ebsp import rbsp_to_ebsp_bounded

# Dynamic shared memory a block may use on Hopper (227 KB), less slack
# for the kernel's static scan buffers.
_SMEM_LIMIT = 227 * 1024 - 1024


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
    """Raise unless patterns and nbits are [B, n] on one CPU or CUDA device."""
    if patterns.dim() != 2 or patterns.shape != nbits.shape:
        raise ValueError(f"patterns {tuple(patterns.shape)} and nbits "
                         f"{tuple(nbits.shape)} must both be [B, n]")
    if patterns.device != nbits.device:
        raise ValueError("patterns and nbits must be on one device")
    if patterns.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {patterns.device}")


def emit_nal_fused_batch(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False):
    """K1 over a [B, n] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  Same
    arguments and returns as emit_nal_fused_plain."""
    check_symbols(patterns, nbits)
    if patterns.device.type == "cpu":
        return emit_nal_fused_plain(patterns, nbits, nal_ref_idc, n_rbsp, cap,
                                    align=align, append_tb=append_tb)
    dev = patterns.device
    idc = torch.as_tensor(nal_ref_idc, device=dev).to(torch.int32)
    return launch_kernel(_kernels.as_i32_bits(patterns),
                         nbits.to(torch.int32).contiguous(),
                         idc.expand(patterns.shape[0]).contiguous(),
                         n_rbsp, cap, align=align, append_tb=append_tb)


def launch_kernel(pat, nb, nal_ref_idc, n_rbsp: int, cap: int, *,
                  align: bool, append_tb: bool):
    """Launch K1 on contiguous int32 CUDA tensors pat[B, n] (uint32 bit
    patterns), nb[B, n] and nal_ref_idc[B]; allocates the outputs and
    returns them as emit_nal_fused_batch does."""
    dev = pat.device
    B, n = pat.shape
    n_nal = nal_bytes(n_rbsp, cap)
    if 2 * n_nal > _SMEM_LIMIT:
        raise ValueError(f"NAL buffer of {n_nal} bytes exceeds the kernel's "
                         "shared-memory budget")
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    meta = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _kernels.EMIT_FUSED.launch(
                pat.data_ptr(), nb.data_ptr(), nal_ref_idc.data_ptr(), B, n,
                n_nal, n_rbsp, cap, int(align), int(append_tb),
                nal.data_ptr(), meta.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return nal, meta[:, 2], meta[:, 0], meta[:, 3] != 0


def finish_nal_fused(patterns, nbits, n_rbsp: int, nal_ref_idc, *,
                     max_insertions: int, has_align: bool = False,
                     append_trailing: bool = False):
    """The bounded back end of models/scroll.finish_slice: returns
    (nal u8[B, n_nal], nal_len, total_bits, overflow), byte-identical to
    the JAX package's for in-contract frames."""
    return emit_nal_fused_batch(patterns, nbits, nal_ref_idc, n_rbsp,
                                max_insertions, align=has_align,
                                append_tb=append_trailing)
