"""Bounded emulation prevention + Annex-B framing from RBSP bytes (K3).

Port of h264_scroll_encoder_tpu/ops/ebsp_flat.py, whose Pallas kernel
`_ebsp_kernel` (behind `rbsp_to_nal_pallas`) turns one session's RBSP
bytes, valid length and NAL header byte into framed NAL bytes plus the
total insertion count.  Its rule (the staged path's, not K1's):

  - the zero run t before byte i is exact when the last nonzero byte lies
    at most ZERO_RUN_WINDOW = 64 bytes back (or none exists and i <= 64);
    otherwise t = min(i, 255) and, past byte 64, the stream is saturated;
  - byte i takes a 0x03 before it iff b[i] <= 3, t >= 2 and t is even;
  - the count is the number of insertions, plus max_insertions + 1 when
    saturated, so the caller retries through the exact path;
  - out = 00 00 00 01, header, then each byte at 5 + i + (insertions up
    to and including i), 0x03 in every other position below
    5 + rbsp_len + count, zeros after.

As in the JAX wrapper, the bytes are cast to uint8 and the length and
header to int32 first, and the stream is the row zero-padded (or cut) to
the next multiple of 128 bytes of n_nal.  On in-contract streams (count
<= max_insertions) whose NAL fits its buffer the output equals the JAX
package's byte for byte.  Over the bound the JAX kernel's bytes past its
movable range are unspecified, and where 5 + rbsp_len + count > n_nal its
cyclic rolls wrap the overflow to the front of the buffer; the port's
bytes follow the rule above in both cases, writing nothing past the
buffer, in both the plain version and the kernel.

`rbsp_to_nal_plain` is the plain PyTorch version (it takes ints or int
arrays for the lengths and header bytes, as the JAX function does);
`rbsp_to_nal_batch` runs it for CPU tensors and launches `h264t_ebsp_nal`
(csrc/emit_kernels.cu) for CUDA tensors, on the forms the entry path hands
it: uint8 bytes read in place with their row stride, int64 lengths read
in place, and one header byte, a Python int.  Past a block's shared
memory the kernel reads the rows from global memory and builds the NAL in
place (_kernels.ebsp_nal_in_global).
"""

from __future__ import annotations

import numbers

import torch

from .. import _kernels
from .emit_fused import row_stride

ZERO_RUN_WINDOW = 64


def padded_len(n_nal: int) -> int:
    """Stream positions K3 considers per session: n_nal rounded up to 128."""
    return -(-n_nal // 128) * 128


def items_per_thread(valid: int) -> int:
    """Bytes each of the _kernels.PACK_THREADS threads of K3 owns for a
    session of `valid` bytes: ceil(valid / threads), made odd.  The kernel
    computes it itself; this is its value without a card, for the boundary
    cases, and the card tests hold it equal to the built kernel's
    (_kernels.ebsp_items_per_thread)."""
    return -(-valid // _kernels.PACK_THREADS) | 1


def _per_session(x, B: int, device):
    """int or int[B] -> int64 of int32 values, broadcast over B sessions."""
    x = torch.as_tensor(x, device=device).to(torch.int32).to(torch.int64)
    return x.expand(B) if x.dim() == 0 else x


def rbsp_to_nal_plain(rbsp, rbsp_len, header_byte, n_nal: int,
                      max_insertions: int):
    """Plain PyTorch version of K3 on any device.

    Args:
      rbsp: [B, m] payload bytes (any integer dtype; cast to uint8).
      rbsp_len: int or int[B] valid lengths.
      header_byte: int or int[B] NAL header bytes.
      n_nal: output bytes per session.
      max_insertions: the insertion bound (sizes the saturation bump).

    Returns (nal uint8[B, n_nal], total_insertions int32[B]).
    """
    B, m = rbsp.shape
    dev = rbsp.device
    P = padded_len(n_nal)
    n = _per_session(rbsp_len, B, dev)
    hb = _per_session(header_byte, B, dev) & 0xFF
    idx = torch.arange(P, device=dev)
    valid = idx[None, :] < n[:, None]
    raw = torch.zeros((B, P), dtype=torch.int64, device=dev)
    raw[:, :min(m, P)] = rbsp[:, :P].to(torch.uint8)
    b = torch.where(valid, raw, 0)

    nz = torch.where(b != 0, idx, -1)
    last = torch.cummax(nz, dim=1).values
    last_before = torch.cat([torch.full_like(last[:, :1], -1),
                             last[:, :-1]], dim=1)
    found = (last_before >= 0) & (idx - last_before <= ZERO_RUN_WINDOW)
    t = torch.where(found, idx - last_before - 1, idx.clamp(max=255))
    saturated = (valid & ~found & (idx > ZERO_RUN_WINDOW)).any(dim=1)
    ins = valid & (b <= 3) & (t >= 2) & (t % 2 == 0)
    incl = torch.cumsum(ins.to(torch.int64), dim=1)
    total = incl[:, -1] + saturated.to(torch.int64) * (max_insertions + 1)

    pos = torch.arange(n_nal + 1, device=dev)
    end = 5 + n + total
    out = torch.where((pos >= 5) & (pos < end[:, None]), 3, 0)
    dst = 5 + idx + incl
    out.scatter_(1, torch.where(valid & (dst < n_nal), dst, n_nal), b)
    prefix = torch.tensor([0, 0, 0, 1, 0], device=dev).expand(B, 5).clone()
    prefix[:, 4] = hb
    k = min(5, n_nal)
    out[:, :k] = prefix[:, :k]
    return out[:, :n_nal].to(torch.uint8), total.to(torch.int32)


def session_lengths(rbsp, rbsp_len):
    """The [B] view of K3's lengths that the kernel reads in place: rbsp_len
    must be an int64 tensor, [B] or 0-dim (one length for every session),
    on rbsp's device.  No other form is taken (TypeError)."""
    if not isinstance(rbsp_len, torch.Tensor) or rbsp_len.dtype != torch.int64:
        raise TypeError("rbsp_len must be an int64 tensor, not "
                        f"{getattr(rbsp_len, 'dtype', type(rbsp_len))}")
    if rbsp_len.device != rbsp.device or rbsp_len.dim() > 1:
        raise ValueError(f"rbsp_len must be [B] or 0-dim on {rbsp.device}, "
                         f"not {tuple(rbsp_len.shape)} on {rbsp_len.device}")
    return rbsp_len.reshape(-1).expand(rbsp.shape[0])


def rbsp_to_nal_batch(rbsp, rbsp_len, header_byte: int, n_nal: int,
                      max_insertions: int):
    """K3 over a [B, m] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  Returns as
    rbsp_to_nal_plain.  rbsp_len is an int64 tensor, [B] or 0-dim
    (session_lengths), and header_byte a Python int, on both devices;
    other forms raise TypeError.  On the card a uint8 rbsp (unit stride
    along each row, or ValueError) is read as it is; any other byte dtype
    is cast to uint8 once (the JAX wrapper's cast)."""
    if rbsp.dim() != 2:
        raise ValueError(f"rbsp must be [B, n], not {tuple(rbsp.shape)}")
    lens = session_lengths(rbsp, rbsp_len)
    if not isinstance(header_byte, numbers.Integral):
        raise TypeError(f"header_byte must be an int, not {type(header_byte)}")
    if rbsp.device.type == "cpu":
        return rbsp_to_nal_plain(rbsp, lens, header_byte, n_nal,
                                 max_insertions)
    if rbsp.device.type != "cuda":
        raise ValueError(f"unsupported device {rbsp.device}")
    dev = rbsp.device
    B, m = rbsp.shape
    if rbsp.dtype != torch.uint8:
        rbsp = rbsp.to(torch.uint8)
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _kernels.EBSP_NAL.launch(
                rbsp.data_ptr(), row_stride(rbsp), m, lens.data_ptr(),
                lens.stride(0), int(header_byte) & 0xFF, B, n_nal,
                max_insertions, int(_kernels.ebsp_nal_in_global(n_nal)),
                nal.data_ptr(), total.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return nal, total
