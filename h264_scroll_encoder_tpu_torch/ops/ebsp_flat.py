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

The input is zero-padded (or cut) to the next multiple of 128 bytes of
n_nal, as the JAX wrapper does.  On in-contract streams (count <=
max_insertions) the output equals the JAX package's byte for byte; over
the bound the JAX kernel's bytes past its movable range are unspecified,
while the port's follow the rule above in both the plain version and the
kernel.

`rbsp_to_nal_plain` is the plain PyTorch version; `rbsp_to_nal_batch`
runs it for CPU tensors and launches `h264t_ebsp_nal`
(csrc/emit_kernels.cu) for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .emit_fused import _SMEM_LIMIT

ZERO_RUN_WINDOW = 64


def padded_len(n_nal: int) -> int:
    """Input bytes K3 reads per session: n_nal rounded up to 128."""
    return -(-n_nal // 128) * 128


def _fit(rbsp, n: int):
    """Zero-pad or cut uint8[B, m] to [B, n]."""
    m = rbsp.shape[1]
    if m >= n:
        return rbsp[:, :n]
    return torch.cat([rbsp, rbsp.new_zeros((rbsp.shape[0], n - m))], dim=1)


def _per_session(x, B: int, device):
    x = torch.as_tensor(x, device=device).to(torch.int64)
    return x.expand(B) if x.dim() == 0 else x


def rbsp_to_nal_plain(rbsp, rbsp_len, header_byte, n_nal: int,
                      max_insertions: int):
    """Plain PyTorch version of K3 on any device.

    Args:
      rbsp: uint8[B, m] payload bytes.
      rbsp_len: int or int[B] valid lengths.
      header_byte: int or int[B] NAL header bytes.
      n_nal: output bytes per session.
      max_insertions: the insertion bound (sizes the saturation bump).

    Returns (nal uint8[B, n_nal], total_insertions int32[B]).
    """
    B = rbsp.shape[0]
    dev = rbsp.device
    P = padded_len(n_nal)
    n = _per_session(rbsp_len, B, dev)
    hb = _per_session(header_byte, B, dev) & 0xFF
    idx = torch.arange(P, device=dev)
    valid = idx[None, :] < n[:, None]
    b = torch.where(valid, _fit(rbsp, P).to(torch.int64), 0)

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


def rbsp_to_nal_batch(rbsp, rbsp_len, header_byte, n_nal: int,
                      max_insertions: int):
    """K3 over a [B, m] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  Same
    arguments and returns as rbsp_to_nal_plain."""
    if rbsp.dim() != 2:
        raise ValueError(f"rbsp must be [B, n], not {tuple(rbsp.shape)}")
    if rbsp.device.type == "cpu":
        return rbsp_to_nal_plain(rbsp, rbsp_len, header_byte, n_nal,
                                 max_insertions)
    if rbsp.device.type != "cuda":
        raise ValueError(f"unsupported device {rbsp.device}")
    B, dev = rbsp.shape[0], rbsp.device
    return launch_kernel(
        _fit(rbsp.to(torch.uint8), padded_len(n_nal)).contiguous(),
        _per_session(rbsp_len, B, dev).to(torch.int32).contiguous(),
        _per_session(header_byte, B, dev).to(torch.int32).contiguous(),
        n_nal, max_insertions)


def launch_kernel(rbsp, rbsp_len, header, n_nal: int, max_insertions: int):
    """Launch K3 on contiguous CUDA tensors rbsp uint8[B, padded_len(n_nal)],
    rbsp_len int32[B] and header int32[B]; allocates and returns
    (nal uint8[B, n_nal], total int32[B])."""
    dev = rbsp.device
    B, padded = rbsp.shape
    if padded != padded_len(n_nal):
        raise ValueError(f"rbsp has {padded} bytes per session, K3 reads "
                         f"{padded_len(n_nal)}")
    if n_nal + 4 > _SMEM_LIMIT:
        raise ValueError(f"NAL buffer of {n_nal} bytes exceeds the "
                         "kernel's shared-memory budget")
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _kernels.EBSP_NAL.launch(
                rbsp.data_ptr(), rbsp_len.data_ptr(), header.data_ptr(), B,
                padded, n_nal, max_insertions, nal.data_ptr(),
                total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return nal, total
