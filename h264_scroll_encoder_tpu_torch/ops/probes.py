"""Measurement probes of K1, K2 and K3 (P1-P3, P5/P6), each with its
plain version.

The counterparts of the JAX package's Pallas probes, in the idiom of
ops/bitpack_flat: CPU tensors run the plain version, CUDA tensors launch
the kernel (csrc/probe_kernels.cu, built from K1's and K2's own device
code in csrc/emit_device.cuh), anything else raises, and a failed build
or launch raises.

  P1  `emit_stage_batch(stage, ...)` — scripts/emit_stage_probe.py's
      `_stage_kernel`: K1 cut off after each stage of its Hopper chain
      (EMIT_STAGES: launch, stage, scan, pack, ep, full), every cut ending
      in a write that depends on everything before it.  Outputs of a cut
      stage: meta int32[B, 4] (and for `pack` the words):
        launch  zeros
        stage   [XOR of the session's staged words: the low 32 bits of
                 every pattern and width, 0, 0, 0]
        scan    [total bits, XOR of the threads' start bits, 0, 0]
        pack    [total bits before the trailing bits, 0, 0, 0], and the
                 words int32[B, n_nal // 4] (uint32 bit patterns)
        ep      [insertions, saturated (0/1), XOR of the NAL's first
                 min(5 + valid + insertions, n_nal) bytes as
                 little-endian 32-bit words, 0]
      `full` is K1 and returns what emit_nal_fused_batch returns.
  P2  `pack_place_u16_batch` — scripts/pack_u16_probe.py's
      `_place_kernel_u16`: K2 with 8-bit staged widths and 16-bit
      positions (carry-out tracked); K2's contract for num_words <=
      U16_MAX_WORDS, refused above it.
  P3  `pack_place_tiled_batch` — scripts/pack_tiled_probe.py's tiled
      `_pack_kernel3`: K2 with `tile` sessions a block; K2's contract,
      refused where B % tile != 0.

  P5/P6  `ebsp_variant_batch(variant, ...)` — the counterparts of
      scripts/ebsp_cumsum_probe.py's and scripts/ebsp_fused_probe.py's
      races inside the bounded EBSP stage: K3 (ops/ebsp_flat) with its
      emulation-prevention stage or its framing swapped (EBSP_VARIANTS:
      runs and shared are K3 itself, ballot scans with warp ballots,
      direct builds the NAL in place in the output row, lanes rereads the
      first pass's 16-bit lanes; csrc/probe_kernels.cu).  K3's contract.

The plain versions of P2 and P3 are K2's (ops/bitpack_flat) behind their
own refusals, that of every P5/P6 variant K3's (rbsp_to_nal_plain); P1's
stages have plain versions of their own outputs.
"""

from __future__ import annotations

import numbers

import torch

from .. import _kernels
from . import ebsp, ebsp_flat
from .bitpack import (as_u32_bits, pack_words, trailing_bits_symbol,
                      words_to_bytes)
from .bitpack_flat import pack_words_place_plain
from .emit_fused import (PACK_MAX_ITEMS, _resolve_align, check_symbols,
                         cluster_items_per_thread, cluster_share,
                         emit_nal_fused_plain, items_per_thread,
                         launch_geometry, nal_bytes, nal_prefix, row_stride)

EMIT_STAGES = _kernels.EMIT_STAGES
# P2 keeps at most this many words: 65,536 bits, the reach of a 16-bit
# position (csrc/probe_kernels.cu kU16MaxWords).
U16_MAX_WORDS = 2048
TILES = (1, 2, 4, 8, 16)


def xor_reduce(x):
    """XOR of each row of an integer [B, m] tensor: int64[B] (0 for m = 0)."""
    x = x.to(torch.int64)
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] ^ x[:, 1::2]
    return x[:, 0] if x.shape[1] else x.new_zeros(x.shape[0])


def _resolved_widths(nbits, align: bool):
    """The widths K1 packs: alignment sentinels as (-pos) mod 8 bits under
    `align`, as none without."""
    nbits = nbits.to(torch.int64)
    return _resolve_align(nbits) if align else nbits.clamp(min=0)


def _run_firsts(n: int, cluster: int, dev):
    """The first symbol of every thread's run in every staged chunk of K1
    on `cluster` blocks a session (1: one block), clamped to the end of
    its block's share: thread t of the chunk at `base` of the share from
    `lo` starts at symbol lo + base + t * k."""
    k = items_per_thread(n) if cluster == 1 else cluster_items_per_thread(
        n, cluster)
    share = n if cluster == 1 else cluster_share(n, cluster)
    t = torch.arange(_kernels.PACK_THREADS, device=dev) * k
    firsts = []
    for lo in range(0, n, max(share, 1)):
        hi = min(lo + share, n)
        firsts += [torch.clamp(lo + base + t, max=hi)
                   for base in range(0, hi - lo, _kernels.PACK_THREADS * k)]
    return firsts


def emit_stage_plain(stage: str, patterns, nbits, nal_ref_idc, n_rbsp: int,
                     cap: int, *, align: bool = False, append_tb: bool = False,
                     cluster: int = 1):
    """Plain PyTorch version of P1 at `stage` (see the module docstring);
    arguments as ops/emit_fused.emit_nal_fused_plain.  `cluster` is the
    blocks a session of the kernel it models: only the `scan` stage's
    XOR of the threads' start bits depends on it."""
    if stage not in EMIT_STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {EMIT_STAGES}")
    if stage == "full":
        return emit_nal_fused_plain(patterns, nbits, nal_ref_idc, n_rbsp, cap,
                                    align=align, append_tb=append_tb)
    B, n = patterns.shape
    dev = patterns.device
    meta = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    n_nal = nal_bytes(n_rbsp, cap)
    if stage == "stage":
        meta[:, 0] = xor_reduce((patterns.to(torch.int64) ^ nbits.to(torch.int64))
                                & 0xFFFFFFFF)
        return (as_u32_bits(meta),)
    widths = _resolved_widths(nbits, align)
    incl = torch.cumsum(widths, dim=1)
    total = incl[:, -1] if n else widths.new_zeros(B)
    if stage == "scan":
        # Each thread starts at the bit offset of its run's first symbol
        # (its share's end where that lies past it).
        offsets = torch.cat([torch.zeros_like(widths[:, :1]), incl], dim=1)
        firsts = _run_firsts(n, cluster, dev)
        if firsts:
            starts = offsets[:, torch.cat(firsts)]
            meta[:, 1] = xor_reduce(starts & 0xFFFFFFFF)
        meta[:, 0] = total
        return (as_u32_bits(meta),)
    if stage == "launch":
        return (as_u32_bits(meta),)
    if stage == "pack":
        words, total = pack_words(patterns, widths, n_nal // 4)
        meta[:, 0] = total
        return as_u32_bits(meta), as_u32_bits(words)
    # ep: the bounded rule of ops/ebsp.rbsp_to_ebsp_bounded, with its
    # insertions and saturation kept apart.
    pat = patterns.to(torch.int64)
    if append_tb:
        tb_pat, tb_n = trailing_bits_symbol(widths.sum(dim=1))
        pat = torch.cat([pat, tb_pat[:, None]], dim=1)
        widths = torch.cat([widths, tb_n[:, None]], dim=1)
    words, total_bits = pack_words(pat, widths, n_nal // 4)
    rbsp = words_to_bytes(words)
    rbsp_len = total_bits >> 3
    valid, t, ins = ebsp._insertion_flags(rbsp, rbsp_len)
    i = torch.arange(rbsp.shape[1], device=dev)
    unresolved = (((i >> 2) > ebsp.EBSP_WINDOW_WORDS)[None, :]
                  & (t >= 4 * ebsp.EBSP_WINDOW_WORDS + (i & 3)[None, :]))
    ins = ins & ~unresolved
    ins_total = ins.sum(dim=1)
    nal = torch.cat([nal_prefix(nal_ref_idc, B, dev),
                     ebsp._expand(rbsp, valid, ins, n_nal - 5)], dim=1)
    fill = torch.clamp(5 + torch.clamp(rbsp_len, max=n_nal) + ins_total,
                       max=n_nal)
    pos = torch.arange(n_nal, device=dev)
    le = torch.where(pos[None, :] < fill[:, None],
                     nal.to(torch.int64) << (8 * (pos & 3))[None, :], 0)
    meta[:, 0] = ins_total
    meta[:, 1] = (valid & unresolved).any(dim=1).to(torch.int64)
    meta[:, 2] = xor_reduce(le)
    return (as_u32_bits(meta),)


def emit_stage_batch(stage: str, patterns, nbits, nal_ref_idc, n_rbsp: int,
                     cap: int, *, align: bool = False, append_tb: bool = False,
                     cluster: int | None = None):
    """P1 at `stage` over a [B, n] batch: the plain version for CPU
    tensors, the CUDA kernel (K1's block, or cluster, plan and shared
    memory) for CUDA tensors.  Arguments as emit_nal_fused_batch; returns
    as emit_stage_plain."""
    if stage not in EMIT_STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {EMIT_STAGES}")
    check_symbols(patterns, nbits)
    if patterns.device.type == "cpu":
        return emit_stage_plain(stage, patterns, nbits, nal_ref_idc, n_rbsp,
                                cap, align=align, append_tb=append_tb,
                                cluster=cluster or 1)
    dev = patterns.device
    B, n = patterns.shape
    n_nal = nal_bytes(n_rbsp, cap)
    if isinstance(nal_ref_idc, numbers.Integral):
        idc, idc_row, idc_value = None, 0, int(nal_ref_idc)
    else:
        idc = torch.as_tensor(nal_ref_idc, device=dev)
        if idc.dtype != torch.int32:
            idc = idc.to(torch.int32)
        idc = idc.reshape(-1).expand(B)
        idc_row, idc_value = idc.stride(0), 0
    full = stage == "full"
    meta = torch.empty((B, 4), dtype=torch.int32, device=dev)
    words = (torch.empty((B, n_nal // 4), dtype=torch.int32, device=dev)
             if stage == "pack" else None)
    with torch.cuda.device(dev):
        c, k = launch_geometry(
            lambda: _kernels.emit_plan(patterns.element_size(), n,
                                       items_per_thread(n), n_nal),
            n, cluster)
        nal = (torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
               if full or (stage == "ep" and c > 1) else None)
        res = (torch.empty((2, B), dtype=torch.int32, device=dev)
               if full else None)
        ovf = torch.empty((B,), dtype=torch.bool, device=dev) if full else None
        if B:
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            _kernels.EMIT_STAGE[stage].launch(
                EMIT_STAGES.index(stage),
                patterns.data_ptr(), nbits.data_ptr(), patterns.element_size(),
                row_stride(patterns), row_stride(nbits),
                ptr(idc), idc_row, idc_value,
                B, n, k, n_nal, n_rbsp, cap, int(align), int(append_tb), c,
                ptr(nal),
                ptr(res if res is None else res[0]),
                ptr(res if res is None else res[1]), ptr(ovf),
                meta.data_ptr(), ptr(words),
                torch.cuda.current_stream(dev).cuda_stream)
    if full:
        return nal, res[0], res[1], ovf
    return (meta,) if words is None else (meta, words)


def _pack_args(patterns, nbits, num_words: int):
    check_symbols(patterns, nbits)
    if num_words < 0:
        raise ValueError(f"num_words must be >= 0, not {num_words}")


def pack_place_u16_plain(patterns, nbits, num_words: int):
    """Plain version of P2: K2's (pack_words_place_plain), for num_words <=
    U16_MAX_WORDS (ValueError above)."""
    if num_words > U16_MAX_WORDS:
        raise ValueError(f"P2 keeps at most {U16_MAX_WORDS} words (65,536 "
                         f"bits), not {num_words}")
    return pack_words_place_plain(patterns, nbits, num_words)


def pack_place_u16_batch(patterns, nbits, num_words: int):
    """P2 over a [B, n] batch: K2's contract for num_words <= 2,048, which
    is checked before anything launches.  Returns (words int32[B,
    num_words] holding uint32 bits, total_bits int32[B]), as K2's."""
    _pack_args(patterns, nbits, num_words)
    if num_words > U16_MAX_WORDS:
        raise ValueError(f"P2 keeps at most {U16_MAX_WORDS} words (65,536 "
                         f"bits), not {num_words}")
    if patterns.device.type == "cpu":
        return pack_place_u16_plain(patterns, nbits, num_words)
    dev = patterns.device
    B, n = patterns.shape
    words = torch.empty((B, num_words), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _kernels.PACK_PLACE_U16.launch(
                patterns.data_ptr(), nbits.data_ptr(), patterns.element_size(),
                row_stride(patterns), row_stride(nbits), B, n,
                items_per_thread(n), num_words, words.data_ptr(),
                total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return words, total


def _check_tile(batch: int, tile: int):
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, not {tile}")
    if batch % tile:
        raise ValueError(f"batch {batch} is not a multiple of tile {tile}")


def pack_place_tiled_plain(patterns, nbits, num_words: int, tile: int):
    """Plain version of P3: K2's, for B % tile == 0 (ValueError else)."""
    _check_tile(patterns.shape[0], tile)
    return pack_words_place_plain(patterns, nbits, num_words)


def tiled_items(patterns, num_words: int, tile: int) -> int:
    """P3's symbols per thread on the card for these symbols (ValueError
    where `tile` sessions' words leave no room for staging)."""
    k = _kernels.pack_tiled_items(patterns.element_size(), tile,
                                  patterns.shape[1], num_words, PACK_MAX_ITEMS)
    if k < 1:
        raise ValueError(f"{tile} sessions of {num_words} words do not fit a "
                         "block's shared memory")
    return k


def pack_place_tiled_batch(patterns, nbits, num_words: int, tile: int):
    """P3 over a [B, n] batch with `tile` sessions a block: K2's contract;
    B % tile != 0 raises ValueError before anything launches.  Returns
    (words int32[B, num_words] holding uint32 bits, total_bits int32[B]),
    as K2's."""
    _pack_args(patterns, nbits, num_words)
    _check_tile(patterns.shape[0], tile)
    if patterns.device.type == "cpu":
        return pack_place_tiled_plain(patterns, nbits, num_words, tile)
    dev = patterns.device
    B, n = patterns.shape
    words = torch.empty((B, num_words), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _kernels.PACK_PLACE_TILED.launch(
                tile, patterns.data_ptr(), nbits.data_ptr(),
                patterns.element_size(), row_stride(patterns),
                row_stride(nbits), B, n, tiled_items(patterns, num_words, tile),
                num_words, words.data_ptr(), total.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return words, total


EBSP_VARIANTS = _kernels.EBSP_VARIANTS
# The emulation-prevention stage each variant runs (csrc: 0 K3's runs, 1
# ballot, 2 lanes).
_EBSP_STAGE = {"runs": 0, "ballot": 1, "shared": 0, "direct": 0, "lanes": 2}


def _check_variant(variant: str):
    if variant not in EBSP_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {EBSP_VARIANTS}")


def ebsp_variant_plain(variant: str, rbsp, rbsp_len, header_byte, n_nal: int,
                       max_insertions: int):
    """Plain version of P5/P6 at `variant`: K3's (rbsp_to_nal_plain)."""
    _check_variant(variant)
    return ebsp_flat.rbsp_to_nal_plain(rbsp, rbsp_len, header_byte, n_nal,
                                       max_insertions)


def ebsp_variant_batch(variant: str, rbsp, rbsp_len, header_byte: int,
                       n_nal: int, max_insertions: int):
    """P5/P6 at `variant` over a [B, m] batch: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  Arguments and returns as
    ops/ebsp_flat.rbsp_to_nal_batch (uint8 rows with unit stride along
    each row, int64 lengths, an int header).  runs and shared take K3's
    plan, direct K3's global plan at every size; ballot and lanes stage the
    row, and a NAL whose staged block passes a block's shared memory
    fails at launch (RuntimeError)."""
    _check_variant(variant)
    if rbsp.dim() != 2:
        raise ValueError(f"rbsp must be [B, n], not {tuple(rbsp.shape)}")
    lens = ebsp_flat.session_lengths(rbsp, rbsp_len)
    if not isinstance(header_byte, numbers.Integral):
        raise TypeError(f"header_byte must be an int, not {type(header_byte)}")
    if rbsp.device.type == "cpu":
        return ebsp_variant_plain(variant, rbsp, lens, header_byte, n_nal,
                                  max_insertions)
    if rbsp.device.type != "cuda":
        raise ValueError(f"unsupported device {rbsp.device}")
    if rbsp.dtype != torch.uint8:
        raise TypeError(f"rbsp must be uint8 on the card, not {rbsp.dtype}")
    dev = rbsp.device
    B, m = rbsp.shape
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            stage = _EBSP_STAGE[variant]
            in_global = (variant == "direct"
                         or (stage == 0 and _kernels.ebsp_nal_in_global(n_nal)))
            _kernels.EBSP_VARIANT[variant].launch(
                stage, rbsp.data_ptr(), row_stride(rbsp), m, lens.data_ptr(),
                lens.stride(0), int(header_byte) & 0xFF, B, n_nal,
                max_insertions, int(in_global), nal.data_ptr(),
                total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return nal, total
