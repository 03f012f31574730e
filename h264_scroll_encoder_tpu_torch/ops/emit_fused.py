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
the int32 symbols the symbol stages make (uint32 bits, ops/expgolomb's
rule), or int64 ones, as they are: no conversion pass first.
Bytes of flagged frames are unspecified beyond being deterministic; the
kernel and the plain version agree on every output of every frame.

Where one block's shared memory cannot hold a session (4K and 5K hint
frames, the dense frame of I_PCM donors), K1 and K2/K4 spread it over a
thread-block cluster of C blocks (the cluster plan, `_kernels.emit_plan`
and `_kernels.pack_plan`).  `emit_nal_split_plain` and
ops/bitpack_flat.pack_words_split_plain compute the same outputs from C
contiguous shares by the cluster plan's rules; the tests hold them equal
to the unsplit plain versions.
"""

from __future__ import annotations

import numbers

import torch

from .. import _kernels
from . import bitpack
from .bitpack import pack_words, trailing_bits_symbol, words_to_bytes
from .ebsp import EBSP_WINDOW_WORDS, rbsp_to_ebsp_bounded

# The most symbols a thread of K1 or K2/K4 owns per staged chunk: it caps
# the staging area at 8 B * 24 * _kernels.PACK_THREADS = 96 KB a block.
PACK_MAX_ITEMS = 24
# Symbol dtypes the kernels read in place: int32 (the symbol stages'),
# and int64 holding the same values.
SYMBOL_DTYPES = (torch.int32, torch.int64)

# The cluster plan (csrc/emit_device.cuh, the same formulas): a session
# over C blocks, C in CLUSTER_SIZES.  Block r stages the symbols
# [r * share, (r + 1) * share) and holds the RBSP words [r * slice,
# (r + 1) * slice) in its shared memory; a thread owns an odd number of
# symbols of a staged chunk (its run's words then fall into other banks
# than its neighbours'), at most CLUSTER_MAX_ITEMS (132 KB of staging).
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_MAX_ITEMS = 33


def cluster_share(n: int, parts: int) -> int:
    """Symbols of each block's share: ceil(n / parts)."""
    return -(-n // parts)


def cluster_slice(n_words: int, parts: int) -> int:
    """Words of each block's slice: ceil(n_words / parts), rounded up to a
    multiple of 4 (16 bytes)."""
    return (-(-n_words // parts) + 3) // 4 * 4


def cluster_items_per_thread(n: int, parts: int) -> int:
    """Symbols each thread of a cluster block owns per staged chunk of its
    share (h264t_cluster_items)."""
    return min(-(-cluster_share(n, parts) // _kernels.PACK_THREADS) | 1,
               CLUSTER_MAX_ITEMS)


def nal_bytes(n_rbsp: int, cap: int) -> int:
    """NAL buffer size for an RBSP budget and insertion cap
    (h264_scroll_encoder_tpu ops/emit_fused.finish_nal_fused)."""
    return (5 + n_rbsp + cap + 11) // 4 * 4


def _resolve_align(nbits):
    """Replace each negative sentinel by (-pos) mod 8 at its running bit
    position: the phase before lane i is the sum of widths since the last
    sentinel before it, mod 8."""
    nbits = nbits.to(torch.int32)
    is_align = nbits < 0
    widths = torch.where(is_align, 0, nbits)
    incl = torch.cumsum(widths, dim=1, dtype=torch.int32)
    idx = torch.arange(nbits.shape[1], dtype=torch.int32,
                       device=nbits.device).expand(nbits.shape)
    last = torch.cummax(torch.where(is_align, idx, -1), dim=1).values
    last_before = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    at = torch.gather(incl, 1, last_before.clamp(min=0).to(torch.int64))
    since = incl - widths - torch.where(last_before >= 0, at, 0)
    return torch.where(is_align, (8 - (since & 7)) & 7, nbits)


def nal_prefix(nal_ref_idc, batch: int, device):
    """Annex-B start code plus the NAL header byte (coded slice, the given
    nal_ref_idc): uint8[batch, 5]."""
    prefix = torch.zeros((batch, 5), dtype=torch.int64, device=device)
    prefix[:, 3] = 1
    if isinstance(nal_ref_idc, numbers.Integral):
        prefix[:, 4] = ((int(nal_ref_idc) & 3) << 5) | 1
    else:
        idc = torch.as_tensor(nal_ref_idc, device=device).to(torch.int64)
        prefix[:, 4] = (((idc & 3) << 5) | 1).expand(batch)
    return prefix.to(torch.uint8)


def emit_nal_fused_plain(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False):
    """Plain PyTorch version of K1 on any device.

    Args:
      patterns: int[B, n] symbol patterns (uint32 bits as int32, or int64
        holding uint32 values).
      nbits: int[B, n] widths in [0, 32]; negative = alignment sentinel.
      nal_ref_idc: int or int[B].
      n_rbsp: RBSP budget in bytes (frames above it flag overflow).
      cap: emulation-prevention insertion cap.

    Returns (nal u8[B, n_nal], nal_len i32[B], total_bits i32[B],
    overflow bool[B]) with n_nal = nal_bytes(n_rbsp, cap).
    """
    patterns = bitpack.as_u32_bits(patterns)
    nbits = nbits.to(torch.int32)
    B = nbits.shape[0]
    n_nal = nal_bytes(n_rbsp, cap)
    if align:
        nbits = _resolve_align(nbits)
        bad = torch.zeros(B, dtype=torch.bool, device=nbits.device)
    else:
        bad = (nbits < 0).any(dim=1)
        nbits = nbits.clamp(min=0)
    if append_tb:
        tb_pat, tb_n = trailing_bits_symbol(nbits.sum(dim=1,
                                                      dtype=torch.int32))
        patterns = torch.cat([patterns, tb_pat[:, None]], dim=1)
        nbits = torch.cat([nbits, tb_n[:, None]], dim=1)

    words, total_bits = pack_words(patterns, nbits, n_nal // 4)
    rbsp_len = total_bits >> 3
    ebsp, ebsp_len = rbsp_to_ebsp_bounded(words_to_bytes(words), rbsp_len,
                                          n_nal - 5, cap)
    nal = torch.cat([nal_prefix(nal_ref_idc, B, nbits.device), ebsp],
                    dim=1)
    overflow = (total_bits > n_rbsp * 8) | (ebsp_len - rbsp_len > cap) | bad
    return nal, 5 + ebsp_len, total_bits, overflow


def _shares(x, parts: int, fill: int = 0):
    """[B, n] -> [B, parts, cluster_share(n, parts)]: the blocks' contiguous
    shares, the last ones padded with `fill`."""
    B, n = x.shape
    share = cluster_share(n, parts)
    pad = x.new_full((B, parts * share - n), fill)
    return torch.cat([x, pad], dim=1).reshape(B, parts, share)


def _apply_map(has, a, b, pos):
    """A share's position map (emit_device.cuh PosMap) applied to pos."""
    return torch.where(has, (pos + a + 7) // 8 * 8 + b, pos + a)


def pack_split(patterns, nbits, num_words: int, parts: int, *,
               align: bool = False):
    """The cluster plan's pack from `parts` contiguous shares: each share's
    position map (its widths composed, an alignment sentinel rounding the
    position up to a byte), an exclusive scan of the maps across the
    shares for each share's start bit, then each share's symbols placed
    from its start wherever their bits fall, a word that two shares reach
    ORed from both.  Without `align` a sentinel packs as zero bits and
    flags the session.  Returns (words int32[B, num_words] holding uint32
    bits, total_bits int32[B], bad bool[B])."""
    pat = bitpack.as_u32_bits(patterns)
    nb = nbits.to(torch.int32)
    B = nb.shape[0]
    bad = (nb < 0).any(dim=1) & (not align)
    sentinel = (nb < 0) & align
    widths = nb.clamp(min=0)
    # A share's map: ceil8(pos + a) + b after a sentinel, pos + a without.
    # a sums the widths before the first sentinel; b the widths after the
    # last, plus each whole segment between two sentinels rounded up to 8.
    w_sh, s_sh = _shares(widths, parts), _shares(sentinel, parts, False)
    seg = torch.cumsum(s_sh, dim=2, dtype=torch.int32)
    sums = torch.zeros(w_sh.shape[:2] + (w_sh.shape[2] + 1,),
                       dtype=torch.int32, device=nb.device)
    sums.scatter_add_(2, seg.to(torch.int64), w_sh)
    m = seg[:, :, -1:] if seg.shape[2] else torch.zeros_like(sums[:, :, :1])
    j = torch.arange(sums.shape[2], dtype=torch.int32, device=nb.device)
    b = torch.where((j >= 1) & (j < m), (sums + 7) // 8 * 8,
                    torch.where((j >= 1) & (j == m), sums, 0)
                    ).sum(dim=2, dtype=torch.int32)
    has, a = m[:, :, 0] > 0, sums[:, :, 0]
    starts = []
    carry = torch.zeros(B, dtype=torch.int32, device=nb.device)
    for r in range(parts):
        starts.append(carry)
        carry = _apply_map(has[:, r], a[:, r], b[:, r], carry)
    words = torch.zeros((B, num_words), dtype=torch.int32, device=nb.device)
    p_sh = _shares(pat, parts)
    nb_sh = _shares(torch.where(sentinel, -1, widths), parts)
    for r, start in enumerate(starts):
        # The share's widths with its sentinels resolved from its start:
        # a leading symbol of width `start` carries the byte phase in.
        w = _resolve_align(torch.cat([start[:, None], nb_sh[:, r]], dim=1))
        got, _ = pack_words(p_sh[:, r], w[:, 1:], num_words,
                            start_bit=start[:, None])
        words |= got
    return words, carry, bad


def _ep_split(rbsp, rbsp_len, n_nal: int, parts: int):
    """K1's bounded emulation prevention over `parts` byte slices (each
    block's RBSP words): each slice's last nonzero byte and an exclusive
    max across the slices carry the zero run in; each slice's insertions
    and an exclusive sum across the slices give its bytes' NAL positions.
    Returns (payload u8[B, n_nal - 5], insertions int64[B], saturated
    bool[B])."""
    B = rbsp.shape[0]
    dev = rbsp.device
    width = 4 * cluster_slice(n_nal // 4, parts)
    byte = torch.zeros((B, parts * width), dtype=torch.int64, device=dev)
    byte[:, :n_nal] = rbsp[:, :n_nal].to(torch.int64)
    i = torch.arange(parts * width, device=dev)
    valid = i[None, :] < torch.clamp(rbsp_len, max=n_nal)[:, None]
    nz = torch.where(valid & (byte != 0), i, -1).reshape(B, parts, width)
    incl = torch.cummax(nz, dim=2).values
    last_in = torch.cat([torch.full_like(incl[:, :, :1], -1), incl[:, :, :-1]],
                        dim=2)
    ends = incl[:, :, -1]
    before = torch.cat([torch.full_like(ends[:, :1], -1),
                        torch.cummax(ends, dim=1).values[:, :-1]], dim=1)
    last = torch.maximum(last_in, before[:, :, None]).reshape(B, -1)
    t = i[None, :] - 1 - last
    unresolved = (((i >> 2) > EBSP_WINDOW_WORDS)[None, :]
                  & (t >= 4 * EBSP_WINDOW_WORDS + (i & 3)[None, :]))
    ins = valid & (byte <= 3) & (t >= 2) & (t % 2 == 0) & ~unresolved
    per = ins.reshape(B, parts, width).to(torch.int64)
    counts = per.sum(dim=2)
    ins_before = torch.cumsum(counts, dim=1) - counts
    dst = (i[None, :] + (ins_before[:, :, None]
                         + torch.cumsum(per, dim=2)).reshape(B, -1))
    size = n_nal - 5
    out = torch.zeros((B, size + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(valid & (dst < size), dst, size),
                 byte.to(torch.uint8))
    out.scatter_(1, torch.where(ins & (dst - 1 < size), dst - 1, size),
                 torch.full_like(byte, 3, dtype=torch.uint8))
    return out[:, :size], counts.sum(dim=1), (valid & unresolved).any(dim=1)


def emit_nal_split_plain(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False,
                         parts: int = 1):
    """K1's contract computed as the cluster plan computes it, from `parts`
    contiguous shares of the symbols and `parts` slices of the RBSP words
    (pack_split, _ep_split): the trailing bits where the total ends, the
    saturation flag and insertions reduced over the slices.  Arguments and
    returns as emit_nal_fused_plain, whose outputs it equals."""
    B = nbits.shape[0]
    n_nal = nal_bytes(n_rbsp, cap)
    words, total_bits, bad = pack_split(patterns, nbits, n_nal // 4, parts,
                                        align=align)
    if append_tb:
        tb_pat, tb_n = trailing_bits_symbol(total_bits)
        tb, _ = pack_words(tb_pat[:, None], tb_n[:, None], n_nal // 4,
                           start_bit=total_bits[:, None])
        words |= tb
        total_bits = total_bits + tb_n
    rbsp_len = total_bits >> 3
    payload, ins, sat = _ep_split(words_to_bytes(words), rbsp_len, n_nal,
                                  parts)
    ins_eff = ins + sat.to(torch.int64) * (cap + 1)
    nal = torch.cat([nal_prefix(nal_ref_idc, B, nbits.device), payload], dim=1)
    overflow = (total_bits > n_rbsp * 8) | (ins_eff > cap) | bad
    return (nal, (5 + rbsp_len + ins_eff).to(torch.int32),
            total_bits.to(torch.int32), overflow)


def check_symbols(patterns, nbits):
    """Raise unless patterns and nbits are [B, n] tensors of one dtype,
    int32 (as the symbol stages make them) or int64, on one CPU or CUDA
    device.  Nothing is converted: any other dtype raises."""
    if patterns.dim() != 2 or patterns.shape != nbits.shape:
        raise ValueError(f"patterns {tuple(patterns.shape)} and nbits "
                         f"{tuple(nbits.shape)} must both be [B, n]")
    if patterns.dtype not in SYMBOL_DTYPES or nbits.dtype != patterns.dtype:
        raise TypeError(f"patterns ({patterns.dtype}) and nbits ({nbits.dtype}) "
                        "must both be int32 or both int64")
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


def launch_geometry(plan, n: int, cluster: int | None) -> tuple[int, int]:
    """(C, items per thread) of a K1 or K2/K4 launch over n symbols: the
    library's plan (plan()) unless a test forces `cluster`; C = 1 is one
    block a session, C > 1 the cluster plan.  Raises where no plan fits."""
    if cluster is not None and cluster not in (1,) + CLUSTER_SIZES:
        raise ValueError(f"cluster must be 1 or one of {CLUSTER_SIZES}, "
                         f"not {cluster}")
    c = plan() if cluster is None else cluster
    if c == 0:
        raise RuntimeError(f"no launch plan fits {n} symbols a session in "
                           f"a cluster of up to {CLUSTER_SIZES[-1]} blocks")
    return c, items_per_thread(n) if c == 1 else cluster_items_per_thread(n, c)


def staged_chunks(n: int, c: int, k: int) -> int:
    """Chunks of n symbols a session's C blocks stage at k symbols a thread
    (the tracer's `emit.chunks` a K1 launch): 1 at 720p, 8 for a 3840x2160
    scroll frame on one block."""
    share = n if c == 1 else cluster_share(n, c)
    return c * -(-share // (_kernels.PACK_THREADS * k))


def emit_nal_fused_batch(patterns, nbits, nal_ref_idc, n_rbsp: int, cap: int,
                         *, align: bool = False, append_tb: bool = False,
                         cluster: int | None = None):
    """K1 over a [B, n] batch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a build or launch failure raises).  Same
    arguments and returns as emit_nal_fused_plain; patterns and nbits are
    int32 or int64, and the kernel reads them as they are.  `cluster`
    (tests only) forces the blocks a session, 1 or one of CLUSTER_SIZES,
    instead of the library's plan."""
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
        if idc.dtype != torch.int32:
            idc = idc.to(torch.int32)
        idc = idc.reshape(-1).expand(B)
        idc_row, idc_value = idc.stride(0), 0
    nal = torch.empty((B, n_nal), dtype=torch.uint8, device=dev)
    meta = torch.empty((2, B), dtype=torch.int32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        with torch.cuda.device(dev):
            # Large frames: a cluster of C blocks a session (see the .cu).
            c, k = launch_geometry(
                lambda: _kernels.emit_plan(patterns.element_size(), n,
                                           items_per_thread(n), n_nal),
                n, cluster)
            _kernels.EMIT_FUSED.launch(
                patterns.data_ptr(), nbits.data_ptr(), patterns.element_size(),
                row_stride(patterns), row_stride(nbits),
                None if idc is None else idc.data_ptr(), idc_row, idc_value,
                B, n, k, n_nal, n_rbsp, cap, int(align), int(append_tb), c,
                nal.data_ptr(), meta[0].data_ptr(), meta[1].data_ptr(),
                overflow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
                counts={"emit.chunks": staged_chunks(n, c, k)})
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
