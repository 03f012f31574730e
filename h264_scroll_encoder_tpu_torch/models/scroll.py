"""Scroll / waypoint P-frames, batched over sessions.

Port of h264_scroll_encoder_tpu/models/scroll.py (the reference's
h264_write_scroll_p_frame / h264_write_waypoint_p_frame):

  MB-grid field assignment  ->  MV-prediction stencil  ->  per-MB syntax
  symbols  ->  finish_slice: bit pack -> emulation prevention -> Annex-B

Every macroblock is coded P_L0_16x16 with its assigned motion vector (or
P_Skip whose derived MV equals it), so H.264 8.4.1.3.1 median prediction is
a pure neighbour stencil over the grid.  `enable_pskip=True` implements the
decoder's skip-MV rule (8.4.1.1); False is the byte-parity mode against the
C reference.

Grids are [B, h, w] tensors (session dimension first); per-session scalars
are [B] tensors.  Besides the floor and nearest seams, the partitioned
seam codes the straddled MB row as two 16x8 partitions
(`emit_partitioned_scroll_frame`), and `scroll_frame_sliced` emits a
frame as MB-row bands, all bands of all sessions in one back-end call.
"""

from __future__ import annotations

import torch

from ..config import (ComposerConfig, MAX_EBSP_INSERTIONS, MAX_WAYPOINTS,
                      MV_LIMIT_PX)
from ..ops import bitpack, bitpack_flat, ebsp, emit_fused, expgolomb, grid
# The stencils and the skip-run scan live beside K6 (ops/grid); these names
# stay the module's, the JAX package's models/scroll names.
from ..ops.grid import (_neighbors, _pred_stencil_roles, _skip_runs,  # noqa: F401
                        mv_pred_grid, mv_pred_grid_roles, pskip_mv_grid)
from ..syntax.slice_headers import p_slice_header_symbols

# Tight working-buffer budget for the scroll/waypoint fast path: composed
# frames are region-uniform (interior mvds are se(0)), <= 12 bits/MB plus
# boundary rows.  Frames that overflow retry through the exact path at
# cfg.rbsp_bits_per_mb.
SCROLL_FAST_RBSP_BITS_PER_MB = 16


def max_rbsp_bytes(cfg: ComposerConfig) -> int:
    n = (cfg.total_mbs * cfg.rbsp_bits_per_mb // 8) + 96
    return (n + 3) // 4 * 4


def max_nal_bytes(cfg: ComposerConfig) -> int:
    # Start code (4) + NAL header (1) + EBSP worst case 1.5x RBSP.
    n = 5 + max_rbsp_bytes(cfg) * 3 // 2 + 8
    return (n + 3) // 4 * 4


def _i32(x, like):
    """Per-session value as an int32 tensor (the JAX package's width) on
    `like`'s device."""
    return torch.as_tensor(x, device=like.device).to(torch.int32)



# ---------------------------------------------------------------------------
# Field assignment (which reference / which MV per MB).
# ---------------------------------------------------------------------------

def _best_waypoint_a(offset_px, wp_offsets, wp_valid, num_waypoints):
    """Highest waypoint offset <= offset with delta <= MV_LIMIT_PX, only
    engaged when offset > MV_LIMIT_PX.  Returns (index or -1, offset or 0)
    per session."""
    idx = torch.arange(MAX_WAYPOINTS, dtype=torch.int32,
                       device=wp_offsets.device)
    off = offset_px[:, None]
    cand = (wp_valid & (idx < num_waypoints[:, None])
            & (wp_offsets <= off) & (off - wp_offsets <= MV_LIMIT_PX)
            & (wp_offsets > 0))
    engaged = (offset_px > MV_LIMIT_PX) & (num_waypoints > 0)
    cand = cand & engaged[:, None]
    keyed = torch.where(cand, wp_offsets, -1)
    best = torch.argmax(keyed, dim=1)       # first index of the max
    found = keyed.max(dim=1).values >= 0
    best_off = torch.gather(wp_offsets, 1, best[:, None])[:, 0]
    return (torch.where(found, best.to(torch.int32), -1),
            torch.where(found, best_off, 0))


def _best_waypoint_b(offset_px, height, wp_offsets, wp_valid, num_waypoints):
    """First (lowest-index) waypoint with offset > current and delta within
    -MV_LIMIT_PX, engaged when B's direct MV would break the limit."""
    idx = torch.arange(MAX_WAYPOINTS, dtype=torch.int32,
                       device=wp_offsets.device)
    off = offset_px[:, None]
    cand = (wp_valid & (idx < num_waypoints[:, None])
            & (wp_offsets > off) & (off - wp_offsets >= -MV_LIMIT_PX))
    engaged = (offset_px - height < -MV_LIMIT_PX) & (num_waypoints > 0)
    cand = cand & engaged[:, None]
    best = torch.where(cand, idx, MAX_WAYPOINTS).min(dim=1).values
    found = best < MAX_WAYPOINTS
    safe = torch.where(found, best, 0)
    best_off = torch.gather(wp_offsets, 1, safe[:, None].to(torch.int64))[:, 0]
    return torch.where(found, safe, -1), torch.where(found, best_off, 0)


def region_params(cfg: ComposerConfig, offset_px, wp_offsets, wp_valid,
                  num_waypoints, is_waypoint_frame):
    """(a_ref, a_mv_px, b_ref, b_mv_px) int32[B] after waypoint
    redirection."""
    offset_px = _i32(offset_px, wp_offsets)
    wp_offsets = wp_offsets.to(torch.int32)
    wp_valid = wp_valid.to(torch.bool)
    num_waypoints = _i32(num_waypoints, wp_offsets)
    wp_a, wp_a_off = _best_waypoint_a(offset_px, wp_offsets, wp_valid,
                                      num_waypoints)
    wp_b, wp_b_off = _best_waypoint_b(offset_px, cfg.height, wp_offsets,
                                      wp_valid, num_waypoints)
    wp_b = torch.where(is_waypoint_frame, -1, wp_b)

    a_ref = torch.where(wp_a >= 0, 2 + wp_a, 0)
    a_mv = torch.where(wp_a >= 0, offset_px - wp_a_off, offset_px)
    b_ref = torch.where(wp_b >= 0, 2 + wp_b, 1)
    b_mv = torch.where(wp_b >= 0, offset_px - wp_b_off,
                       offset_px - cfg.height)
    return a_ref, a_mv, b_ref, b_mv


def mb_fields_traced(cfg: ComposerConfig, offset_px, wp_offsets, wp_valid,
                     num_waypoints, is_waypoint_frame,
                     boundary_policy: str = "floor"):
    """Per-MB (ref_idx, mv_y_qpel) grids [B, h, w]; `is_waypoint_frame` is
    a bool[B] (waypoint frames never redirect the B region).

    boundary_policy 'floor' reproduces the reference's MB-row seam
    (required for byte parity); 'nearest' rounds the seam to the closest
    MB row."""
    offset_px = _i32(offset_px, wp_offsets)
    h, w = cfg.mb_height, cfg.mb_width
    if boundary_policy == "floor":
        a_region_end = (cfg.height - offset_px) // 16
    elif boundary_policy == "nearest":
        a_region_end = (cfg.height - offset_px + 8) // 16
    else:
        # "partitioned" has no per-MB (ref, mv) grid: its seam row carries
        # two partitions (emit_partitioned_scroll_frame).
        raise ValueError(f"unknown boundary_policy {boundary_policy!r}")

    a_ref, a_mv, b_ref, b_mv = region_params(
        cfg, offset_px, wp_offsets, wp_valid, num_waypoints,
        torch.as_tensor(is_waypoint_frame, device=wp_offsets.device))

    row = torch.arange(h, dtype=torch.int32,
                       device=wp_offsets.device)[None, :, None]
    in_a = (row < a_region_end[:, None, None]).expand(-1, h, w)
    ref = torch.where(in_a, a_ref[:, None, None], b_ref[:, None, None])
    mv_y = torch.where(in_a, a_mv[:, None, None], b_mv[:, None, None]) * 4
    return ref, mv_y


def mb_fields(cfg: ComposerConfig, offset_px, wp_offsets, wp_valid,
              num_waypoints, *, is_waypoint_frame,
              boundary_policy: str = "floor"):
    """Per-MB (ref_idx, mv_y_qpel) grids for scroll or waypoint frames."""
    return mb_fields_traced(cfg, offset_px, wp_offsets, wp_valid,
                            num_waypoints,
                            torch.full((), bool(is_waypoint_frame),
                                       device=wp_offsets.device),
                            boundary_policy=boundary_policy)


# ---------------------------------------------------------------------------
# Frame emission.
# ---------------------------------------------------------------------------

def emit_p_frame(cfg: ComposerConfig, header_patterns, header_nbits,
                 ref, mv_x, mv_y, num_refs, nal_ref_idc,
                 *, enable_pskip: bool, ebsp_exact: bool = False,
                 compact_x: bool = False, rbsp_bits_per_mb: int = 0):
    """Symbols -> packed Annex-B NAL bytes for one P slice per session
    (p_frame_symbols, then finish_slice).

    Returns (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
    overflow bool[B]).
    """
    patterns, nbits, n_rbsp = p_frame_symbols(
        cfg, header_patterns, header_nbits, ref, mv_x, mv_y, num_refs,
        enable_pskip=enable_pskip, compact_x=compact_x,
        rbsp_bits_per_mb=rbsp_bits_per_mb)
    return finish_slice(patterns, nbits, n_rbsp, nal_ref_idc,
                        ebsp_exact=ebsp_exact)


def p_frame_symbols(cfg: ComposerConfig, header_patterns, header_nbits,
                    ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                    compact_x: bool = False, rbsp_bits_per_mb: int = 0):
    """The P slice's symbol stream per session, before the trailing bits.

    Per MB: [skip_run ue | mb_type ue(0) | ref te | mvd_x se | mvd_y se |
    cbp ue(0)], merged into 3 symbol slots (A = skip_run||mb_type||ref,
    B = mvd_x, C = mvd_y||cbp).  compact_x=True merges mvd_x into A (valid
    when every mv_x is zero, so mvd_x is the 1-bit se(0)): 2 slots.
    Frames over 4,095 MBs use the wide layout, where the skip run gets its
    own slot (ue(skip_run) no longer fits a merged 32-bit slot).
    rbsp_bits_per_mb overrides the working-buffer budget (0 = cfg's).
    The MB grid (prediction, P_Skip, skip runs, slots) is K6,
    ops/grid.scroll_grid_batch; the header and the tail skip run frame it.

    Returns (patterns int32[B, n] holding uint32 bits, nbits int32[B, n],
    n_rbsp).
    """
    h, w = ref.shape[1:]
    n_mbs = h * w
    if n_mbs > 65535:
        raise ValueError(f"emit_p_frame: {n_mbs} MBs > 65535 — ue(skip_run) "
                         "would exceed 32 bits; split the frame into bands")
    mb_patterns, mb_nbits, last_coded = grid.scroll_grid_batch(
        ref, mv_x, mv_y, num_refs, enable_pskip=enable_pskip,
        compact_x=compact_x)
    patterns, nbits = _slice_symbols(header_patterns, header_nbits,
                                     mb_patterns, mb_nbits, last_coded)
    return patterns, nbits, _n_rbsp(n_mbs, rbsp_bits_per_mb
                                    or cfg.rbsp_bits_per_mb)


def _slice_symbols(header_patterns, header_nbits, mb_patterns, mb_nbits,
                   last_coded):
    """Header, the MBs' slots [B, n_mbs, slots] and the trailing skip run
    after the last coded MB (`last_coded` [B], -1 for none; only if > 0)
    as one [B, n] symbol stream."""
    B, n_mbs = mb_patterns.shape[:2]
    tail_skips = n_mbs - 1 - last_coded
    ts_pat, ts_n = expgolomb.ue(tail_skips)
    ts_n = torch.where(tail_skips > 0, ts_n, 0)
    patterns = torch.cat([bitpack.as_u32_bits(header_patterns),
                          mb_patterns.reshape(B, -1), ts_pat[:, None]], dim=1)
    nbits = torch.cat([header_nbits.to(torch.int32),
                       mb_nbits.reshape(B, -1), ts_n[:, None]], dim=1)
    return patterns, nbits


def _n_rbsp(n_mbs: int, bits_per_mb: int) -> int:
    """RBSP working budget in bytes for n_mbs MBs (a multiple of 4)."""
    return (n_mbs * bits_per_mb // 8 + 96 + 3) // 4 * 4


def finish_slice(patterns, nbits, n_rbsp: int, nal_ref_idc,
                 *, ebsp_exact: bool = False, has_align: bool = False):
    """Shared slice tail: I_PCM alignment -> trailing bits -> pack ->
    emulation prevention -> Annex-B framing over [B, n] symbols.

    The bounded path is K1 (ops/emit_fused), which resolves the alignment
    sentinels (`has_align`: nbits < 0 are pcm_alignment_zero_bits) and
    appends the trailing-bits symbol itself.  The `ebsp_exact` retry path
    resolves the sentinels in plain torch, packs with K2
    (ops/bitpack_flat) and runs exact emulation prevention in plain
    torch.  Both kernels take their plain version for CPU tensors.
    Without `has_align` a negative width is out of contract and flags
    overflow on both paths.

    Returns (nal u8[B, n_nal], nal_len i32[B], rbsp_bits i32[B],
    overflow bool[B]).
    """
    if not ebsp_exact:
        return emit_fused.finish_nal_fused(
            patterns, nbits, n_rbsp, nal_ref_idc,
            max_insertions=MAX_EBSP_INSERTIONS, has_align=has_align,
            append_trailing=True)

    patterns = bitpack.as_u32_bits(patterns)
    nbits = nbits.to(torch.int32)
    B = nbits.shape[0]
    if has_align:
        nbits = emit_fused._resolve_align(nbits)
        bad = torch.zeros(B, dtype=torch.bool, device=nbits.device)
    else:
        bad = (nbits < 0).any(dim=1)
        nbits = nbits.clamp(min=0)
    tb_pat, tb_n = bitpack.trailing_bits_symbol(
        nbits.sum(dim=1, dtype=torch.int32))
    patterns = torch.cat([patterns, tb_pat[:, None]], dim=1)
    nbits = torch.cat([nbits, tb_n[:, None]], dim=1)

    words, total_bits = bitpack_flat.pack_words_place_batch(
        patterns, nbits, (n_rbsp + 3) // 4)
    rbsp_bytes = bitpack.words_to_bytes(words)[:, :n_rbsp]
    rbsp_len = total_bits // 8      # trailing bits guarantee alignment
    overflow = (total_bits > n_rbsp * 8) | bad

    # Output capacity covers the 1.5x worst case.
    n_nal = (5 + n_rbsp * 3 // 2 + 8 + 3) // 4 * 4
    ebsp_bytes, ebsp_len = ebsp.rbsp_to_ebsp(rbsp_bytes, rbsp_len, n_nal - 8)
    out = torch.zeros((B, n_nal), dtype=torch.uint8, device=nbits.device)
    out[:, 5:n_nal - 3] = ebsp_bytes
    out[:, :5] = emit_fused.nal_prefix(nal_ref_idc, B, nbits.device)
    return out, 5 + ebsp_len, total_bits, overflow


def emit_partitioned_scroll_frame(cfg: ComposerConfig, header_patterns,
                                  header_nbits, offset_px,
                                  a_ref, a_mv_px, b_ref, b_mv_px,
                                  num_refs, nal_ref_idc, *,
                                  enable_pskip: bool,
                                  ebsp_exact: bool = False):
    """Scroll P-frames with an 8 px-granular A/B seam.

    The reference floors the A/B boundary to MB rows while content moves
    per pixel, so up to 15 pixel rows at the seam fetch past their atlas.
    Here the straddled MB row is coded P_L0_L0_16x8: two 16x8 partitions
    with separate (ref, mv), the finest legal split across a seam whose
    two regions reference different pictures.  The row above is uniformly
    region A, so part 0's mvd is 0 except at the frame's top-left MB, and
    part 1's is b_mv at column 0 only.  Four symbol slots per MB (uniform
    MBs use three).

    Per-session [B] values: offset_px, the region parameters (from
    region_params), num_refs, nal_ref_idc.  Returns (nal u8[B, n_nal],
    nal_len i32[B], rbsp_bits i32[B], overflow bool[B]).
    """
    patterns, nbits, n_rbsp = partitioned_frame_symbols(
        cfg, header_patterns, header_nbits, offset_px, a_ref, a_mv_px,
        b_ref, b_mv_px, num_refs, enable_pskip=enable_pskip)
    return finish_slice(patterns, nbits, n_rbsp, nal_ref_idc,
                        ebsp_exact=ebsp_exact)


def partitioned_frame_symbols(cfg: ComposerConfig, header_patterns,
                              header_nbits, offset_px, a_ref, a_mv_px,
                              b_ref, b_mv_px, num_refs, *,
                              enable_pskip: bool):
    """emit_partitioned_scroll_frame before its back end: (patterns
    int32[B, n] holding uint32 bits, nbits int32[B, n], n_rbsp)."""
    h, w = cfg.mb_height, cfg.mb_width
    n_mbs = h * w
    # Same 32-bit merged-slot constraint as the narrow layout: the seam and
    # uniform A-slots both carry skip_run||mb_type(||ref).
    if n_mbs > 4095:
        raise ValueError(
            f"emit_partitioned_scroll_frame: {n_mbs} MBs > 4095 — merged "
            "skip-run slot would overflow 32 bits; use slice bands")
    B = header_patterns.shape[0]
    dev = header_patterns.device

    def per_session(x):                     # [B, 1, 1] for the grids
        return _i32(x, header_patterns).reshape(-1).expand(B)[:, None, None]

    a_ref, b_ref = per_session(a_ref), per_session(b_ref)
    a_mvq, b_mvq = per_session(a_mv_px) * 4, per_session(b_mv_px) * 4
    rows = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    cov = torch.clamp(cfg.height - per_session(offset_px) - 16 * rows, 0, 16)
    c_r = ((cov + 4) // 8) * 8             # rounded A-coverage: 0 | 8 | 16
    seam = (c_r == 8).expand(B, h, w)
    in_full_a = (c_r == 16).expand(B, h, w)

    ref_full = torch.where(in_full_a, a_ref, b_ref)
    mv_full = torch.where(in_full_a, a_mvq, b_mvq)
    zeros = torch.zeros((B, h, w), dtype=torch.int32, device=dev)

    # Role grids: a seam MB's top-right 4x4 (as-left role) is region A;
    # its bottom-left/bottom-right (as-above/above-left roles) region B,
    # which equals the full-value grid.
    ref_a_role = torch.where(seam, a_ref, ref_full)
    mv_a_role = torch.where(seam, a_mvq, mv_full)
    pred_x, pred_y = _pred_stencil_roles(
        ref_a_role, zeros, mv_a_role, ref_full, zeros, mv_full,
        ref_full, zeros, mv_full, ref_full)
    mvd_y = (mv_full - pred_y).reshape(B, n_mbs)
    mvd_x = (-pred_x).reshape(B, n_mbs)

    if enable_pskip:
        skip_x, skip_y = pskip_mv_grid(ref_full, zeros, mv_full)
        can_skip = ((ref_full == 0) & (skip_x == 0) & (mv_full == skip_y)
                    & ~seam)
    else:
        can_skip = torch.zeros((B, h, w), dtype=torch.bool, device=dev)
    coded = (~can_skip).reshape(B, n_mbs)
    skip_run, last_coded_incl = _skip_runs(coded)

    num_refs = _i32(num_refs, header_patterns).reshape(-1, 1)
    z = zeros.reshape(B, n_mbs)
    merge = bitpack.merge_symbol_pairs
    sr = expgolomb.ue(skip_run)
    cbp = expgolomb.ue(z)
    # Uniform-MB slots: [sr||mb_type(0)||ref, mvd_x, mvd_y||cbp, 0].
    u_a = merge(*merge(*sr, *expgolomb.ue(z)),
                *expgolomb.te(ref_full.reshape(B, n_mbs), num_refs))
    u_b = expgolomb.se(mvd_x)
    u_c = merge(*expgolomb.se(mvd_y), *cbp)
    # Seam-MB slots: [sr||mb_type(1), ref0||ref1||mvd0x(0), mvd0y,
    #                 mvd1x(0)||mvd1y||cbp(0)].
    se0 = expgolomb.se(z)
    s_a = merge(*sr, *expgolomb.ue(z + 1))
    s_b = merge(*merge(*expgolomb.te(a_ref.reshape(B, 1).expand(B, n_mbs),
                                     num_refs),
                       *expgolomb.te(b_ref.reshape(B, 1).expand(B, n_mbs),
                                     num_refs)),
                *se0)
    mvd0y = torch.where((rows == 0) & (cols == 0), a_mvq, zeros)
    mvd1y = torch.where(cols == 0, b_mvq, zeros)
    s_c = expgolomb.se(mvd0y.reshape(B, n_mbs))
    s_d = merge(*merge(*se0, *expgolomb.se(mvd1y.reshape(B, n_mbs))), *cbp)

    seam_f = seam.reshape(B, n_mbs)
    slots = [(u_a, s_a), (u_b, s_b), (u_c, s_c), ((z, z), s_d)]
    mb_patterns = torch.stack(
        [torch.where(coded, torch.where(seam_f, s[0], u[0]), 0)
         for u, s in slots], dim=2)
    mb_nbits = torch.stack(
        [torch.where(coded, torch.where(seam_f, s[1], u[1]), 0)
         for u, s in slots], dim=2)
    patterns, nbits = _slice_symbols(header_patterns, header_nbits,
                                     mb_patterns, mb_nbits,
                                     last_coded_incl[:, -1])
    return patterns, nbits, _n_rbsp(n_mbs, cfg.rbsp_bits_per_mb)


def _header(cfg, frame_num, is_reference, long_term_idx, num_waypoints,
            wp_ltidx, wp_valid):
    fn = torch.as_tensor(frame_num).to(torch.int32) % (1 << cfg.log2_max_frame_num)
    return p_slice_header_symbols(
        cfg, fn, fn * 2, is_reference=is_reference,
        long_term_idx=long_term_idx, num_waypoints=num_waypoints,
        wp_long_term_idx=wp_ltidx, wp_valid=wp_valid)


def unified_frame(cfg: ComposerConfig, frame_num, offset_px,
                  wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                  is_waypoint, *, enable_pskip: bool = False,
                  boundary_policy: str = "floor"):
    """One P-frame per session that is a waypoint reference iff
    `is_waypoint[b]`: the batched-serving kernel, one frame per step.
    Waypoint-dependent syntax (nal_ref_idc, MMCO self-marking, B-region
    redirection) selects on the flag.  Returns (nal u8[B, n_nal],
    nal_len i32[B], rbsp_bits i32[B], overflow bool[B])."""
    patterns, nbits, n_rbsp, nal_ref_idc = unified_frame_symbols(
        cfg, frame_num, offset_px, wp_offsets, wp_ltidx, wp_valid,
        num_waypoints, is_waypoint, enable_pskip=enable_pskip,
        boundary_policy=boundary_policy)
    return finish_slice(patterns, nbits, n_rbsp, nal_ref_idc)


def unified_frame_symbols(cfg: ComposerConfig, frame_num, offset_px,
                          wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                          is_waypoint, *, enable_pskip: bool = False,
                          boundary_policy: str = "floor"):
    """unified_frame up to its back end: (patterns int32[B, n] holding
    uint32 bits, nbits int32[B, n], n_rbsp, nal_ref_idc int32[B]), the
    inputs finish_slice takes."""
    is_waypoint = torch.as_tensor(is_waypoint, device=wp_offsets.device)
    num_waypoints = _i32(num_waypoints, wp_offsets)
    long_term_idx = torch.where(is_waypoint, 2 + num_waypoints, -1)
    hp, hn = _header(cfg, frame_num, is_waypoint, long_term_idx,
                     num_waypoints, wp_ltidx, wp_valid)
    nal_ref_idc = is_waypoint.to(torch.int32) * 2
    if boundary_policy == "partitioned":
        patterns, nbits, n_rbsp = partitioned_frame_symbols(
            cfg, hp, hn, offset_px,
            *region_params(cfg, offset_px, wp_offsets, wp_valid,
                           num_waypoints, is_waypoint),
            num_refs=2 + num_waypoints, enable_pskip=enable_pskip)
        return patterns, nbits, n_rbsp, nal_ref_idc
    ref, mv_y = mb_fields_traced(cfg, offset_px, wp_offsets, wp_valid,
                                 num_waypoints, is_waypoint,
                                 boundary_policy=boundary_policy)
    patterns, nbits, n_rbsp = p_frame_symbols(
        cfg, hp, hn, ref, torch.zeros_like(mv_y), mv_y,
        num_refs=2 + num_waypoints, enable_pskip=enable_pskip,
        compact_x=True, rbsp_bits_per_mb=SCROLL_FAST_RBSP_BITS_PER_MB)
    return patterns, nbits, n_rbsp, nal_ref_idc


def needs_waypoint(offset_px, wp_offsets, wp_valid, num_waypoints):
    """h264_needs_waypoint: offset is a nonzero multiple of MV_LIMIT_PX not
    yet registered.  bool[B]."""
    offset_px = _i32(offset_px, wp_offsets)
    idx = torch.arange(MAX_WAYPOINTS, dtype=torch.int32,
                       device=wp_offsets.device)
    exists = (wp_valid.to(torch.bool)
              & (idx < _i32(num_waypoints, wp_offsets)[:, None])
              & (wp_offsets == offset_px[:, None])).any(dim=1)
    return (offset_px != 0) & (offset_px % MV_LIMIT_PX == 0) & ~exists


def _scroll_or_waypoint(cfg, frame_num, offset_px, wp_offsets, wp_ltidx,
                        wp_valid, num_waypoints, *, waypoint: bool,
                        enable_pskip, boundary_policy, ebsp_exact):
    num_waypoints = _i32(num_waypoints, wp_offsets)
    hp, hn = _header(cfg, frame_num, waypoint,
                     2 + num_waypoints if waypoint else -1,
                     num_waypoints, wp_ltidx, wp_valid)
    nal_ref_idc = 2 if waypoint else 0
    if boundary_policy == "partitioned":
        return emit_partitioned_scroll_frame(
            cfg, hp, hn, offset_px,
            *region_params(cfg, offset_px, wp_offsets, wp_valid,
                           num_waypoints,
                           torch.full((), waypoint,
                                      device=wp_offsets.device)),
            num_refs=2 + num_waypoints, nal_ref_idc=nal_ref_idc,
            enable_pskip=enable_pskip, ebsp_exact=ebsp_exact)
    ref, mv_y = mb_fields(cfg, offset_px, wp_offsets, wp_valid,
                          num_waypoints, is_waypoint_frame=waypoint,
                          boundary_policy=boundary_policy)
    return emit_p_frame(cfg, hp, hn, ref, torch.zeros_like(mv_y), mv_y,
                        num_refs=2 + num_waypoints, nal_ref_idc=nal_ref_idc,
                        enable_pskip=enable_pskip, ebsp_exact=ebsp_exact,
                        compact_x=True,
                        rbsp_bits_per_mb=0 if ebsp_exact
                        else SCROLL_FAST_RBSP_BITS_PER_MB)


def scroll_frame(cfg: ComposerConfig, frame_num, offset_px,
                 wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                 *, enable_pskip: bool = False,
                 boundary_policy: str = "floor", ebsp_exact: bool = False):
    """One non-reference scroll P-frame per session (nal_ref_idc=0)."""
    return _scroll_or_waypoint(cfg, frame_num, offset_px, wp_offsets,
                               wp_ltidx, wp_valid, num_waypoints,
                               waypoint=False, enable_pskip=enable_pskip,
                               boundary_policy=boundary_policy,
                               ebsp_exact=ebsp_exact)


def waypoint_frame(cfg: ComposerConfig, frame_num, offset_px,
                   wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                   *, enable_pskip: bool = False,
                   boundary_policy: str = "floor", ebsp_exact: bool = False):
    """One reference waypoint P-frame per session (nal_ref_idc=2) that
    MMCO-marks itself long-term idx 2 + num_waypoints."""
    return _scroll_or_waypoint(cfg, frame_num, offset_px, wp_offsets,
                               wp_ltidx, wp_valid, num_waypoints,
                               waypoint=True, enable_pskip=enable_pskip,
                               boundary_policy=boundary_policy,
                               ebsp_exact=ebsp_exact)


def scroll_frame_sliced(cfg: ComposerConfig, frame_num, offset_px,
                        wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                        *, rows_per_slice: int,
                        enable_pskip: bool = False,
                        boundary_policy: str = "floor",
                        ebsp_exact: bool = False):
    """One scroll frame per session emitted as K = mb_height /
    rows_per_slice MB-row-aligned slices (first_mb_in_slice = band start):
    bands decode in parallel and packet loss stays contained.  The B*K
    bands are the rows of ONE back-end call (one K1 launch per frame).
    Returns (nals u8[B, K, n], lens i32[B, K], bits i32[B, K],
    overflow bool[B, K])."""
    patterns, nbits, n_rbsp = sliced_frame_symbols(
        cfg, frame_num, offset_px, wp_offsets, wp_ltidx, wp_valid,
        num_waypoints, rows_per_slice=rows_per_slice,
        enable_pskip=enable_pskip, boundary_policy=boundary_policy,
        ebsp_exact=ebsp_exact)
    out = finish_slice(patterns, nbits, n_rbsp, 0, ebsp_exact=ebsp_exact)
    K = cfg.mb_height // rows_per_slice
    return tuple(x.reshape((-1, K) + x.shape[1:]) for x in out)


def sliced_frame_symbols(cfg: ComposerConfig, frame_num, offset_px,
                         wp_offsets, wp_ltidx, wp_valid, num_waypoints,
                         *, rows_per_slice: int, enable_pskip: bool = False,
                         boundary_policy: str = "floor",
                         ebsp_exact: bool = False):
    """scroll_frame_sliced before its back end: (patterns int32[B*K, n]
    holding uint32 bits, nbits int32[B*K, n], n_rbsp), band k of session
    b in row b*K + k.

    H.264 does not predict across slice boundaries, and the stencils shift
    within each grid, so the [B, h, w] fields reshaped to [B*K, rows, w]
    predict band-locally, exactly."""
    if cfg.mb_height % rows_per_slice:
        raise ValueError("mb_height must divide by rows_per_slice")
    K = cfg.mb_height // rows_per_slice
    num_waypoints = _i32(num_waypoints, wp_offsets)
    ref, mv_y = mb_fields(cfg, offset_px, wp_offsets, wp_valid,
                          num_waypoints, is_waypoint_frame=False,
                          boundary_policy=boundary_policy)
    B = ref.shape[0]
    dev = wp_offsets.device

    def bands(a):
        return a.reshape(B * K, rows_per_slice, cfg.mb_width)

    def each_band(a):
        return torch.as_tensor(a, device=dev).repeat_interleave(K, dim=0)

    fn = (torch.as_tensor(frame_num, device=dev).to(torch.int32)
          % (1 << cfg.log2_max_frame_num))
    first_mb = (torch.arange(K, dtype=torch.int32, device=dev).repeat(B)
                * (rows_per_slice * cfg.mb_width))
    hp, hn = p_slice_header_symbols(
        cfg, each_band(fn), each_band(fn * 2), is_reference=False,
        long_term_idx=-1, num_waypoints=each_band(num_waypoints),
        wp_long_term_idx=each_band(wp_ltidx), wp_valid=each_band(wp_valid),
        first_mb=first_mb)
    mv_y = bands(mv_y)
    return p_frame_symbols(
        cfg, hp, hn, bands(ref), torch.zeros_like(mv_y), mv_y,
        num_refs=2 + each_band(num_waypoints), enable_pskip=enable_pskip,
        compact_x=True,
        rbsp_bits_per_mb=0 if ebsp_exact else SCROLL_FAST_RBSP_BITS_PER_MB)
