"""The per-MB grid stage of the symbol stages (K5, K6).

Both kernels replace XLA code of the JAX package, not a Pallas kernel:

  K5  `composite_grid_batch` — the splice steps' composite-grid stage,
      h264_scroll_encoder_tpu/models/splice_device.py `_dense_prologue`
      and `_bg3`: the role scatter of the donor rect into the background,
      the exact MV prediction over the composite roles, the composite
      coded mask and its skip-run scan, and the background symbol slots.
  K6  `scroll_grid_batch` — the MB grid of
      h264_scroll_encoder_tpu/models/scroll.py `emit_p_frame` (the port's
      models/scroll.p_frame_symbols): the MV prediction, the P_Skip test,
      the skip-run scan and the per-MB symbol slots of every scroll,
      waypoint, hint and session frame.

Each `*_batch` runs its plain version (`*_plain`, the torch code the
symbol stages ran before, and the tests' reference) for CPU tensors and
launches its CUDA kernel (csrc/grid_kernels.cu, `h264t_composite_grid`
and `h264t_scroll_grid`) for CUDA tensors; a build, plan or launch
failure raises.  A kernel runs a session in P row bands, one block a
band, the P blocks of a session a thread-block cluster; the library's
plan (`_kernels.grid_plan`) picks P from the batch and the card.  The
band arithmetic has a twin here (`band_rows`, `grid_items_per_thread`,
`grid_smem_bytes`, `plan_from_capacity`), and `*_split_plain` compute
the contract from P bands with their maxima carried across, as the
kernels do.  The kernels read every input in its own dtype and strides
(the donor roles' int8/int16/int32 wire dtypes, bool or uint8 coded
masks): nothing is converted first.  Outputs are int32 tensors (patterns hold
uint32 bits, ops/expgolomb's rule), allocated by the wrapper.

The H.264 8.4.1.3 MV-prediction stencils and the skip-run scan live here
too (models/scroll re-exports them): the plain versions are built from
them.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import NamedTuple

import torch

from .. import _kernels
from . import bitpack, expgolomb

# The nine composite role fields of a donor rect: *A supply a cell's value
# as the left neighbour, *B as above or above-right, *D as above-left.
ROLE_FIELDS = ("a_ref", "a_mvx", "a_mvy", "b_ref", "b_mvx", "b_mvy",
               "d_ref", "d_mvx", "d_mvy")
# The merged A slot (skip_run||mb_type||ref) fits 32 bits only up to this
# many MBs; larger frames use the wide layout (the skip run in its own
# slot), up to 65,535 MBs (ue(skip_run) of 32 bits; the callers refuse
# more, and so do the kernels).
NARROW_MAX_MBS = 4095

# The band plan (csrc/grid_device.cuh): the kernels as h264t_grid_plan names
# them, the row bands a session may take (P > 1: a thread-block cluster of
# P blocks; 16 is the non-portable size), the threads of a block and the
# most MBs of a thread's run.
GRID_COMPOSITE, GRID_SCROLL = 0, 1
PARTS = (1, 2, 4, 8, 16)
GRID_THREADS = 512
GRID_MAX_RUN = 31
# What a block costs the plan besides its band's MBs (kGridBlockMbs: the
# fixed part of a block's time on an H100, in MBs; csrc/grid_device.cuh).
GRID_BLOCK_MBS = 1024


# ---------------------------------------------------------------------------
# MV prediction stencils (H.264 8.4.1.3.1, 8.4.1.1) and the skip runs.
# ---------------------------------------------------------------------------

def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _shift(f, dy: int, dx: int):
    """out[..., r, c] = f[..., r - dy, c - dx], zero where out of range."""
    out = torch.zeros_like(f)
    h, w = f.shape[-2:]
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        f[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def _neighbors(field):
    """(A=left, B=above, C=above-right, D=above-left) shifted grids."""
    return (_shift(field, 0, 1), _shift(field, 1, 0), _shift(field, 1, -1),
            _shift(field, 1, 1))


def _pred_stencil(ref, mv_x, mv_y, cur_ref):
    """H.264 8.4.1.3.1 median MV prediction stencil (the C reference's
    get_mv_prediction decision tree); `cur_ref` is the reference index
    each MB predicts for."""
    return _pred_stencil_roles(ref, mv_x, mv_y, ref, mv_x, mv_y,
                               ref, mv_x, mv_y, cur_ref)


def _pred_stencil_roles(refA, mvxA, mvyA, refB, mvxB, mvyB,
                        refD, mvxD, mvyD, cur_ref):
    """Prediction stencil with role-specific neighbour values: *A grids
    supply a cell's value as the left neighbour (its top-right 4x4), *B as
    above or above-right (bottom-left 4x4), *D as above-left
    (bottom-right 4x4)."""
    h, w = refA.shape[-2:]
    dev = refA.device
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    row = torch.arange(h, dtype=torch.int32, device=dev)[:, None]

    ref_a, mvx_a, mvy_a = (_shift(g, 0, 1) for g in (refA, mvxA, mvyA))
    ref_b, mvx_b, mvy_b = (_shift(g, 1, 0) for g in (refB, mvxB, mvyB))
    ref_cr, mvx_cr, mvy_cr = (_shift(g, 1, -1) for g in (refB, mvxB, mvyB))
    ref_d, mvx_d, mvy_d = (_shift(g, 1, 1) for g in (refD, mvxD, mvyD))

    avail_a = col > 0
    avail_b = row > 0
    use_cr = (row > 0) & (col + 1 < w)          # above-right exists
    use_d = (row > 0) & (col > 0) & ~use_cr     # else above-left fallback
    avail_c = use_cr | use_d
    ref_c = torch.where(use_cr, ref_cr, ref_d)
    mvx_c = torch.where(use_cr, mvx_cr, mvx_d)
    mvy_c = torch.where(use_cr, mvy_cr, mvy_d)

    match_a = avail_a & (ref_a == cur_ref)
    match_b = avail_b & (ref_b == cur_ref)
    match_c = avail_c & (ref_c == cur_ref)
    n_avail = (avail_a.to(torch.int32) + avail_b.to(torch.int32)
               + avail_c.to(torch.int32))
    n_match = (match_a.to(torch.int32) + match_b.to(torch.int32)
               + match_c.to(torch.int32))
    only_a = avail_a & ~avail_b & ~avail_c

    def pick(vx_a, vx_b, vx_c):
        one_match = torch.where(match_a, vx_a,
                                torch.where(match_b, vx_b, vx_c))
        med = _median3(torch.where(avail_a, vx_a, 0),
                       torch.where(avail_b, vx_b, 0),
                       torch.where(avail_c, vx_c, 0))
        return torch.where(
            n_avail == 0, 0,
            torch.where(only_a, vx_a,
                        torch.where(n_match == 1, one_match, med)))

    return pick(mvx_a, mvx_b, mvx_c), pick(mvy_a, mvy_b, mvy_c)


def mv_pred_grid(ref, mv_x, mv_y):
    """Encoder-side prediction: each MB predicts for its own ref."""
    return _pred_stencil(ref, mv_x, mv_y, ref)


def mv_pred_grid_roles(cur_ref, refA, mvxA, mvyA, refB, mvxB, mvyB,
                       refD, mvxD, mvyD):
    """Encoder-side prediction with role-specific neighbour grids."""
    return _pred_stencil_roles(refA, mvxA, mvyA, refB, mvxB, mvyB,
                               refD, mvxD, mvyD, cur_ref)


def pskip_mv_grid(ref, mv_x, mv_y):
    """Decoder-side P_Skip MV derivation (H.264 8.4.1.1): zero when the
    left or above MB is unavailable or is ref 0 with a zero MV, else the
    median prediction for ref 0."""
    h, w = ref.shape[-2:]
    dev = ref.device
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    row = torch.arange(h, dtype=torch.int32, device=dev)[:, None]

    ref_a, ref_b, _, _ = _neighbors(ref)
    mvx_a, mvx_b, _, _ = _neighbors(mv_x)
    mvy_a, mvy_b, _, _ = _neighbors(mv_y)

    avail_a = col > 0
    avail_b = row > 0
    zero_a = avail_a & (ref_a == 0) & (mvx_a == 0) & (mvy_a == 0)
    zero_b = avail_b & (ref_b == 0) & (mvx_b == 0) & (mvy_b == 0)
    force_zero = (~avail_a) | (~avail_b) | zero_a | zero_b

    pred_x, pred_y = _pred_stencil(ref, mv_x, mv_y, torch.zeros_like(ref))
    return (torch.where(force_zero, 0, pred_x),
            torch.where(force_zero, 0, pred_y))


def _skip_runs(coded):
    """(mb_skip_run before each MB, index of the last coded MB up to each
    MB or -1) over coded bool[B, n]: the run before a coded MB is its
    distance to the previous coded MB."""
    B, n_mbs = coded.shape
    idx = torch.arange(n_mbs, dtype=torch.int32,
                       device=coded.device).expand(B, n_mbs)
    last_coded_incl = torch.cummax(torch.where(coded, idx, -1), dim=1).values
    last_coded_before = torch.cat(
        [torch.full_like(last_coded_incl[:, :1], -1),
         last_coded_incl[:, :-1]], dim=1)
    return idx - last_coded_before - 1, last_coded_incl


def _band_skip_runs(coded, bands):
    """_skip_runs as the kernels compute it: over coded bool[B, n] in bands
    of the raster (`bands`, [start, end) MB ranges in order), each band's
    own max-scan, with the lower bands' last coded MB carried in."""
    carry = torch.full((coded.shape[0], 1), -1, dtype=torch.int32,
                       device=coded.device)
    runs = []
    for i0, i1 in bands:
        idx = torch.arange(i0, i1, dtype=torch.int32,
                           device=coded.device).expand(carry.shape[0], -1)
        incl = torch.maximum(torch.cummax(
            torch.where(coded[:, i0:i1], idx, -1), dim=1).values, carry)
        before = torch.cat([carry, incl[:, :-1]], dim=1)
        runs.append(idx - before - 1)
        carry = incl[:, -1:]
    return torch.cat(runs, dim=1), carry[:, 0]


def _num_refs_column(num_refs, like):
    """num_refs (an int, a 0-dim, [B] or [B, 1] tensor) as te()'s
    argument against [B, n] values: an int stays an int, a tensor becomes
    int32 [B or 1, 1] on `like`'s device."""
    if isinstance(num_refs, numbers.Integral):
        return int(num_refs)
    return torch.as_tensor(num_refs, device=like.device).to(
        torch.int32).reshape(-1, 1)


def _mb_codes(ref_f, mvd_x, mvd_y, num_refs, skip_run, wide: bool):
    """The per-MB symbols of a P_L0_16x16 MB: (A, mvd_x, C) with A =
    skip_run||mb_type||ref (mb_type||ref in the wide layout), C =
    mvd_y||cbp, plus ue(skip_run); each a (pattern, nbits) pair over
    [B, n]."""
    zeros = torch.zeros_like(ref_f)
    sr = expgolomb.ue(skip_run)
    mbt = expgolomb.ue(zeros)
    ref = expgolomb.te(ref_f, num_refs)
    mvx = expgolomb.se(mvd_x)
    cbp = expgolomb.ue(zeros)
    merge = bitpack.merge_symbol_pairs
    a = merge(*mbt, *ref) if wide else merge(*merge(*sr, *mbt), *ref)
    c = merge(*expgolomb.se(mvd_y), *cbp)
    return a, mvx, c, sr


def _slots(cols, mask, shape):
    """Pattern and nbits grids [*shape, len(cols)] of (pattern, nbits)
    columns, zero where `mask` is False."""
    p = torch.stack([torch.where(mask, cp, 0) for cp, _ in cols], dim=2)
    n = torch.stack([torch.where(mask, cn, 0) for _, cn in cols], dim=2)
    return p.reshape(*shape, len(cols)), n.reshape(*shape, len(cols))


# ---------------------------------------------------------------------------
# The band plan's arithmetic: the twin of csrc/grid_device.cuh's, held equal
# to the built library's on the card (tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------

def band_rows(h: int, parts: int) -> list[tuple[int, int]]:
    """The MB rows [lo, hi) of each of `parts` bands over h rows (band_row
    in the kernels): whole rows, at least one a band where parts <= h."""
    return [(r * h // parts, (r + 1) * h // parts) for r in range(parts)]


def band_max_rows(h: int, parts: int) -> int:
    return -(-h // parts)


def grid_items_per_thread(h: int, w: int, parts: int) -> int:
    """MBs of a thread's run in the longest band, odd (grid_items)."""
    return -(-band_max_rows(h, parts) * w // GRID_THREADS) | 1


def grid_smem_bytes(kind: int, h: int, w: int, parts: int) -> int:
    """A block's dynamic shared memory (grid_smem_words): the staged fields
    (K5 the nine composite role grids, K6 ref, mv_x, mv_y) over the longest
    band and its halo row, a word an MB of the band, and the chunk buffers
    of the outputs (pattern and width; K5 4, 2 and 1 slots an MB, K6 up to
    4), each rounded to 16 bytes."""
    def round4(x):
        return (x + 3) & ~3

    def chunk(slots):
        return GRID_THREADS * slots + 4

    rows = band_max_rows(h, parts)
    staged = round4((rows + 1) * w)
    if kind == GRID_COMPOSITE:
        words = 9 * staged + 2 * (chunk(4) + chunk(2) + chunk(1))
    else:
        words = 3 * staged + 2 * chunk(4)
    return 4 * (words + round4(rows * w))


def allowed_parts(h: int, w: int) -> tuple[int, ...]:
    """The P a launch takes for an h x w frame (valid_parts): at least one
    row a band and a thread's run within GRID_MAX_RUN MBs.  (Whether the
    band fits a block is the card's to say: grid_smem_bytes.)"""
    return tuple(p for p in PARTS
                 if p <= h and grid_items_per_thread(h, w, p) <= GRID_MAX_RUN)


def plan_from_capacity(batch: int, h: int, w: int, capacity: dict) -> int:
    """The plan's rule (grid_plan) given {P: blocks of that plan the card
    holds at once} for P up to h: blocks past the capacity wait for
    another wave and a block costs its band's MBs plus GRID_BLOCK_MBS, so
    P costs ceil(batch * P / capacity) * (band_max_rows(h, P) * w +
    GRID_BLOCK_MBS); the P of least cost, the smallest of equals; 0 where
    nothing fits."""
    best = best_cost = 0
    for p in sorted(capacity):
        if capacity[p] <= 0:
            continue
        waves = -(-batch * p // capacity[p])
        cost = waves * (band_max_rows(h, p) * w + GRID_BLOCK_MBS)
        if best == 0 or cost < best_cost:
            best, best_cost = p, cost
    return best


def _check_parts(what: str, h: int, w: int, parts: int) -> None:
    if parts not in allowed_parts(h, w):
        raise ValueError(f"{what}: {parts} bands do not split a {h}x{w}-MB "
                         f"frame (allowed: {allowed_parts(h, w)})")


def _no_parts_on_cpu(what: str, parts) -> None:
    if parts is not None:
        raise ValueError(f"{what}: parts= forces the kernel's bands on CUDA "
                         f"tensors; on CPU tensors the plain version runs "
                         f"(the bands' model is *_split_plain)")


def _grid_parts(kind: int, what: str, B: int, h: int, w: int, parts):
    """The bands a launch takes: `parts` where a test forces it, else the
    library's plan; a shape no plan fits raises before any launch."""
    if parts is not None:
        _check_parts(what, h, w, parts)
        return parts
    planned = _kernels.grid_plan(h * w, w, B, kind)
    if planned == 0:
        raise RuntimeError(
            f"{what}: no band plan fits a {h}x{w}-MB frame at B = {B} (a "
            f"band of {band_max_rows(h, min(h, PARTS[-1])) * w} MBs or more "
            f"passes one block's shared memory)")
    return planned


def _wide_count(n_mbs: int):
    """The tracer's count of a K5 or K6 launch: `grid.wide_launches` on the
    wide layout."""
    return {"grid.wide_launches": 1} if n_mbs > NARROW_MAX_MBS else None


# ---------------------------------------------------------------------------
# K6: the scroll MB grid.
# ---------------------------------------------------------------------------

def scroll_slots(n_mbs: int, compact_x: bool) -> int:
    """Symbol slots a MB of p_frame_symbols: A, mvd_x, C (A||mvd_x and C
    with compact_x), plus the skip run's own slot in the wide layout."""
    return (2 if compact_x else 3) + (n_mbs > NARROW_MAX_MBS)


def _scroll_mb_values(ref, mv_x, mv_y, enable_pskip: bool):
    """(mvd_x, mvd_y, coded) [B, h, w] of int32 fields: the MV difference
    against the prediction and whether the MB is coded (not P_Skip)."""
    pred_x, pred_y = mv_pred_grid(ref, mv_x, mv_y)
    if enable_pskip:
        skip_x, skip_y = pskip_mv_grid(ref, mv_x, mv_y)
        coded = ~((ref == 0) & (mv_x == skip_x) & (mv_y == skip_y))
    else:
        coded = torch.ones(ref.shape, dtype=torch.bool, device=ref.device)
    return mv_x - pred_x, mv_y - pred_y, coded


def _scroll_out(ref, mvd_x, mvd_y, coded, skip_run, last, num_refs,
                compact_x: bool):
    """K6's returns from the per-MB values ([B, h, w]), the skip runs
    [B, n] and the last coded MBs [B]."""
    B, h, w = ref.shape
    n_mbs = h * w
    a, mvx, c, sr = _mb_codes(ref.reshape(B, n_mbs), mvd_x.reshape(B, n_mbs),
                              mvd_y.reshape(B, n_mbs),
                              _num_refs_column(num_refs, ref), skip_run,
                              n_mbs > NARROW_MAX_MBS)
    cols = ([bitpack.merge_symbol_pairs(*a, *mvx), c] if compact_x
            else [a, mvx, c])
    if n_mbs > NARROW_MAX_MBS:
        cols = [sr] + cols
    mb_patterns, mb_nbits = _slots(cols, coded.reshape(B, n_mbs), (B, n_mbs))
    return mb_patterns, mb_nbits, last


def scroll_grid_plain(ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                      compact_x: bool = False):
    """Plain version of K6: the MB grid of p_frame_symbols over [B, h, w]
    fields (ref, mv_x, mv_y in any integer dtype; the math is int32).
    Returns (mb_patterns int32[B, h*w, S] holding uint32 bits, mb_nbits
    int32[B, h*w, S], last_coded int32[B]: the last coded MB or -1), S =
    scroll_slots(h*w, compact_x); an MB that is P_Skip has zero-width
    slots.  num_refs: an int, or a [B] or [B, 1] tensor."""
    B, h, w = ref.shape
    ref, mv_x, mv_y = (g.to(torch.int32) for g in (ref, mv_x, mv_y))
    mvd_x, mvd_y, coded = _scroll_mb_values(ref, mv_x, mv_y, enable_pskip)
    skip_run, last_coded_incl = _skip_runs(coded.reshape(B, h * w))
    return _scroll_out(ref, mvd_x, mvd_y, coded, skip_run,
                       last_coded_incl[:, -1], num_refs, compact_x)


def _band_values(fn, h: int, parts: int, *grids):
    """fn(*grids) computed band by band as a block stages it: each band's
    rows with the row above it (the halo; none above row 0), fn's [B, rows,
    w] results cut back to the band, then joined."""
    pieces = []
    for lo, hi in band_rows(h, parts):
        ra = max(lo - 1, 0)
        pieces.append([v[:, lo - ra:] for v in fn(ra, hi, *(g[:, ra:hi]
                                                            for g in grids))])
    return [torch.cat(vs, dim=1) for vs in zip(*pieces)]


def scroll_grid_split_plain(ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                            compact_x: bool = False, parts: int):
    """scroll_grid_plain computed as K6 computes it in `parts` row bands
    (band_rows): each band's stencil from its rows and halo, each band's
    skip-run scan with the lower bands' last coded MB carried in.  Equal to
    scroll_grid_plain for every P in allowed_parts(h, w)."""
    B, h, w = ref.shape
    _check_parts("K6", h, w, parts)
    ref, mv_x, mv_y = (g.to(torch.int32) for g in (ref, mv_x, mv_y))
    mvd_x, mvd_y, coded = _band_values(
        lambda _ra, _hi, *g: _scroll_mb_values(*g, enable_pskip), h, parts,
        ref, mv_x, mv_y)
    skip_run, last = _band_skip_runs(
        coded.reshape(B, h * w),
        [(lo * w, hi * w) for lo, hi in band_rows(h, parts)])
    return _scroll_out(ref, mvd_x, mvd_y, coded, skip_run, last, num_refs,
                       compact_x)


def scroll_grid_batch(ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                      compact_x: bool = False, parts: int | None = None):
    """K6 over a batch: scroll_grid_plain for CPU tensors, the CUDA kernel
    h264t_scroll_grid for CUDA tensors, with the same arguments and
    returns.  The kernel reads the fields and a num_refs tensor in their
    own dtypes and strides, each session in the bands the plan gives.
    `parts` (tests only) forces the kernel's bands; CPU tensors refuse it
    (scroll_grid_split_plain is the bands' model there)."""
    B, h, w = ref.shape
    _same_shape("scroll grid", (B, h, w), mv_x=mv_x, mv_y=mv_y)
    if _device_of(ref, mv_x, mv_y) == "cpu":
        _no_parts_on_cpu("scroll_grid_batch", parts)
        return scroll_grid_plain(ref, mv_x, mv_y, num_refs,
                                 enable_pskip=enable_pskip,
                                 compact_x=compact_x)
    dev = ref.device
    n_mbs = h * w
    S = scroll_slots(n_mbs, compact_x)
    with torch.cuda.device(dev):
        P = _grid_parts(GRID_SCROLL, "K6", B, h, w, parts) if B else 1
        mb_p = torch.empty((B, n_mbs, S), dtype=torch.int32, device=dev)
        mb_n = torch.empty((B, n_mbs, S), dtype=torch.int32, device=dev)
        last = torch.empty((B,), dtype=torch.int32, device=dev)
        nr, nr_field, nr_value = _num_refs_field(num_refs, B, dev)
        fields = _descriptors([_field(g) for g in (ref, mv_x, mv_y)]
                              + [nr_field])
        if B:
            _kernels.SCROLL_GRID.launch(
                fields, B, h, w, nr_value, int(n_mbs > NARROW_MAX_MBS),
                int(compact_x), int(enable_pskip), P, mb_p.data_ptr(),
                mb_n.data_ptr(), last.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
                counts=_wide_count(n_mbs))
    del nr      # kept alive until the launch is queued
    return mb_p, mb_n, last


# ---------------------------------------------------------------------------
# K5: the splice steps' composite grid.
# ---------------------------------------------------------------------------

class CompositeGrid(NamedTuple):
    """K5's outputs, what the splice layouts read (int32; patterns hold
    uint32 bits):

      bg_p, bg_n   [B, H, W, S_bg] background MB slots (_bg3): A =
                   skip_run||mb_type||ref, mvd_x, C = mvd_y||cbp (S_bg =
                   3), or [skip_run, mb_type||ref, mvd_x, C] in the wide
                   layout (S_bg = 4); zero unless the MB is a coded
                   background MB.
      bg2_p, bg2_n [B, H, W, 2] the compact_x form [A||mvd_x, C] under the
                   same mask, or None without compact_x.
      sr_pat, sr_n [B, H*W] ue(composite skip run before each MB), at
                   every MB: the rows step gathers it at each rect row's
                   first coded donor MB, the dense step at its donor MBs.
      last         [B] the last coded MB of the composite, or -1 (the
                   tail skip run).
    """
    bg_p: torch.Tensor
    bg_n: torch.Tensor
    bg2_p: torch.Tensor | None
    bg2_n: torch.Tensor | None
    sr_pat: torch.Tensor
    sr_n: torch.Tensor
    last: torch.Tensor


def _rect_mask(H, W, r0, c0, R, C, device):
    m = torch.zeros((H, W), dtype=torch.bool, device=device)
    m[r0:r0 + R, c0:c0 + C] = True
    return m


def _check_composite(H, W, r0, c0, R, C, compact_x):
    if r0 < 0 or c0 < 0 or R < 1 or C < 1 or r0 + R > H or c0 + C > W:
        raise ValueError("the donor rect does not fit the frame")
    if compact_x and H * W > NARROW_MAX_MBS:
        raise ValueError("compact_x needs <= 4095 MBs (the merged "
                         "skip-run slot); use compact_x=False")


def _composite_mb_values(r0, c0, R, C, bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                         roles, donor_coded):
    """(mvd_x, mvd_y, coded) [B, H, W] of a composite: the int32
    background's MV difference against the prediction over the composite
    roles (the nine int32 [B, R, C] `roles` scattered into the rect, the
    background outside; cur_ref is the A-role composite) and the composite
    coded mask (the donor's bool [B, R, C] inside the rect).  R may be 0."""
    def scatter(bg, vals):
        g = bg.clone()
        g[:, r0:r0 + R, c0:c0 + C] = vals
        return g

    bg = (bg_ref, bg_mv_x, bg_mv_y) * 3
    refA, mvxA, mvyA, refB, mvxB, mvyB, refD, mvxD, mvyD = (
        scatter(g, v) for g, v in zip(bg, roles))
    coded = bg_coded & ~_rect_mask(*bg_ref.shape[1:], r0, c0, R, C,
                                   bg_ref.device)
    coded[:, r0:r0 + R, c0:c0 + C] = donor_coded
    pred_x, pred_y = mv_pred_grid_roles(
        refA, refA, mvxA, mvyA, refB, mvxB, mvyB, refD, mvxD, mvyD)
    return bg_mv_x - pred_x, bg_mv_y - pred_y, coded


def _composite_inputs(R, C, bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn):
    """The background as int32 grids and a bool mask, the donor's nine role
    fields as int32 [B, R, C] and its coded mask as bool [B, R, C]."""
    B = bg_ref.shape[0]
    bg = tuple(g.to(torch.int32) for g in (bg_ref, bg_mv_x, bg_mv_y))
    roles = [dn[k].to(torch.int32).reshape(B, R, C) for k in ROLE_FIELDS]
    return (*bg, bg_coded.to(torch.bool), roles,
            dn["coded"].to(torch.bool).reshape(B, R, C))


def _composite_out(r0, c0, R, C, num_refs, bg_ref, mvd_x, mvd_y, coded,
                   skip_run, last, compact_x) -> CompositeGrid:
    """K5's returns from the per-MB values [B, H, W], the skip runs [B, n]
    and the last coded MBs [B]."""
    B, H, W = bg_ref.shape
    n_mbs = H * W
    a, mvx, c, sr = _mb_codes(
        bg_ref.reshape(B, n_mbs), mvd_x.reshape(B, n_mbs),
        mvd_y.reshape(B, n_mbs), _num_refs_column(num_refs, bg_ref),
        skip_run, n_mbs > NARROW_MAX_MBS)
    active = coded.reshape(B, n_mbs) & ~_rect_mask(
        H, W, r0, c0, R, C, bg_ref.device).reshape(1, n_mbs)
    bg_p, bg_n = _slots(([sr] if n_mbs > NARROW_MAX_MBS else []) + [a, mvx, c],
                        active, (B, H, W))
    bg2_p = bg2_n = None
    if compact_x:
        bg2_p, bg2_n = _slots([bitpack.merge_symbol_pairs(*a, *mvx), c],
                              active, (B, H, W))
    return CompositeGrid(bg_p, bg_n, bg2_p, bg2_n, sr[0], sr[1], last)


def composite_grid_plain(r0: int, c0: int, R: int, C: int, num_refs,
                         bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn: dict, *,
                         compact_x: bool = False) -> CompositeGrid:
    """Plain version of K5 over [B, H, W] background fields (ref, mv qpel,
    coded) and the donor rect's nine composite roles and coded mask
    (`dn[ROLE_FIELDS]`, `dn["coded"]`, each B * R * C values in any
    integer dtype; the math is int32, as the JAX package's): the role
    scatter, the exact MV prediction (cur_ref is the A-role composite),
    mvd against the background's own MV, the composite coded mask, its
    skip runs and the background slots.  num_refs: an int, or a [B] or
    [B, 1] tensor."""
    B, H, W = bg_ref.shape
    _check_composite(H, W, r0, c0, R, C, compact_x)
    ref, mv_x, mv_y, coded_bg, roles, donor_coded = _composite_inputs(
        R, C, bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn)
    mvd_x, mvd_y, coded = _composite_mb_values(
        r0, c0, R, C, ref, mv_x, mv_y, coded_bg, roles, donor_coded)
    skip_run, last_incl = _skip_runs(coded.reshape(B, H * W))
    return _composite_out(r0, c0, R, C, num_refs, ref, mvd_x, mvd_y, coded,
                          skip_run, last_incl[:, -1], compact_x)


def composite_grid_split_plain(r0: int, c0: int, R: int, C: int, num_refs,
                               bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn: dict,
                               *, compact_x: bool = False,
                               parts: int) -> CompositeGrid:
    """composite_grid_plain computed as K5 computes it in `parts` row bands
    (band_rows): each band's composite roles and stencil from its rows and
    halo (the rect's rows among them), each band's skip-run scan with the
    lower bands' last coded MB carried in.  Equal to composite_grid_plain
    for every P in allowed_parts(H, W)."""
    B, H, W = bg_ref.shape
    _check_composite(H, W, r0, c0, R, C, compact_x)
    _check_parts("K5", H, W, parts)
    ref, mv_x, mv_y, coded_bg, roles, donor_coded = _composite_inputs(
        R, C, bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn)

    def band(ra, hi, *grids):
        qa, qb = max(ra, r0), max(min(hi, r0 + R), max(ra, r0))
        return _composite_mb_values(
            qa - ra, c0, qb - qa, C, *grids,
            [x[:, qa - r0:qb - r0] for x in roles],
            donor_coded[:, qa - r0:qb - r0])

    mvd_x, mvd_y, coded = _band_values(band, H, parts, ref, mv_x, mv_y,
                                       coded_bg)
    skip_run, last = _band_skip_runs(
        coded.reshape(B, H * W),
        [(lo * W, hi * W) for lo, hi in band_rows(H, parts)])
    return _composite_out(r0, c0, R, C, num_refs, ref, mvd_x, mvd_y, coded,
                          skip_run, last, compact_x)


def composite_grid_batch(r0: int, c0: int, R: int, C: int, num_refs,
                         bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn: dict, *,
                         compact_x: bool = False,
                         parts: int | None = None) -> CompositeGrid:
    """K5 over a batch: composite_grid_plain for CPU tensors, the CUDA
    kernel h264t_composite_grid for CUDA tensors, with the same arguments
    and returns.  The kernel reads the background grids, the nine role
    fields and both coded masks in their own dtypes and strides, composes
    the role grids of each band in shared memory and writes no scattered
    grid.  `parts` (tests only) forces the kernel's bands a session; CPU
    tensors refuse it (composite_grid_split_plain is the bands' model
    there)."""
    B, H, W = bg_ref.shape
    _same_shape("composite grid", (B, H, W), bg_mv_x=bg_mv_x,
                bg_mv_y=bg_mv_y, bg_coded=bg_coded)
    donor = [dn[k] for k in ROLE_FIELDS + ("coded",)]
    if _device_of(bg_ref, bg_mv_x, bg_mv_y, bg_coded, *donor) == "cpu":
        _no_parts_on_cpu("composite_grid_batch", parts)
        return composite_grid_plain(r0, c0, R, C, num_refs, bg_ref, bg_mv_x,
                                    bg_mv_y, bg_coded, dn,
                                    compact_x=compact_x)
    _check_composite(H, W, r0, c0, R, C, compact_x)
    dev = bg_ref.device
    n_mbs = H * W
    wide = n_mbs > NARROW_MAX_MBS
    for name, x in zip(ROLE_FIELDS + ("coded",), donor):
        if x.numel() != B * R * C:
            raise ValueError(f"donor field {name} has {x.numel()} values, "
                             f"not B * R * C = {B * R * C}")
    S = 4 if wide else 3
    with torch.cuda.device(dev):
        P = _grid_parts(GRID_COMPOSITE, "K5", B, H, W, parts) if B else 1

    def out(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    bg_p, bg_n = out(B, H, W, S), out(B, H, W, S)
    bg2_p = bg2_n = None
    if compact_x:
        bg2_p, bg2_n = out(B, H, W, 2), out(B, H, W, 2)
    sr_p, sr_n, last = out(B, n_mbs), out(B, n_mbs), out(B)
    nr, nr_field, nr_value = _num_refs_field(num_refs, B, dev)
    donor = [x.reshape(B, R, C) for x in donor]
    fields = _descriptors(
        [_field(g) for g in (bg_ref, bg_mv_x, bg_mv_y, bg_coded)]
        + [_field(x) for x in donor] + [nr_field])
    if B:
        with torch.cuda.device(dev):
            _kernels.COMPOSITE_GRID.launch(
                fields, B, H, W, r0, c0, R, C, nr_value, int(wide),
                int(compact_x), P, bg_p.data_ptr(), bg_n.data_ptr(),
                0 if bg2_p is None else bg2_p.data_ptr(),
                0 if bg2_n is None else bg2_n.data_ptr(),
                sr_p.data_ptr(), sr_n.data_ptr(), last.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
                counts=_wide_count(n_mbs))
    del nr, donor   # kept alive until the launch is queued
    return CompositeGrid(bg_p, bg_n, bg2_p, bg2_n, sr_p, sr_n, last)


def _read_bytes(reads) -> int:
    """Bytes of the reads [(tensor, mask of the elements read or None for
    all)], each element read once: reads of one tensor (one address,
    dtype, shape and strides; the main paths pass one zero grid as the
    background's ref, mv_x and mv_y) are counted once, their masks
    joined."""
    seen = {}
    for x, mask in reads:
        if not isinstance(x, torch.Tensor):
            continue
        key = (x.data_ptr(), x.dtype, tuple(x.shape), x.stride())
        if mask is not None:
            mask = mask.reshape(x.shape)
        if key in seen:
            mask = None if seen[key][1] is None or mask is None \
                else seen[key][1] | mask
        seen[key] = (x, mask)
    return sum((x.numel() if m is None else int(m.sum())) * x.element_size()
               for x, m in seen.values())


def _written_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def _num_refs_read(num_refs, sessions):
    """num_refs's read: te() runs only for a session's live MBs, so a
    tensor is read at the sessions with one (`sessions`, bool [B])."""
    if not isinstance(num_refs, torch.Tensor):
        return []
    return [(num_refs, sessions.reshape(num_refs.shape)
             if num_refs.numel() == sessions.numel() else sessions.any())]


def composite_grid_bytes(r0: int, c0: int, R: int, C: int, num_refs, bg_ref,
                         bg_mv_x, bg_mv_y, bg_coded, dn: dict,
                         out: CompositeGrid) -> int:
    """Bytes a K5 call must move at this call's data: the coded masks (the
    donor's, the background's outside the rect) read once, every output
    written once, and the MVs and refs only where a live MB (coded,
    outside the rect: its slots are not zero-width) needs them: its own
    from the background, its neighbours' (8.4.1.3.1: left in the A role,
    above and above-right in B, above-left in D where above-right is
    outside the frame) from the background or, inside the rect, from the
    donor's role fields.  On the splice steps' all-skip background no MB
    is live and no MV or ref is read."""
    B, H, W = bg_ref.shape
    live = (out.bg_n != 0).any(dim=-1)
    # Where an MB is the left (A), above or above-right (B) or above-left
    # (D) neighbour of a live MB.
    col = torch.arange(W, device=live.device)
    need = {"a": _shift(live, 0, -1),
            "b": _shift(live, -1, 0) | _shift(live, -1, 1),
            "d": _shift(live, -1, -1) & (col == W - 2)}
    rect = _rect_mask(H, W, r0, c0, R, C, live.device)
    bg_need = live | ((need["a"] | need["b"] | need["d"]) & ~rect)
    reads = [(bg_coded, ~rect.expand(B, H, W)), (dn["coded"], None),
             *((g, bg_need) for g in (bg_ref, bg_mv_x, bg_mv_y)),
             *((dn[k], need[k[0]][:, r0:r0 + R, c0:c0 + C])
               for k in ROLE_FIELDS),
             *_num_refs_read(num_refs, live.flatten(1).any(dim=1))]
    return _read_bytes(reads) + _written_bytes(out)


def scroll_grid_bytes(ref, mv_x, mv_y, num_refs, out) -> int:
    """Bytes a K6 call must move: the three fields read once (every MB's
    prediction and P_Skip test reads its own and its neighbours'), a
    num_refs tensor at the sessions with a coded MB, its slots and last
    coded MBs written once."""
    coded = (out[1] != 0).flatten(1).any(dim=1)
    return (_read_bytes([(ref, None), (mv_x, None), (mv_y, None),
                         *_num_refs_read(num_refs, coded)])
            + _written_bytes(out))


# ---------------------------------------------------------------------------
# What the wrappers hand the kernels.
# ---------------------------------------------------------------------------

# The dtype codes of csrc/grid_device.cuh's Field: the element size,
# negative for an unsigned byte (uint8 and bool).
_DTYPE_CODES = {torch.int8: 1, torch.uint8: -1, torch.bool: -1,
                torch.int16: 2, torch.int32: 4, torch.int64: 8}


def _same_shape(what, shape, **grids):
    for name, g in grids.items():
        if tuple(g.shape) != shape:
            raise ValueError(f"{what}: {name} is {tuple(g.shape)}, not "
                             f"{shape}")


def _device_of(*xs) -> str:
    """"cpu" or "cuda" for the tensors among xs, which must share one
    device; a tensor on another device raises (no silent copy)."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"the grid stage's tensors must share one device, "
                         f"not {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _field(x) -> tuple[int, int, int, int, int]:
    """(address, batch, row and column strides in bytes, dtype code) of a
    [B, rows, cols] tensor, read in place."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the grid kernels read integer or bool tensors, "
                        f"not {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected a [B, rows, cols] tensor, not "
                         f"{tuple(x.shape)}")
    e = x.element_size()
    return (x.data_ptr(), x.stride(0) * e, x.stride(1) * e, x.stride(2) * e,
            _DTYPE_CODES[x.dtype])


def _num_refs_field(num_refs, B: int, dev):
    """(tensor, field, value) of num_refs for the kernels: an int is
    passed by value (field address 0); a tensor of 1 or B values (0-dim,
    [B] or [B, 1]) is read on `dev` in place (moved there first, as te()
    moves it, if it lies elsewhere), session b's at b times its stride.
    The caller keeps the tensor until the launch is queued."""
    if isinstance(num_refs, numbers.Integral):
        return None, (0, 0, 0, 0, 4), int(num_refs)
    t = torch.as_tensor(num_refs, device=dev).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"num_refs has {t.numel()} values for {B} sessions")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"num_refs must be an integer tensor, not {t.dtype}")
    stride = 0 if t.numel() == 1 else t.stride(0) * t.element_size()
    return t, (t.data_ptr(), stride, 0, 0, _DTYPE_CODES[t.dtype]), 0


def _descriptors(fields):
    """The fields as the host array of int64 the entry points take."""
    flat = [v for f in fields for v in f]
    return (ctypes.c_longlong * len(flat))(*flat)
