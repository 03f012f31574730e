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
and `h264t_scroll_grid`) for CUDA tensors; a build or launch failure
raises.  The kernels read every input in its own dtype and strides (the
donor roles' int8/int16/int32 wire dtypes, bool or uint8 coded masks):
nothing is converted first.  Outputs are int32 tensors (patterns hold
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
# K6: the scroll MB grid.
# ---------------------------------------------------------------------------

def scroll_slots(n_mbs: int, compact_x: bool) -> int:
    """Symbol slots a MB of p_frame_symbols: A, mvd_x, C (A||mvd_x and C
    with compact_x), plus the skip run's own slot in the wide layout."""
    return (2 if compact_x else 3) + (n_mbs > NARROW_MAX_MBS)


def scroll_grid_plain(ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                      compact_x: bool = False):
    """Plain version of K6: the MB grid of p_frame_symbols over [B, h, w]
    fields (ref, mv_x, mv_y in any integer dtype; the math is int32).
    Returns (mb_patterns int32[B, h*w, S] holding uint32 bits, mb_nbits
    int32[B, h*w, S], last_coded int32[B]: the last coded MB or -1), S =
    scroll_slots(h*w, compact_x); an MB that is P_Skip has zero-width
    slots.  num_refs: an int, or a [B] or [B, 1] tensor."""
    B, h, w = ref.shape
    n_mbs = h * w
    wide = n_mbs > NARROW_MAX_MBS
    ref = ref.to(torch.int32)
    mv_x = mv_x.to(torch.int32)
    mv_y = mv_y.to(torch.int32)

    pred_x, pred_y = mv_pred_grid(ref, mv_x, mv_y)
    mvd_x = (mv_x - pred_x).reshape(B, n_mbs)
    mvd_y = (mv_y - pred_y).reshape(B, n_mbs)
    ref_f = ref.reshape(B, n_mbs)

    if enable_pskip:
        skip_x, skip_y = pskip_mv_grid(ref, mv_x, mv_y)
        can_skip = ((ref == 0) & (mv_x == skip_x)
                    & (mv_y == skip_y)).reshape(B, n_mbs)
    else:
        can_skip = torch.zeros((B, n_mbs), dtype=torch.bool, device=ref.device)
    coded = ~can_skip
    skip_run, last_coded_incl = _skip_runs(coded)

    a, mvx, c, sr = _mb_codes(ref_f, mvd_x, mvd_y,
                              _num_refs_column(num_refs, ref), skip_run, wide)
    if compact_x:
        cols = [bitpack.merge_symbol_pairs(*a, *mvx), c]
    else:
        cols = [a, mvx, c]
    if wide:
        cols = [sr] + cols
    mb_patterns, mb_nbits = _slots(cols, coded, (B, n_mbs))
    return mb_patterns, mb_nbits, last_coded_incl[:, -1]


def scroll_grid_batch(ref, mv_x, mv_y, num_refs, *, enable_pskip: bool,
                      compact_x: bool = False):
    """K6 over a batch: scroll_grid_plain for CPU tensors, the CUDA kernel
    h264t_scroll_grid for CUDA tensors, with the same arguments and
    returns.  The kernel reads the fields and a num_refs tensor in their
    own dtypes and strides."""
    B, h, w = ref.shape
    _same_shape("scroll grid", (B, h, w), mv_x=mv_x, mv_y=mv_y)
    if _device_of(ref, mv_x, mv_y) == "cpu":
        return scroll_grid_plain(ref, mv_x, mv_y, num_refs,
                                 enable_pskip=enable_pskip,
                                 compact_x=compact_x)
    dev = ref.device
    n_mbs = h * w
    S = scroll_slots(n_mbs, compact_x)
    mb_p = torch.empty((B, n_mbs, S), dtype=torch.int32, device=dev)
    mb_n = torch.empty((B, n_mbs, S), dtype=torch.int32, device=dev)
    last = torch.empty((B,), dtype=torch.int32, device=dev)
    nr, nr_field, nr_value = _num_refs_field(num_refs, B, dev)
    fields = _descriptors([_field(g) for g in (ref, mv_x, mv_y)] + [nr_field])
    if B:
        with torch.cuda.device(dev):
            _kernels.SCROLL_GRID.launch(
                fields, B, h, w, nr_value, int(n_mbs > NARROW_MAX_MBS),
                int(compact_x), int(enable_pskip), mb_p.data_ptr(),
                mb_n.data_ptr(), last.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
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
    dev = bg_ref.device
    bg_ref, bg_mv_x, bg_mv_y = (g.to(torch.int32)
                                for g in (bg_ref, bg_mv_x, bg_mv_y))
    bg_coded = bg_coded.to(torch.bool)
    donor_coded = dn["coded"].to(torch.bool).reshape(B, R, C)
    in_rect = _rect_mask(H, W, r0, c0, R, C, dev)

    def scatter(bg, vals):
        g = bg.clone()
        g[:, r0:r0 + R, c0:c0 + C] = vals.to(torch.int32).reshape(B, R, C)
        return g

    refA, mvxA, mvyA = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "a_ref"), (bg_mv_x, "a_mvx"), (bg_mv_y, "a_mvy")))
    refB, mvxB, mvyB = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "b_ref"), (bg_mv_x, "b_mvx"), (bg_mv_y, "b_mvy")))
    refD, mvxD, mvyD = (scatter(g, dn[k]) for g, k in (
        (bg_ref, "d_ref"), (bg_mv_x, "d_mvx"), (bg_mv_y, "d_mvy")))

    coded = bg_coded & ~in_rect
    coded[:, r0:r0 + R, c0:c0 + C] = donor_coded

    pred_x, pred_y = mv_pred_grid_roles(
        refA, refA, mvxA, mvyA, refB, mvxB, mvyB, refD, mvxD, mvyD)
    mvd_x = bg_mv_x - pred_x
    mvd_y = bg_mv_y - pred_y

    n_mbs = H * W
    wide = n_mbs > NARROW_MAX_MBS
    coded_f = coded.reshape(B, n_mbs)
    skip_run, last_incl = _skip_runs(coded_f)
    a, mvx, c, sr = _mb_codes(
        bg_ref.reshape(B, n_mbs), mvd_x.reshape(B, n_mbs),
        mvd_y.reshape(B, n_mbs), _num_refs_column(num_refs, bg_ref),
        skip_run, wide)

    active = coded_f & ~in_rect.reshape(1, n_mbs)
    bg_p, bg_n = _slots(([sr] if wide else []) + [a, mvx, c], active,
                        (B, H, W))
    bg2_p = bg2_n = None
    if compact_x:
        bg2_p, bg2_n = _slots([bitpack.merge_symbol_pairs(*a, *mvx), c],
                              active, (B, H, W))
    return CompositeGrid(bg_p, bg_n, bg2_p, bg2_n, sr[0], sr[1],
                         last_incl[:, -1])


def composite_grid_batch(r0: int, c0: int, R: int, C: int, num_refs,
                         bg_ref, bg_mv_x, bg_mv_y, bg_coded, dn: dict, *,
                         compact_x: bool = False) -> CompositeGrid:
    """K5 over a batch: composite_grid_plain for CPU tensors, the CUDA
    kernel h264t_composite_grid for CUDA tensors, with the same arguments
    and returns.  The kernel reads the background grids, the nine role
    fields and both coded masks in their own dtypes and strides, and
    never materialises the scattered role grids."""
    B, H, W = bg_ref.shape
    _same_shape("composite grid", (B, H, W), bg_mv_x=bg_mv_x,
                bg_mv_y=bg_mv_y, bg_coded=bg_coded)
    donor = [dn[k] for k in ROLE_FIELDS + ("coded",)]
    if _device_of(bg_ref, bg_mv_x, bg_mv_y, bg_coded, *donor) == "cpu":
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
                int(compact_x), bg_p.data_ptr(), bg_n.data_ptr(),
                0 if bg2_p is None else bg2_p.data_ptr(),
                0 if bg2_n is None else bg2_n.data_ptr(),
                sr_p.data_ptr(), sr_n.data_ptr(), last.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    del nr, donor   # kept alive until the launch is queued
    return CompositeGrid(bg_p, bg_n, bg2_p, bg2_n, sr_p, sr_n, last)


def _bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def composite_grid_bytes(num_refs, bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                         dn: dict, out: CompositeGrid) -> int:
    """Bytes a K5 call must move: each input it reads once (the four
    background grids and the ten donor fields as passed, a num_refs
    tensor) and each output written once."""
    return _bytes((num_refs, bg_ref, bg_mv_x, bg_mv_y, bg_coded,
                   *(dn[k] for k in ROLE_FIELDS + ("coded",)), *out))


def scroll_grid_bytes(ref, mv_x, mv_y, num_refs, out) -> int:
    """Bytes a K6 call must move: the three fields and a num_refs tensor
    read once, its slots and last coded MBs written once."""
    return _bytes((ref, mv_x, mv_y, num_refs, *out))


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
