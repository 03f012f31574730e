"""The band plan of K5 and K6 (ops/grid) on the CPU: the plain model of a
session split into P row bands with their skip-run maxima carried across
(`composite_grid_split_plain`, `scroll_grid_split_plain`) against the plain
versions, on every case of cases.COMPOSITE_GRID_CASES and
SCROLL_GRID_CASES at every P the shape allows; the band arithmetic the
kernels share with ops/grid; and that the cases reach the band edges
that matter (a band with no coded MB between bands with some, a coded MB
first or last in a band, the donor rect across a band edge and starting
on one, the wide layout split, a band of one row).

Tolerance: none; every output is an integer, compared exactly.
"""

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import grid

torch.set_num_threads(1)

_K5 = [(c[0], p) for c in cases.COMPOSITE_GRID_CASES
       for p in grid.allowed_parts(*c[1])]
_K6 = [(c[0], p) for c in cases.SCROLL_GRID_CASES
       for p in grid.allowed_parts(*c[1])]


def _same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name,parts", _K5)
def test_composite_grid_split_matches_plain(name, parts):
    rect, compact_x, nr_arg, _nr, bg, dn = cases.composite_grid_case(name)
    args = (*rect, *cases.grid_args((nr_arg, *bg, dn), "cpu"))
    want = grid.composite_grid_plain(*args, compact_x=compact_x)
    _same(grid.composite_grid_split_plain(*args, compact_x=compact_x,
                                          parts=parts), want)


@pytest.mark.parametrize("name,parts", _K6)
def test_scroll_grid_split_matches_plain(name, parts):
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
    args = cases.grid_args((*fields, nr_arg), "cpu")
    kw = dict(enable_pskip=pskip, compact_x=compact_x)
    want = grid.scroll_grid_plain(*args, **kw)
    _same(grid.scroll_grid_split_plain(*args, parts=parts, **kw), want)


def _composite_coded(name):
    rect, _c, _a, _nr, bg, dn = cases.composite_grid_case(name)
    r0, c0, R, C = rect
    coded = bg[3].copy()
    coded[:, r0:r0 + R, c0:c0 + C] = dn["coded"].reshape(-1, R, C)
    return coded, rect


def _scroll_coded(name):
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
    _p, nb, _last = grid.scroll_grid_plain(
        *cases.grid_args((*fields, nr_arg), "cpu"), enable_pskip=pskip,
        compact_x=compact_x)
    return (nb != 0).any(dim=2).numpy().reshape(fields[0].shape), None


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_cases_reach_the_band_edges(kernel):
    """Across the cases and their plans: a band with no coded MB whose
    neighbours have some, a coded MB first and last in a band (where the
    carry in and out matter), a band of one row, the wide layout split,
    and for K5 the rect across a band edge and starting on one."""
    names, coded_of = ((cases.COMPOSITE_GRID_CASES, _composite_coded)
                       if kernel == "K5" else
                       (cases.SCROLL_GRID_CASES, _scroll_coded))
    seen = set()
    for name, (h, w), *_ in names:
        coded, rect = coded_of(name)
        B = coded.shape[0]
        for p in grid.allowed_parts(h, w)[1:]:
            bands = grid.band_rows(h, p)
            has = [coded[:, lo:hi].reshape(B, -1).any(axis=1)
                   for lo, hi in bands]
            for r, (lo, hi) in enumerate(bands):
                band = coded[:, lo:hi].reshape(B, -1)
                if 0 < r < p - 1 and (~has[r] & has[r - 1] & has[r + 1]).any():
                    seen.add("band with no coded MB between coded bands")
                if r > 0 and band[:, 0].any():
                    seen.add("coded MB first in a band")
                if r < p - 1 and band[:, -1].any():
                    seen.add("coded MB last in a band")
                if hi - lo == 1:
                    seen.add("band of one row")
                if h * w > grid.NARROW_MAX_MBS:
                    seen.add("wide layout split")
                if rect is not None and r > 0:
                    if rect[0] < lo < rect[0] + rect[2]:
                        seen.add("rect across a band edge")
                    if rect[0] == lo:
                        seen.add("rect starting on a band edge")
    want = {"band with no coded MB between coded bands",
            "coded MB first in a band", "coded MB last in a band",
            "band of one row", "wide layout split"}
    if kernel == "K5":
        want |= {"rect across a band edge", "rect starting on a band edge"}
    assert want <= seen, want - seen


def test_band_arithmetic():
    """Bands are whole rows covering the frame in order, at least one row
    each and within one row of each other; a thread's run is odd and
    covers the longest band; the shared memory grows with the band."""
    for h in (1, 2, 7, 8, 45, 65, 200):
        for p in (p for p in grid.PARTS if p <= h):
            bands = grid.band_rows(h, p)
            assert bands[0][0] == 0 and bands[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
            sizes = {hi - lo for lo, hi in bands}
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
            assert max(sizes) == grid.band_max_rows(h, p)
            for w in (1, 10, 80, 320):
                k = grid.grid_items_per_thread(h, w, p)
                assert k % 2 == 1
                assert k * grid.GRID_THREADS >= grid.band_max_rows(h, p) * w
    # 720p: 45 x 80 MBs; the composite kernel stages nine fields.
    assert (grid.grid_smem_bytes(grid.GRID_COMPOSITE, 45, 80, 1)
            > grid.grid_smem_bytes(grid.GRID_COMPOSITE, 45, 80, 2)
            > grid.grid_smem_bytes(grid.GRID_SCROLL, 45, 80, 2))
    assert grid.allowed_parts(45, 80) == grid.PARTS
    assert grid.allowed_parts(6, 10) == (1, 2, 4)
    assert grid.allowed_parts(1, 20_000) == ()   # a run past 31 MBs


def test_plan_rule():
    """The P of least waves times (band MBs + a block's fixed cost); the
    smallest of equals; 0 where nothing fits."""
    # 720p (45 x 80 MBs): 256 sessions in one wave of 3 blocks an SM at
    # P = 1 beat two or three waves of shorter bands; at 1 block an SM
    # (K5's shared memory at P = 1) two bands a session halve the rows at
    # the same two waves.
    assert grid.plan_from_capacity(256, 45, 80, {1: 396, 2: 396, 4: 372}) == 1
    assert grid.plan_from_capacity(256, 45, 80, {1: 132, 2: 264, 4: 248,
                                                 8: 248, 16: 240}) == 2
    assert grid.plan_from_capacity(1024, 45, 80,
                                   {1: 132, 2: 264, 4: 248}) == 2
    # One session: as many bands as the shape allows.
    assert grid.plan_from_capacity(1, 45, 80,
                                   {p: 132 for p in grid.PARTS}) == 16
    assert grid.plan_from_capacity(1, 6, 10, {1: 132, 2: 132, 4: 132}) == 4
    assert grid.plan_from_capacity(4, 45, 80, {1: 0, 2: 0}) == 0
    assert grid.plan_from_capacity(4, 45, 80, {1: 0, 2: 264}) == 2


def test_forced_parts_refused():
    """A forced P the shape does not allow raises ValueError in the band
    model before any work; the wrappers take `parts=` only with CUDA
    tensors and refuse it, whatever its value, with CPU ones."""
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case("generic")
    args = cases.grid_args((*fields, nr_arg), "cpu")
    kw = dict(enable_pskip=pskip, compact_x=compact_x)
    for parts in (3, 8, 16):                     # 6 rows: 8 and 16 too many
        with pytest.raises(ValueError):
            grid.scroll_grid_split_plain(*args, parts=parts, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        grid.scroll_grid_batch(*args, parts=1, **kw)
    rect, compact_x, nr_arg, _nr, bg, dn = cases.composite_grid_case(
        "interior")
    args = (*rect, *cases.grid_args((nr_arg, *bg, dn), "cpu"))
    with pytest.raises(ValueError):
        grid.composite_grid_split_plain(*args, compact_x=compact_x, parts=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        grid.composite_grid_batch(*args, compact_x=compact_x, parts=1)


def _bytes_by_loops(rect, bg, dn, nr_arg, out):
    """composite_grid_bytes counted MB by MB: each live MB's own background
    values and its neighbours' (A left, B above and above-right, D
    above-left where above-right is outside the frame), from the donor's
    role fields inside the rect."""
    r0, c0, R, C = rect
    B, H, W = bg[0].shape
    live = (out.bg_n != 0).any(dim=-1)
    inside = lambda r, c: r0 <= r < r0 + R and c0 <= c < c0 + C
    bg_at, role_at = set(), set()
    for b, r, c in live.nonzero().tolist():
        bg_at.add((b, r, c))
        near = [("a", r, c - 1), ("b", r - 1, c)]
        near.append(("b", r - 1, c + 1) if c + 1 < W else ("d", r - 1, c - 1))
        for role, rr, cc in near:
            if rr < 0 or cc < 0:
                continue
            if inside(rr, cc):
                role_at.add((role, b, rr, cc))
            else:
                bg_at.add((b, rr, cc))
    n = len(bg_at) * sum(g.element_size() for g in bg[:3])
    n += sum(dn[k].element_size()
             for role, *_ in role_at for k in grid.ROLE_FIELDS
             if k[0] == role)
    n += (B * H * W - B * R * C) * bg[3].element_size()
    n += dn["coded"].numel() * dn["coded"].element_size()
    if isinstance(nr_arg, torch.Tensor):
        sessions = int(live.flatten(1).any(dim=1).sum())
        n += (sessions if nr_arg.numel() == B else int(sessions > 0)) * \
            nr_arg.element_size()
    return n + sum(x.numel() * x.element_size() for x in out if x is not None)


@pytest.mark.parametrize("name", [c[0] for c in cases.COMPOSITE_GRID_CASES])
def test_composite_grid_bytes_count_what_the_data_needs(name):
    """K5's bound counts the MVs and refs only around live MBs and a
    tensor passed twice once: equal to an MB-by-MB count on every case,
    and, on an all-skip background passed as one grid three times (the
    splice steps' main path), only the coded masks and the outputs."""
    rect, compact_x, nr_arg, _nr, bg, dn = cases.composite_grid_case(name)
    nr_arg, bg, dn = cases.grid_args((nr_arg, bg, dn), "cpu")
    out = grid.composite_grid_plain(*rect, nr_arg, *bg, dn,
                                    compact_x=compact_x)
    assert grid.composite_grid_bytes(*rect, nr_arg, *bg, dn, out) == \
        _bytes_by_loops(rect, bg, dn, nr_arg, out)
    zero = torch.zeros_like(bg[0])
    still = (zero, zero, zero, torch.zeros_like(bg[3]))
    out = grid.composite_grid_plain(*rect, nr_arg, *still, dn,
                                    compact_x=compact_x)
    B, H, W = zero.shape
    R, C = rect[2:]
    assert not (out.bg_n != 0).any()
    assert grid.composite_grid_bytes(*rect, nr_arg, *still, dn, out) == (
        B * (H * W - R * C) + dn["coded"].numel()
        + sum(x.numel() * 4 for x in out if x is not None))


@pytest.mark.parametrize("name", [c[0] for c in cases.SCROLL_GRID_CASES])
def test_scroll_grid_bytes_count_each_tensor_once(name):
    """K6's bound reads every field whole (a tensor passed twice once) and
    a num_refs tensor at the sessions with a coded MB."""
    pskip, compact_x, nr_arg, _nr, fields = cases.scroll_grid_case(name)
    ref, mv_x, mv_y, nr = cases.grid_args((*fields, nr_arg), "cpu")
    kw = dict(enable_pskip=pskip, compact_x=compact_x)

    def expected(grids, out):
        n = sum(g.numel() * g.element_size() for g in grids)
        n += sum(x.numel() * x.element_size() for x in out)
        if isinstance(nr, torch.Tensor):
            coded = (out[1] != 0).flatten(1).any(dim=1)
            n += (int(coded.sum()) if nr.numel() == coded.numel()
                  else int(coded.any())) * nr.element_size()
        return n

    out = grid.scroll_grid_plain(ref, mv_x, mv_y, nr, **kw)
    assert grid.scroll_grid_bytes(ref, mv_x, mv_y, nr, out) == \
        expected((ref, mv_x, mv_y), out)
    out = grid.scroll_grid_plain(ref, ref, ref, nr, **kw)
    assert grid.scroll_grid_bytes(ref, ref, ref, nr, out) == \
        expected((ref,), out)
