"""Scroll and waypoint frames, written plainly, and the session state
behind them.

A session holds two long-term atlases (list entries 0 and 1: the page
at offset 0 and at offset `height`) and up to 8 waypoints, reference
frames registered at scroll offsets that are non-zero multiples of 496
px, the largest vertical MV the composer allows.  A step at offset o:

  - emits a waypoint frame (nal_ref_idc 2, marking itself long-term
    index 2 + count) where o needs a waypoint not yet registered, and
    registers it; otherwise a scroll frame (nal_ref_idc 0);
  - codes every MB P_L0_16x16 (zero horizontal motion): the MB rows
    above (height - o) // 16 from the region A reference, the rest from
    region B, each reference redirected to a waypoint where the direct
    MV would pass 496 px (region B only on scroll frames);
  - increments frame_num, written modulo 2**log2_max_frame_num.

The MV prediction is 8.4.1.3.1's median over the left, upper and
upper-right (else upper-left) MBs; with `pskip` (the benchmark's
control) an MB whose MV equals 8.4.1.1's P_Skip MV for reference 0 is
skipped.
"""

from __future__ import annotations

import dataclasses

from . import h264

MV_LIMIT_PX = 496
MAX_WAYPOINTS = 8


@dataclasses.dataclass
class Session:
    """frame_num and the waypoint registry (offsets, in order)."""
    frame_num: int = 2
    waypoints: list = dataclasses.field(default_factory=list)

    def needs_waypoint(self, offset: int) -> bool:
        return (offset != 0 and offset % MV_LIMIT_PX == 0
                and offset not in self.waypoints)

    def step(self, sps: h264.Sps, offset: int, *, pskip: bool = False,
             emit: bool = True):
        """One step: (the frame's NAL or None without `emit`, whether it
        was a waypoint frame); advances the state."""
        waypoint = self.needs_waypoint(offset)
        if waypoint and len(self.waypoints) >= MAX_WAYPOINTS:
            raise OverflowError("waypoint registry full")
        nal = (frame(sps, self.frame_num, offset, self.waypoints, waypoint,
                     pskip=pskip) if emit else None)
        if waypoint:
            self.waypoints.append(offset)
        self.frame_num += 1
        return nal, waypoint


def _regions(height: int, offset: int, waypoints, waypoint: bool):
    """((ref, mv_y px) of region A, of region B)."""
    a_ref, a_mv = 0, offset
    if offset > MV_LIMIT_PX:
        cand = [(w, i) for i, w in enumerate(waypoints)
                if 0 < w <= offset and offset - w <= MV_LIMIT_PX]
        if cand:
            w = max(c[0] for c in cand)
            i = min(i for wo, i in cand if wo == w)
            a_ref, a_mv = 2 + i, offset - w
    b_ref, b_mv = 1, offset - height
    if not waypoint and offset - height < -MV_LIMIT_PX:
        for i, w in enumerate(waypoints):
            if w > offset and offset - w >= -MV_LIMIT_PX:
                b_ref, b_mv = 2 + i, offset - w
                break
    return (a_ref, a_mv), (b_ref, b_mv)


def _median(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


def _predict(field, r: int, c: int, w: int, cur_ref: int) -> int:
    """8.4.1.3.1's vertical MV predictor of MB (r, c) for cur_ref over
    field[r][c] = (ref, mv_y) (every horizontal MV is zero)."""
    a = field[r][c - 1] if c > 0 else None
    b = field[r - 1][c] if r > 0 else None
    cc = (field[r - 1][c + 1] if r > 0 and c + 1 < w else
          field[r - 1][c - 1] if r > 0 and c > 0 else None)
    if a is None and b is None and cc is None:
        return 0
    if a is not None and b is None and cc is None:
        return a[1]
    match = [n for n in (a, b, cc) if n is not None and n[0] == cur_ref]
    if len(match) == 1:
        return match[0][1]
    return _median(*(0 if n is None else n[1] for n in (a, b, cc)))


def _pskip_mv(field, r: int, c: int, w: int) -> int:
    """8.4.1.1: zero at the frame's left or top edge or beside a zero-MV
    reference-0 neighbour, else the prediction for reference 0."""
    if r == 0 or c == 0:
        return 0
    if field[r][c - 1] == (0, 0) or field[r - 1][c] == (0, 0):
        return 0
    return _predict(field, r, c, w, 0)


def frame(sps: h264.Sps, frame_num: int, offset: int, waypoints,
          waypoint: bool, *, pskip: bool = False) -> bytes:
    """The step's Annex-B NAL (see the module docstring)."""
    h, w = sps.mb_height, sps.mb_width
    (a_ref, a_mv), (b_ref, b_mv) = _regions(sps.height, offset, waypoints,
                                            waypoint)
    a_end = (sps.height - offset) // 16
    field = [[(a_ref, 4 * a_mv) if r < a_end else (b_ref, 4 * b_mv)] * w
             for r in range(h)]
    n = len(waypoints)
    num_refs = 2 + n
    bits = h264.Bits()
    h264.p_slice_header(bits, sps, frame_num % (1 << sps.log2_max_frame_num),
                        waypoint_ltidx=[2 + i for i in range(n)],
                        self_mark=2 + n if waypoint else -1)
    run = 0
    for r in range(h):
        for c in range(w):
            ref, mv = field[r][c]
            if pskip and ref == 0 and mv == _pskip_mv(field, r, c, w):
                run += 1
                continue
            bits.ue(run)
            run = 0
            bits.ue(0)                          # mb_type P_L0_16x16
            bits.te(ref, num_refs)
            bits.se(0)                          # mvd_x
            bits.se(mv - _predict(field, r, c, w, ref))
            bits.ue(0)                          # coded_block_pattern 0
    if run:
        bits.ue(run)
    return h264.nal_unit(h264.rbsp(bits.value()), 2 if waypoint else 0)


def triangle(step: int, speed: int, max_offset: int, start: int = 0) -> int:
    """The scroll-encoder's offset pattern 0 -> max -> 0 (src/main.c)."""
    pos = (step * speed + start) % (2 * max_offset)
    return pos if pos < max_offset else 2 * max_offset - pos
