"""The spliced frame, written plainly: a donor rect placed into an
all-skip, zero-motion frame.

Every macroblock outside the rect is P_Skip; the donor's macroblocks
keep their mb_type, MV differences, cbp, QP deltas and residual values,
reference index 0 of the composite's list, and each luma coeff_token is
coded again under the nC its blocks see among their neighbours in the
composite (9.2.1).  The slice is non-reference (nal_ref_idc 0).
"""

from __future__ import annotations

from . import donors, h264


def composite(sps: h264.Sps, donor_grid, mb_x: int, mb_y: int) -> list:
    grid = [[h264.SKIP] * sps.mb_width for _ in range(sps.mb_height)]
    for r, row in enumerate(donor_grid):
        grid[mb_y + r][mb_x:mb_x + len(row)] = row
    return grid


def spliced_frame(sps: h264.Sps, donor_grid, mb_x: int, mb_y: int,
                  frame_num: int, num_refs: int, *,
                  repair_nc: bool = True) -> bytes:
    """The frame's Annex-B NAL.  repair_nc=False is the benchmark's
    control: each donor block keeps the coeff_token of its donor frame,
    the shortcut a splice without nC repair would take."""
    nc_of = None
    if not repair_nc:
        own = h264.luma_ncs(donor_grid)

        def nc_of(r, c, raster, nc):
            return own.get((r - mb_y, c - mb_x, raster), nc)
    bits = h264.Bits()
    h264.p_slice_header(bits, sps, frame_num % (1 << sps.log2_max_frame_num))
    h264.p_slice_data(bits, composite(sps, donor_grid, mb_x, mb_y),
                      num_refs, nc_of=nc_of)
    return h264.nal_unit(h264.rbsp(bits.value()), 0)


def reference_frame(args) -> bytes:
    """spliced_frame of donor k of a run with this seed; one picklable
    argument (seed, k, frame_num, sps, mb_x, mb_y, rows, cols, num_refs,
    repair_nc) for a worker pool."""
    seed, k, frame_num, sps, mb_x, mb_y, rows, cols, num_refs, repair = args
    grid = donors.donor_grid(seed, k, cols, rows)
    return spliced_frame(sps, grid, mb_x, mb_y, frame_num, num_refs,
                         repair_nc=repair)
