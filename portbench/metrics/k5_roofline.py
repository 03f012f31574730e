"""k5_roofline: K5 (ops/grid.composite_grid_batch, the splice steps'
composite grid) as a share of its memory bound: the cell's K5 bytes a
call (yardstick.k5_bytes_all_skip) at 3.35 TB/s over K5's mean device
time a call in the traced window."""

from portbench import yardstick


def read(rec):
    if rec.trace is None:
        return None
    return yardstick.roofline_pct(rec.bound_bytes.get("k5"),
                                  rec.trace.kernel_mean_s("CompositeStage"))
