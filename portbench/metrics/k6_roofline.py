"""k6_roofline: K6 (ops/grid.scroll_grid_batch, the scroll MB grid) as
a share of its memory bound: the cell's K6 bytes a call
(yardstick.k6_bytes) at 3.35 TB/s over K6's mean device time a call in
the traced window."""

from portbench import yardstick


def read(rec):
    if rec.trace is None:
        return None
    return yardstick.roofline_pct(rec.bound_bytes.get("k6"),
                                  rec.trace.kernel_mean_s("ScrollStage"))
