"""k1_roofline: K1 (ops/emit_fused, the fused pack, emulation prevention
and framing) as a share of its memory bound: the cell's K1 bytes a call
(yardstick.k1_bytes) at 3.35 TB/s over K1's mean device time a call in
the traced window."""

from portbench import yardstick


def read(rec):
    if rec.trace is None:
        return None
    return yardstick.roofline_pct(rec.bound_bytes.get("k1"),
                                  rec.trace.kernel_mean_s("emit_fused"))
