"""What the benchmark's tests share: the cells, a seed past 32 signed
bits and one small run of a cell on the CPU."""

SEED = 2**31 + 77
CELLS = ("scroll.b256", "splice_rows.pooled_b1024", "scroll.session_b1")
BATCH_CELLS = CELLS[:2]
# CPU runs: every session of a kept step checked.
SMALL = {"check": {"frames": 64, "min_frames": 4}}


def cpu_run(cell, seed=SEED, seconds=0.5, **kw):
    """One small run of `cell` on the CPU: (result, exit code, lines)."""
    from portbench import harness

    kw.setdefault("batch", 4)
    kw.setdefault("traffic_override", SMALL)
    return harness.run(cell, seed, seconds, kw.pop("trace", False),
                       device="cpu", **kw)
