"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill ran on the card (torch.profiler's device events, merged)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
