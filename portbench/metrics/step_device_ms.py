"""step_device_ms: the graphed step's device time a step (CUDA events
around its call: the input copies and the replay), mean over the
window."""


def read(rec):
    xs = rec.device_s
    return 1e3 * sum(xs) / len(xs) if xs else None
