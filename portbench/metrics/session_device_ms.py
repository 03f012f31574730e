"""session_device_ms: a session frame's device time (CUDA events around
the frame graph's call: its packed row copied in and the replay), mean
over the window's frames."""


def read(rec):
    xs = rec.device_s
    return 1e3 * sum(xs) / len(xs) if xs else None
