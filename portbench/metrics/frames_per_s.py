"""frames_per_s: every frame whose bytes reached the host in the window,
over the window's whole length (host clock)."""


def read(rec):
    return rec.frames / rec.window_s
