"""setup_s: process start to the first timed step (host clock): imports,
CUDA start, the kernel and engine libraries (built on a checkout's
first run), inputs made from the seed, capture and warm-up."""


def read(rec):
    return rec.setup_s
