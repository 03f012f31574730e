"""frame_p95_ms: the 95th percentile over every frame of the window of
the time from the hand-over of its step's inputs to its bytes on the
host (host clock; a step's frames share the step's time)."""

from portbench import yardstick


def read(rec):
    return 1e3 * yardstick.percentile(rec.latencies_s, 95)
