"""session_host_ms: what a session frame costs beyond its device time:
the mean host wall of a frame (write_scroll_or_waypoint_frame, bytes on
the host) less the mean CUDA-event device time of its replay."""


def read(rec):
    if not rec.device_s:
        return None
    host = sum(rec.latencies_s) / len(rec.latencies_s)
    return 1e3 * (host - sum(rec.device_s) / len(rec.device_s))
