"""egress_ms: `compact_batch_nal` and the copies of the lengths and the
packed bytes to the host, mean of the window's synchronised host spans
a step."""


def read(rec):
    return rec.span_mean_ms("egress")
