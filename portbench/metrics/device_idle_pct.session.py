"""device_idle_pct.session: device_idle_pct of the batch-1 session cell,
which moves its per-frame latency rather than a rate."""

from portbench import harness

read = harness.reader("device_idle_pct")
