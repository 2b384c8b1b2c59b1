"""The 95th percentile of the window's batch latencies, in ms."""

from portbench.metrics.common import p95_ms as read  # noqa: F401
