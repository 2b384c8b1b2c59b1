"""Kernel launches per training step in the traced window: the host's
dispatch work."""

from portbench.metrics.common import per_unit_kernels as read  # noqa: F401
