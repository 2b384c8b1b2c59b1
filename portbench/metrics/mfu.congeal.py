"""Percent of the H100's dense TF32 peak reached by the model FLOPs."""

from portbench.metrics.common import mfu as read  # noqa: F401
