"""Percent of the traced window in which no operation ran on the device."""

from portbench.metrics.common import idle_share as read  # noqa: F401
