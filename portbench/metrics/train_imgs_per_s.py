"""Every image of every unit completed in the window, over its seconds."""

from portbench.metrics.common import images_per_s as read  # noqa: F401
