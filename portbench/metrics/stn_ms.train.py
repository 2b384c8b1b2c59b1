"""Device ms a training step of the composed STN's forward: both stages'
encoders, heads and warps."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "stn.composed")
