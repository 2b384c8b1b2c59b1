"""Device ms a training step of the generator's last two synthesis blocks
(both StyledConvs and the ToRGB of each: the widest planes), forward only,
summed over both generator passes."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "generator.top")
