"""Device ms a training step of the whole backward: through the aligned
generator pass, the perceptual trunk and the STN."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "train.backward")
