"""Device ms a training step of the perceptual trunk's forward (VGG for
cats, LPIPS and the heads' argmin for cars)."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "train.perceptual")
