"""Device ms a training step of both Adam steps and the EMA (and the
gradients' all-reduce across ranks)."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "train.update")
