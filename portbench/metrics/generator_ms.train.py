"""Device ms a training step of the two generator passes: the no-grad
pass, and the latent learner, the aligned pass and its resize."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "train.generator")
