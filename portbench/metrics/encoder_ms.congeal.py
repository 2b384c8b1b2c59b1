"""Device ms a congeal forward of the STN encoders, both stages summed:
the downsample, the conv stack and the final layer."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "stn.composed", "stn.features")
