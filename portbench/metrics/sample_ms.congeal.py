"""Device ms a congeal forward of the warps, both stages summed: the
pyramid build and the K1 sampling."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "stn.composed", "stn.sample")
