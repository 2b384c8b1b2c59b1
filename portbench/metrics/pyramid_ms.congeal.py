"""Device-clock ms a congeal forward of the Gaussian pyramid builds, one a
warp, both stages summed; like ``pyramid_ms.train``, mostly the host's
dispatch of the build and the card's idle time inside it."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "stn.composed", "stn.pyramid")
