"""Device-clock ms a training step of the STN's Gaussian pyramid builds,
one a warp, both stages summed: the pyramid of the image each warp
samples. The build launches a few small kernels a level and waits on the
host between them, so the span's clock reads mostly the host's dispatch
and the card's idle time inside it, not the kernels' work."""

from portbench.metrics.stages import stage_ms


def read(trace):
    return stage_ms(trace, "train.step", "stn.pyramid")
