"""Percent of their least time that the step's mipmap sampler launches
take: K1 (forward) and K3 (d/dgrid, d/dlevels)."""

from portbench.metrics.common import K1, K3, roofline


def read(trace):
    return roofline(trace, {K1: "k1_least_s", K3: "k3_least_s"})
