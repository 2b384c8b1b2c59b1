"""Percent of their least time that the forward's K1 launches take."""

from portbench.metrics.common import K1, roofline


def read(trace):
    return roofline(trace, {K1: "k1_least_s"})
