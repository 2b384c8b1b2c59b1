"""Readings shared by the metric readers of this folder. A reader gets the
measured window (``run.Window``, end-to-end metrics) or the traced one
(``trace.Trace``, per-layer metrics) and returns a number, or None where
the window holds nothing for it to read."""

import statistics

from portbench import bounds

K1 = "mipmap_pyramid_fwd_kernel"
K3 = "mipmap_pyramid_dcoords_kernel"


def images_per_s(window):
    return window.units * window.unit_images / window.seconds


def p95_ms(window):
    """The 95th percentile of every unit's host-clock latency, from its
    first launch to the synchronize that ends it."""
    lat = [(b - a) * 1e3 for a, b in zip(window.starts, window.ends)]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[18]


def per_unit_kernels(trace):
    return len(trace.kernels) / trace.units


def idle_share(trace):
    """Percent of the traced window in which nothing ran on the device."""
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace):
    """Percent of the TF32 peak that the units' model FLOPs (convolutions
    and matrix products of the plain reference, counted at the cell's
    shapes) reach over the traced window."""
    flops = trace.counters.get("model_flops_per_unit")
    if not flops:
        return None
    rate = flops * trace.units / trace.window_s
    return 100.0 * rate / bounds.TF32_FLOPS_PER_S


def roofline(trace, parts):
    """Percent: the least seconds of the launches of the kernels in
    ``parts`` ({kernel name: counter of its least seconds a launch}) over
    their device seconds; None where none of them ran."""
    least = device = 0.0
    for name, counter in parts.items():
        seconds, count = trace.kernel_seconds(name)
        if count and counter in trace.counters:
            least += trace.counters[counter] * count
            device += seconds
    return 100.0 * least / device if device else None
