"""Readings of the program's stage spans (``gangealing_torch/utils/
profiling.py::span``) over the traced window: the device-clock ms of the
spans of one stage inside each unit's root span, the median over the
window's units. Idle time on the card inside a stage is charged to it,
so a stall of the host (a slow ``cudaMalloc``) lands whole in the unit
that holds it; the median keeps it out of the reading."""

import statistics


def stage_ms(trace, root, stage):
    """Median over units of the device ms of the spans named ``stage``
    inside the last ``trace.units`` root spans named ``root`` (0 in a
    unit without one); None where the program records no spans or no
    device times, or the window did not record a root a unit."""
    try:
        from gangealing_torch.utils.profiling import unit_spans
    except ImportError:  # a program without stage spans
        return None
    units = unit_spans(root, trace.units)
    if not units or len(units) < trace.units:
        return None
    times = [[s.device_ms for s in unit if s.name == stage]
             for unit in units]
    if not any(times) or any(None in t for t in times):
        return None
    return statistics.median(sum(t) for t in times)
