"""The traced window: torch.profiler over a run of the cell's units, and
the device's activity read from it.

``profiled`` is a frozen copy of ``chip_smoke.py::profiled``: on an H100
the tracer loses the first kernels of a window once a process has opened
a few, and now and then stamps kernels before their launch and drops those
it places before the window's start. So a window opens with launches of
``torch.cuda._sleep`` (never counted), the last of which keeps the card
busy about 20 ms while the work launches behind it, and a window in which
a launch of the work has no kernel event is taken again.
"""

import bisect
import time

import torch

PROFILE_TRIES = 5
SENTINELS = 256
SENTINEL = "spin_kernel"
RUN_RANGE = "profiled run"
SPIN_CYCLES = 40_000_000
PROFILE_PAD_S = 0.02
# device events that are copies or fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
TOP = 10  # entries of each list of the breakdown
GAPS_LABELLED = 400  # the longest idle gaps looked up on the host


def profiled(run):
    """torch.profiler (CPU and CUDA activity) over ``run()``; returns the
    kineto events of the first window in which every kernel launch made
    by ``run()`` has its kernel event, and how many windows were taken."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    short = []
    for taken in range(1, PROFILE_TRIES + 1):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(SENTINELS - 1):
                torch.cuda._sleep(1)
            torch.cuda._sleep(SPIN_CYCLES)
            with torch.profiler.record_function(RUN_RANGE):
                run()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = list(prof.profiler.kineto_results.events())
        span = next(((e.start_ns(), e.end_ns()) for e in events
                     if e.name() == RUN_RANGE and not _on_device(e)), None)
        kernels = {e.correlation_id() for e in events if _on_device(e)}
        launches = [e.correlation_id() for e in events
                    if not _on_device(e) and "LaunchKernel" in e.name()
                    and span and span[0] <= e.start_ns() <= span[1]]
        missed = [c for c in launches if c not in kernels]
        if span and launches and not missed:
            return events, span, taken
        short.append(f"kernels of {len(launches) - len(missed)} of "
                     f"{len(launches)} launches")
    raise RuntimeError(f"no complete profile in {PROFILE_TRIES} windows: "
                       f"{'; '.join(short)}")


def _on_device(e):
    return e.device_type() == torch.autograd.DeviceType.CUDA


class Trace:
    """What the metric readers read of a traced window of ``units`` units:
    its device operations and kernels, busy and window seconds, and the
    driver's counters (operations and bytes the yardstick counted)."""

    def __init__(self, events, span, units, counters):
        self.units = units
        self.counters = counters
        lo, hi = span
        # the window opens when the work's first launch can run: after
        # the sentinel that held the card while the work launched
        lo = max([lo] + [e.end_ns() for e in events if _on_device(e)
                         and SENTINEL in e.name() and e.end_ns() < hi])
        span = (lo, hi)
        self.window_s = (hi - lo) / 1e9
        device = [e for e in events if _on_device(e)
                  and e.name() != RUN_RANGE and SENTINEL not in e.name()
                  and e.end_ns() > lo and e.start_ns() < hi]
        # (name, start_ns, end_ns), clipped to the window
        self.ops = sorted(((e.name(), max(e.start_ns(), lo),
                            min(e.end_ns(), hi)) for e in device),
                          key=lambda op: op[1])
        self.kernels = [op for op in self.ops
                        if not op[0].startswith(_NOT_KERNELS)]
        self.busy = _union(self.ops)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self._host = sorted(
            ((e.start_ns(), e.end_ns(), e.name()) for e in events
             if not _on_device(e) and e.name() != RUN_RANGE
             and e.end_ns() > lo and e.start_ns() < hi),
            key=lambda h: h[0])
        self._span = span

    def kernel_seconds(self, *names):
        """(summed seconds, count) of the kernels whose name holds one of
        ``names``."""
        hits = [b - a for n, a, b in self.kernels
                if any(k in n for k in names)]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        gaps summed by the host operation running at each gap's middle."""
        by_op = {}
        for name, a, b in self.ops:
            by_op[name] = by_op.get(name, 0) + (b - a)
        device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = _gaps(self.busy, self._span)
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self._host]
        by_host = {}
        for a, b in gaps[:GAPS_LABELLED]:
            label = self._host_at((a + b) // 2, starts)
            by_host[label] = by_host.get(label, 0) + (b - a)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], ns / 1e9] for n, ns in device_ops],
                "idle_gaps": [[n[:160], ns / 1e9] for n, ns in idle]}

    def _host_at(self, t, starts, look_back=4000):
        """The innermost host event running at ``t``: of those that contain
        it, the one that started last."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 1 - look_back), -1):
            a, b, name = self._host[j]
            if a <= t <= b:
                return name
        return "host, outside any recorded operation"


def _union(ops):
    """Merged [start, end] intervals of ``ops`` sorted by start."""
    out = []
    for _, a, b in ops:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(busy, span):
    """The idle intervals of the window ``span`` around ``busy``."""
    edges = [span[0]] + [x for iv in busy for x in iv] + [span[1]]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
