"""Profiling: a traced window and the program's stage spans.

Port of gangealing_tpu/utils/profiling.py: ``trace`` opens a
``torch.profiler`` window (CPU and, on a card, CUDA activity) and writes
its Chrome trace into ``log_dir``.

``span(name)`` marks a stage of the program (the train step's generator
passes, the STN's encoder, ...). With no profiler on it costs one check
of the profiler's flag. Under a profiler it opens a host range that the
trace keeps as a ``cpu_op`` (never a ``user_annotation``, which kineto
would copy onto the device's timeline as if it were a kernel) and keeps
the span and its parent in a bounded record. A span opened inside
another one also records a pair of CUDA timing events on the current
stream where the process uses a card; a root span (a unit of work: a
train step, a congeal batch) records none, as the traced window's own
clock times its units. ``unit_spans`` reads the record once the window
has been synchronized: the device-clock ms of each stage inside a root,
idle time on the card inside it included.
"""

import collections
import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept, newest last; a long profiled run keeps only the latest
RECORD_CAP = 4096
_RECORD = collections.deque()
_EVENTS = []  # timing events of spans that left the record, for reuse
_LOCK = threading.Lock()
_LOCAL = threading.local()  # each thread's stack of open spans


def start_trace():
    """Start a ``torch.profiler`` window: CPU activity, and CUDA activity
    when a card is visible. Returns the profiler for ``stop_trace``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir):
    """End the window once the card has finished its work, and write its
    Chrome trace, ``trace_<pid>_<ns>.json``, into ``log_dir``. Returns the
    trace's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir="trace"):
    """Trace the block into a Chrome trace in ``log_dir`` (viewable in
    Perfetto or chrome://tracing). Yields the profiler."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


class span(contextlib.ContextDecorator):
    """``with span(name):`` marks a stage of the program, and ``@span(name)``
    a whole function; recorded only while a ``torch.profiler`` window is
    open (module docstring). A recorded span keeps its parent span and,
    inside a root on a card, its (enter, exit) timing events."""

    def __init__(self, name):
        self.name = name
        self.range = None

    def _recreate_cm(self):
        return span(self.name)  # one per call: a call may nest or recurse

    def __enter__(self):
        if not _autograd_profiler._is_profiler_enabled:
            return self
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.events = None
        if self.parent is not None and torch.cuda.is_initialized():
            with _LOCK:
                self.events = [_EVENTS.pop() if _EVENTS else
                               torch.cuda.Event(enable_timing=True)
                               for _ in range(2)]
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        if self.events:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.range is None:
            return False
        if self.events:
            self.events[1].record()
        self.range.__exit__(None, None, None)
        self.range = None
        _LOCAL.stack.pop()
        with _LOCK:
            if len(_RECORD) >= RECORD_CAP:
                old = _RECORD.popleft()
                if old.events:
                    _EVENTS.extend(old.events)
            _RECORD.append(self)
        return False


class SpanTime(NamedTuple):
    """A recorded span: its name, its parent's name (None at a root), and
    its device-clock ms, from its enter event to its exit event (None
    where it recorded no events: a root, or a process without a card)."""
    name: str
    parent: str | None
    device_ms: float | None


def _timed(s):
    device_ms = (s.events[0].elapsed_time(s.events[1]) if s.events
                 else None)
    return SpanTime(s.name, s.parent.name if s.parent else None, device_ms)


def unit_spans(root, n):
    """The last ``n`` recorded root spans (spans with no parent) named
    ``root``, oldest first, each as a list of ``SpanTime``: the root, then
    its descendants in the order they closed. Reads the device's clock:
    call it after the window's synchronize."""
    with _LOCK:
        record = list(_RECORD)
    roots = [s for s in record if s.parent is None and s.name == root]
    units = {id(r): [r] for r in roots[max(0, len(roots) - n):]} \
        if n > 0 else {}
    for s in record:
        top = s
        while top.parent is not None:
            top = top.parent
        if top is not s and id(top) in units:
            units[id(top)].append(s)
    return [[_timed(s) for s in unit] for unit in units.values()]
