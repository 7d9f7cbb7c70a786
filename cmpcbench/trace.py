"""The traced sub-window: torch.profiler over a few steady seconds, and
the reduction of its raw events into the records the metric readers read.

The profile records the card's activity alone (kernels, copies, fills,
and the runtime calls that launched them): recording every host-side
operator as well would slow the host's enqueue enough to starve the card
in the decode cells.  What the harness's host side does is kept apart by
``HostRanges`` on the profiler's clock (the Unix epoch in ns):
``draw`` (the next activations), ``run_batched`` (inside the program's
entry) and ``wait`` (on a call's event).  A device operation takes the
label of the range in which the host launched it, found through the
runtime call with its correlation id.
"""
from __future__ import annotations

import bisect
import contextlib
import time


class HostRanges:
    """``(label, start_ns, end_ns)`` of what the host does while ``on``."""

    def __init__(self):
        self.on = False
        self.ranges = []

    def __call__(self, label: str):
        return self._range(label) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _range(self, label: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.ranges.append((label, start, time.time_ns()))


def start_profile(device_type: str):
    """A profile of the card's activity; None where there is no card."""
    if device_type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop_profile(prof) -> list:
    """Stop ``prof`` and return its raw events (nothing is parsed here)."""
    if prof is None:
        return []
    prof.stop()
    return list(prof.profiler.kineto_results.events())


def reduce_events(events, host_ranges, window_ns) -> dict:
    """The window, the host ranges, and each device operation with the
    label of the host range that launched it."""
    launched, device = {}, []
    for ev in events:
        if ev.device_type().name == "CPU":  # a runtime call: cudaLaunchKernel, cudaMemcpyAsync, ...
            launched.setdefault(ev.correlation_id(), ev.start_ns())
        else:
            device.append(ev)
    ranges = sorted(host_ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    ops = [[ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
            _label(ranges, starts, launched.get(ev.correlation_id()))] for ev in device]
    return {"window_ns": tuple(window_ns), "host": [list(r) for r in ranges], "device": ops}


def _label(ranges, starts, t) -> str:
    """The host range that holds time ``t`` (the ranges do not nest)."""
    if t is None:
        return "unknown"
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= ranges[i][2]:
        return ranges[i][0]
    return "other"


def busy_intervals(device_ops, w0: int, w1: int) -> list:
    """The union of the device operations' intervals within [w0, w1]."""
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in device_ops if e > w0 and s < w1)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(trace: dict) -> list:
    """(label, seconds) of every idle stretch of the window, by what the
    host was doing at its middle."""
    w0, w1 = trace["window_ns"]
    ranges = [tuple(r) for r in trace["host"]]
    starts = [r[1] for r in ranges]
    edges = [w0] + [t for iv in busy_intervals(trace["device"], w0, w1) for t in iv] + [w1]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps.append((_label(ranges, starts, (s + e) // 2), (e - s) / 1e9))
    return gaps


def device_seconds_by_name(trace: dict) -> dict:
    out = {}
    for name, s, e, _ in trace["device"]:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out
