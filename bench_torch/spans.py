"""The port's spans in a traced slice (``utils/profiling.py::span`` in the
program, ``record_function`` events in the trace): the device operations
launched inside the spans of a name, and the card's idle time inside them.

A span owns the device operations whose launch (a CUDA API call of the
trace's ``launches``, matched to the operation by correlation id) starts
inside the span's interval on **any** thread: autograd launches the
backward's kernels from its own device thread, not from the thread that
holds ``train.backward``, so ``tracing.Trace.span_kernels``, which matches
by thread, finds none there. Each reader returns None when the trace holds no span of its name
(a program without the span), as ``b2_roofline_pct`` does.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional, Tuple


def intervals(trace, name: str) -> List[Tuple[float, float]]:
    """The (start, end) of every host span named ``name``, in µs, in order."""
    return [(ts, ts + dur) for n, ts, dur, _ in trace.host if n == name]


def ops(trace, name: str) -> Optional[List[List[tuple]]]:
    """For each span named ``name``, the device operations (``Trace.device``
    tuples) launched inside it from any thread; None without such a span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    by_corr = defaultdict(list)
    for d in trace.device:
        if d[4] is not None:
            by_corr[d[4]].append(d)
    launches = sorted(trace.launches, key=lambda launch: launch[1])
    starts = [launch[1] for launch in launches]
    out = []
    for a, b in spans:
        found = []
        for launch in launches[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
            if launch[3] is not None:
                found.extend(by_corr.get(launch[3], ()))
        out.append(found)
    return out


def device_s(trace, name: str) -> Optional[float]:
    """The device time, in s, of the operations launched inside the spans
    named ``name``; None without such a span or with no operation in one."""
    per_span = ops(trace, name)
    if not per_span or not any(per_span):
        return None
    return sum(d[3] for found in per_span for d in found) / 1e6


def ms_per_kframe(t, name: str) -> Optional[float]:
    """``device_s`` of ``name`` per 1,000 frames of the traced slice, in ms
    (``t``: core.Traced)."""
    s = device_s(t.trace, name)
    if s is None or t.frames <= 0:
        return None
    return 1e3 * s / (t.frames / 1e3)


def kernels_per_unit(t, name: str) -> Optional[float]:
    """The kernels launched inside the spans named ``name``, per unit (step)
    of the traced slice; None without such a span or without a kernel in
    the trace."""
    per_span = ops(t.trace, name)
    if per_span is None or t.units <= 0 or not t.trace.kernels():
        return None
    return sum(1 for found in per_span for d in found if d[1] == "kernel") / t.units


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_s(trace, name: str) -> Optional[float]:
    """The time, in s, inside the spans named ``name`` in which no device
    operation ran: the spans' union intersected with the gaps in the union
    of the device operations' intervals. None without such a span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    busy = trace.busy_intervals()
    ends = [b for _, b in busy]
    idle = 0.0
    for a, b in _union(spans):
        covered = 0.0
        for x, y in busy[bisect.bisect_right(ends, a):]:
            if x >= b:
                break
            covered += min(b, y) - max(a, x)
        idle += (b - a) - covered
    return idle / 1e6


def idle_pct(t, name: str) -> Optional[float]:
    """The card's idle time inside the spans named ``name`` as a share of
    the traced slice's wall time, ``window_s``, in % (the denominator of
    ``device_idle_pct``, of which it is a part)."""
    if t.window_s <= 0 or not t.trace.device:
        return None
    s = idle_s(t.trace, name)
    return None if s is None else 100.0 * s / t.window_s
