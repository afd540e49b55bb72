"""The traced run's profile: ``torch.profiler`` with CPU and CUDA activity
over a slice of work, exported as a Chrome trace and parsed into the few
lists the per-layer readers need.

* ``device``: every operation on the card (kernels, copies, sets) as
  (name, category, start µs, duration µs, correlation id).
* ``launches``: the host's launch calls (CUDA runtime or driver) as
  (name, start, duration, correlation id, thread).
* ``host``: the host's operators and named spans (``record_function``, the
  port's kernel spans among them) as (name, start, duration, thread).

The export goes to a file under the checkout's ``.bench_cache`` and is
deleted once parsed.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from bench_torch.core import CACHE

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation"}


class Trace:
    """The parsed events of one traced slice."""

    def __init__(self, events: List[Dict]):
        self.device, self.launches, self.host = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args", {})
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((e["name"], cat, ts, dur, args.get("correlation")))
            elif cat in LAUNCH_CATS:
                self.launches.append((e["name"], ts, dur, args.get("correlation"), e.get("tid")))
            elif cat in HOST_CATS:
                self.host.append((e["name"], ts, dur, e.get("tid")))
        self.device.sort(key=lambda d: d[2])
        self.host.sort(key=lambda h: h[1])

    def kernels(self) -> List[Tuple]:
        return [d for d in self.device if d[1] == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, merged, in µs."""
        merged: List[List[float]] = []
        for _, _, ts, dur, _ in self.device:
            end = ts + dur
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def span_kernels(self, span: str) -> List[List[Tuple]]:
        """For each host span named ``span``, the device operations whose
        launch lies inside it on the same thread (by correlation id)."""
        spans = [h for h in self.host if h[0] == span]
        if not spans:
            return []
        by_corr = defaultdict(list)
        for d in self.device:
            if d[4] is not None:
                by_corr[d[4]].append(d)
        launches = sorted(self.launches, key=lambda l: l[1])
        starts = [l[1] for l in launches]
        out = []
        for _, ts, dur, tid in spans:
            lo = bisect.bisect_left(starts, ts)
            hi = bisect.bisect_right(starts, ts + dur)
            ops = []
            for name, lts, ldur, corr, ltid in launches[lo:hi]:
                if ltid == tid and corr is not None:
                    ops.extend(by_corr.get(corr, ()))
            out.append(ops)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps between device operations labelled by the innermost host
        operation running when the gap began (seconds)."""
        totals: Dict[str, float] = defaultdict(float)
        for name, _, _, dur, _ in self.device:
            totals[name[:160]] += dur / 1e6
        ops = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:top]
        busy = self.busy_intervals()
        gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                      key=lambda g: g[1] - g[0], reverse=True)[:top]
        labelled = [[self.host_at(a), (b - a) / 1e6] for a, b in gaps]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}

    def host_at(self, ts: float) -> str:
        """The innermost host operation or span running at ``ts``."""
        best = None
        hi = bisect.bisect_right([h[1] for h in self.host], ts)
        for name, hts, dur, _ in self.host[:hi]:
            if hts + dur >= ts and (best is None or dur < best[1]):
                best = (name, dur)
        return best[0][:160] if best else "(no host operation)"


@contextlib.contextmanager
def capture(tag: str):
    """Trace the body with CPU and CUDA activity. Yields a dict that holds,
    once the body is done, ``trace`` (a :class:`Trace`) and ``window_s``
    (the body's wall seconds, the card synchronised at both ends)."""
    box: Dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield box
        if cuda:
            torch.cuda.synchronize()
        box["window_s"] = time.perf_counter() - t0
    finally:
        prof.stop()
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"trace-{tag}.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            box["trace"] = Trace(json.load(f).get("traceEvents", []))
    finally:
        os.unlink(path)
