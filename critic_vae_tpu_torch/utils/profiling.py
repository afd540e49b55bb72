"""Profiling helpers (counterpart of critic_vae_tpu/utils/profiling.py):
``profile_trace`` takes a ``torch.profiler`` trace where the JAX package
takes an XLA one, ``span`` names a stage of the port in that trace, and
``setup_span`` records the once-per-process work of set-up.

Spans are named ``<layer>.<stage>`` and nest on the calling thread:
``video.episode`` (``pipelines/video.py::eval_episode``) holds
``video.upload``, ``video.device_stage``, ``video.normalize``,
``video.crf``, ``video.readback`` and ``video.score``; ``video.sweep``
(``threshold_sweep``) holds ``video.upload``, ``video.device_stage``,
``sweep.threshold`` (a chunk's normalisation, T masks and their counts),
``video.crf``, ``video.readback`` and ``video.score``; the device CRF's
chunks open ``crf.build`` and ``crf.mean_field`` (crf/device.py); a
train step (train/step.py) opens ``train.forward``, ``train.loss``,
``train.backward`` and ``train.update`` in turn, inside ``train.replay``
when it replays as CUDA graphs; the saliency mask source
(ops/saliency.py), inside ``video.device_stage``, opens ``saliency.view``
a view, ``saliency.upsample`` a LayerCAM upsample and ``saliency.combine``
a further view's mapping back and minimum; the mesh's gather opens
``mesh.all_gather`` (parallel/mesh.py); a conv block's epilogue without
autograd opens ``block.epilogue`` (ops/epilogue.py), around the
``block_epilogue`` kernel's launch where it runs; the bilateral build's
launch opens ``bilateral_build`` (crf/fused_build.py). The other kernels'
launches open no span: a trace names each kernel and ties it to its launch
by correlation id.

Set-up spans (:func:`setup_span`) are kept in :data:`SETUP_SPANS`, in
memory, whether or not a profiler records, once for each (name, key) in
the process: ``setup.library`` (kernels/build.py::library loading the
kernel library; key ``build`` where the process compiled it first, ``load``
where it found it), ``setup.first_call`` (the first call in the process of
an entry point: ``video.episode``, ``video.sweep``, ``train.step``; it holds
that call's steady work too) and ``setup.capture`` (a CUDA graph capture,
keyed by what it captured and its shapes: ``train:<inputs>``, train/step.py,
and ``saliency:<frames>``, ops/saliency.py). ``critic_vae_tpu_torch.IMPORT_START_NS``
is the port's import start. All are stamped on ``time.time_ns()``, the
wall clock that a Chrome trace of ``torch.profiler`` shares: an event's
``ts`` in µs is (ns - ``baseTimeNanoseconds``) / 1e3, ``baseTimeNanoseconds``
being the trace's own top-level field.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
import threading
import time
from typing import Iterator, List, Optional

import torch


@dataclasses.dataclass
class SetupSpan:
    """One set-up span: its name and key, its start and end on
    ``time.time_ns()`` (end None while it is open), and the index in
    :data:`SETUP_SPANS` of the set-up span open around it on its thread
    (the one that caused it), or None."""

    name: str
    key: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]


# the set-up spans of this process in the order they opened
SETUP_SPANS: List[SetupSpan] = []
_SEEN: set = set()  # their (name, key)
_OPEN = threading.local()  # .stack: indices of the set-up spans open on the thread


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's when
    a card is present) and write it under ``log_dir`` as a Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``, readable by Perfetto and
    TensorBoard's profiler). The port's spans (:func:`span`) name its stages
    in it, and the set-up spans closed before the trace began are added as
    events of category ``setup`` on the trace's clock (``args``: their key
    and parent), so the kernel library's load and earlier first calls show
    before the traced work. No-op when ``log_dir`` is None, so a call site
    can take an optional ``--profile DIR`` unconditionally."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    started_ns = time.time_ns()

    def write(prof) -> None:
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        earlier = [(i, s) for i, s in enumerate(SETUP_SPANS)
                   if s.start_ns < started_ns and s.end_ns is not None]
        if earlier:
            _add_setup_events(path, earlier)

    with torch.profiler.profile(activities=activities, on_trace_ready=write):
        yield


def _add_setup_events(path: str, spans) -> None:
    """Add the indexed set-up spans ``spans`` to the Chrome trace at
    ``path``, on its clock, on the process's main thread, without reading
    the trace back: ``baseTimeNanoseconds`` is in its header, and the events
    go in before the close of ``traceEvents``, which only the trace's name
    follows. A trace laid out otherwise is read and written whole."""
    with open(path, "r+b") as f:
        head = f.read(1 << 16)
        size = f.seek(0, os.SEEK_END)
        at = max(0, size - (1 << 16))
        f.seek(at)
        tail = f.read()
        base = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', head)
        close = re.search(rb'(\S)\s*\]\s*(,\s*"traceName":\s*"(?:[^"\\]|\\.)*"\s*)?\}\s*$', tail)
        if base is None or close is None or close.group(1) == b"[":
            f.seek(0)
            trace = json.load(f)
            trace["traceEvents"].extend(_setup_events(spans, trace.get("baseTimeNanoseconds", 0)))
            f.seek(0)
            f.truncate()
            f.write(json.dumps(trace).encode())
            return
        events = _setup_events(spans, int(base.group(1)))
        f.seek(at + close.end(1))
        f.write(b"".join(b",\n" + json.dumps(e).encode() for e in events) + tail[close.end(1):])


def _setup_events(spans, base: int) -> list:
    pid = os.getpid()
    return [{"ph": "X", "cat": "setup", "name": s.name, "pid": pid, "tid": pid,
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"key": s.key, "index": i, "parent": s.parent}}
            for i, s in spans]


_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` span named ``name`` around the block while a
    profiler records, on the trace's clock (a ``user_annotation`` event of
    the Kineto timeline, beside the card's activity); the one shared null
    context otherwise, so a span costs one check when nothing records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def setup_span(name: str, key: str, barrier=None):
    """The set-up span ``name`` for ``key`` around the block, the first time
    the process opens it: recorded in :data:`SETUP_SPANS` on
    ``time.time_ns()``, with the set-up span open around it as its parent,
    and also a :func:`span` named ``name``. With ``barrier`` (a CUDA tensor)
    the card finishes the block's work before the span closes
    (:func:`device_barrier`), for a call that returns before the card
    does. Every later time it is the shared null context, at the cost of
    one set lookup: no synchronise, no allocation."""
    if (name, key) in _SEEN:
        return _OFF
    return _recorded(name, key, barrier)


@contextlib.contextmanager
def _recorded(name: str, key: str, barrier):
    _SEEN.add((name, key))
    stack = _OPEN.__dict__.setdefault("stack", [])
    with span(name):  # the record lies inside the profiler's event
        entry = SetupSpan(name, key, time.time_ns(), None, stack[-1] if stack else None)
        stack.append(len(SETUP_SPANS))
        SETUP_SPANS.append(entry)
        try:
            yield
            device_barrier(barrier)
        finally:
            stack.pop()
            entry.end_ns = time.time_ns()


def device_barrier(x) -> None:
    """Wait until the card has finished the work queued before it, when
    ``x`` is a CUDA tensor; nothing for a CPU tensor or a host value (the
    CPU's work is done when its call returns)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
