"""Profiling and timing helpers (counterpart of
critic_vae_tpu/utils/profiling.py): ``profile_trace`` takes a
``torch.profiler`` trace where the JAX package takes an XLA one."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's when
    a card is present) and write it under ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``, readable by Perfetto and TensorBoard's profiler).
    The kernel wrappers name their launches in it (kernels/build.py). No-op
    when ``log_dir`` is None, so a call site can take an optional
    ``--profile DIR`` unconditionally."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


@contextlib.contextmanager
def timed(label: str, sink=print) -> Iterator[None]:
    """Wall-clock a block; the sink receives ``f"{label}: {seconds:.3f}s"``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {time.perf_counter() - t0:.3f}s")


def device_barrier(x) -> None:
    """Wait until the card has finished the work queued before it, when
    ``x`` is a CUDA tensor; nothing for a CPU tensor or a host value (the
    CPU's work is done when its call returns)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
