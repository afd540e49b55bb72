"""Profiling helpers (counterpart of critic_vae_tpu/utils/profiling.py):
``profile_trace`` takes a ``torch.profiler`` trace where the JAX package
takes an XLA one, and ``span`` names a stage of the port in that trace.

Spans are named ``<layer>.<stage>`` and nest on the calling thread:
``video.episode`` (``pipelines/video.py::eval_episode``) holds
``video.upload``, ``video.device_stage``, ``video.normalize``,
``video.crf``, ``video.readback`` and ``video.score``; the device CRF's
chunks open ``crf.build`` and ``crf.mean_field`` (crf/device.py); a
train step (train/step.py) opens ``train.forward``, ``train.loss``,
``train.backward`` and ``train.update`` in turn; the mesh's gather opens
``mesh.all_gather`` (parallel/mesh.py); each hand-written kernel's launch
is a span named after it (``diff_mask``, ``bilateral_build``,
``kernel_i8_build``, ``matvec_i8``, ``mean_field_resident``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's when
    a card is present) and write it under ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``, readable by Perfetto and TensorBoard's profiler).
    The port's spans (:func:`span`) name its stages and kernels in it. No-op
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


_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` span named ``name`` around the block while a
    profiler records, on the trace's clock (a ``user_annotation`` event of
    the Kineto timeline, beside the card's activity); the one shared null
    context otherwise, so a span costs one check when nothing records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def device_barrier(x) -> None:
    """Wait until the card has finished the work queued before it, when
    ``x`` is a CUDA tensor; nothing for a CPU tensor or a host value (the
    CPU's work is done when its call returns)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
