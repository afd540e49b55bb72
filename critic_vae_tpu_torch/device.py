"""Device selection. There is no global default device: every entry point
takes one explicitly, and asking for CUDA without a card is an error rather
than a silent fall back to the CPU."""

from __future__ import annotations

import contextlib
import statistics

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"`` (the card; raises without one) or ``"cpu"`` (tests only); a
    ``torch.device`` passes through."""
    if isinstance(name, torch.device):
        return name
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (cuda|cpu)")


@contextlib.contextmanager
def no_tf32():
    """float32 as the JAX package's ``Precision.HIGHEST``: no TF32 in cuDNN
    convs (their default) or matmuls, and no reduced-precision bf16
    reductions, for the body of the ``with``; the global flags are restored
    after it. No effect on the CPU."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags


def device_ms(fn, kernel: str, iters: int = 50, warmup: int = 2) -> float:
    """Mean device time in ms of one launch of the kernel whose name holds
    ``kernel``, over ``iters`` calls of ``fn`` traced by torch.profiler: the
    kernel's own time on the card, without the host's time around its
    launch (which :func:`cuda_ms` of a short kernel mostly measures)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the trace may drop a launch's record now and then, and has been seen to
    # drop all of them; none, or more than were made, means the name picks
    # out no kernel or others besides it, so a trace with none is taken again
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and e.self_device_time_total > 0]
        launches = sum(e.count for e in events)
        if launches:
            break
    if not 0 < launches <= iters:
        raise RuntimeError(f"device_ms: {launches} launches of a kernel named like {kernel!r} "
                           f"traced in {iters} calls")
    return sum(e.self_device_time_total for e in events) / launches / 1e3


def cuda_ms(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the card: after ``warmup`` calls,
    the median over ``reps`` of the CUDA-event time of ``iters`` calls, the
    host's time of the calls included where it exceeds the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
