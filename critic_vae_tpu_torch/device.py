"""Device selection. There is no global default device: every entry point
takes one explicitly, and asking for CUDA without a card is an error rather
than a silent fall back to the CPU."""

from __future__ import annotations

import statistics

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` (the card; raises without one) or ``"cpu"`` (tests only)."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (cuda|cpu)")


def cuda_ms(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the card: after ``warmup`` calls,
    the median over ``reps`` of the CUDA-event time of ``iters`` calls."""
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
