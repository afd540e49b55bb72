"""Device selection. There is no global default device: every entry point
takes one explicitly, and asking for CUDA without a card is an error rather
than a silent fall back to the CPU."""

from __future__ import annotations

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
