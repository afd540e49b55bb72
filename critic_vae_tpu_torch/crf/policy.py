"""CRF backend selection (counterpart of critic_vae_tpu/crf/policy.py).

Only the ``device`` backend (the exact mean-field, crf/device.py) is ported;
``host`` (the C++ permutohedral lattice) raises until it is (ROADMAP A.5).

The two pixel limits are the JAX package's TPU measurements, kept as they
are until the H100 crossover is measured (ROADMAP A.5): the exact
formulation's memory is quadratic in pixels (a bf16 N x N matrix is 537 MB
at 128x128 and 8.6 GB at 256x256).
"""

from __future__ import annotations

import torch

DEVICE_MAX_PIXELS = 128 * 128       # largest frame ``auto`` gives the device CRF
DEVICE_HARD_MAX_PIXELS = 256 * 256  # largest frame an explicit ``device`` accepts


def resolve_crf_backend(requested: str, h: int, w: int, *, device: torch.device) -> str:
    """Resolve ``auto`` | ``device`` | ``host`` for h x w frames on ``device``.

    ``auto`` picks ``device`` on CUDA within ``DEVICE_MAX_PIXELS`` and
    ``host`` otherwise; ``host`` is not ported yet and raises."""
    if requested not in ("auto", "host", "device"):
        raise ValueError(f"unknown crf backend {requested!r} (auto|host|device)")
    npix = int(h) * int(w)
    if requested == "device":
        if npix > DEVICE_HARD_MAX_PIXELS:
            raise ValueError(
                f"crf backend 'device' is the exact O(N^2) mean-field; at {h}x{w} "
                f"its per-frame pairwise matrix alone is ~{2 * npix * npix / 1e9:.1f} GB"
            )
        return "device"
    if requested == "auto" and torch.device(device).type == "cuda" and npix <= DEVICE_MAX_PIXELS:
        return "device"
    raise NotImplementedError(
        f"crf backend {requested!r} resolves to 'host' here ({h}x{w} on "
        f"{device}); the host CRF is not ported yet (ROADMAP A.5) — pass "
        "crf_backend='device'"
    )
