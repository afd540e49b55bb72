"""CRF backend selection (counterpart of critic_vae_tpu/crf/policy.py).

Two backends compute the same dense-CRF mean field:

* ``host``: the C++ permutohedral lattice (crf/host.py), O(N) a frame on
  the CPU, the only one at large frames;
* ``device``: the exact mean field on the card (crf/device.py), O(N^2) in
  pixels: its memory is quadratic (a bf16 N x N matrix is 537 MB at 128x128
  and 8.6 GB at 256x256).

The two pixel limits are the JAX package's TPU measurements, kept as they
are until the H100 crossover is measured (ROADMAP A.7).
"""

from __future__ import annotations

import torch

from critic_vae_tpu_torch.parallel.distributed import world_size

DEVICE_MAX_PIXELS = 128 * 128       # largest frame ``auto`` gives the device CRF
DEVICE_HARD_MAX_PIXELS = 256 * 256  # largest frame an explicit ``device`` accepts


def resolve_crf_backend(requested: str, h: int, w: int, *, device) -> str:
    """Resolve ``auto`` | ``device`` | ``host`` for h x w frames on ``device``.

    ``auto`` picks ``device`` on a CUDA device in a one-process run (one
    rank of torch.distributed, or no group) within ``DEVICE_MAX_PIXELS`` and
    ``host`` otherwise (the JAX package's rule, CUDA in the accelerator's
    place); ``host`` is ``host``; an explicit ``device`` is honoured up to
    ``DEVICE_HARD_MAX_PIXELS`` and raises past it."""
    if requested not in ("auto", "host", "device"):
        raise ValueError(f"unknown crf backend {requested!r} (auto|host|device)")
    npix = int(h) * int(w)
    if requested == "device":
        if npix > DEVICE_HARD_MAX_PIXELS:
            raise ValueError(
                f"crf backend 'device' is the exact O(N^2) mean-field; at {h}x{w} "
                f"its per-frame pairwise matrix alone is ~{2 * npix * npix / 1e9:.1f} GB"
                " — use --crf-backend host"
            )
        return "device"
    if requested == "host":
        return "host"
    if torch.device(device).type == "cuda" and world_size() == 1 and npix <= DEVICE_MAX_PIXELS:
        return "device"
    return "host"
