"""The dense CRF's model terms, shared by every device build: the
epsilons of densecrf.cpp, the pixel coordinates, the truncated spatial
Gaussian with its closed-form normalizer, and the mean field's start.
Imports nothing from the package, so the kernel wrappers (fused_build.py,
fused_resident.py, mean_field_step.py) and the orchestrator above them
(device.py) all take these from here."""

from __future__ import annotations

import numpy as np
import torch

_EPS_PROB = 1e-8   # unary clamp, as densecrf.cpp
_EPS_NORM = 1e-20  # normalizer epsilon, as densecrf.cpp


def _coords(h: int, w: int, device) -> torch.Tensor:
    """(N, 2) pixel coordinates in (x, y) order, float32."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)


def _spatial_taps(gamma: float, h: int, w: int) -> np.ndarray:
    """1-D taps of the separable spatial Gaussian, truncated where it is
    numerically zero (>= 8 gamma) and clamped to the frame, so the length is
    odd and SAME padding is symmetric."""
    radius = min(int(np.ceil(8.0 * gamma)), max(h, w) - 1)
    k = np.arange(-radius, radius + 1, dtype=np.float32)
    return np.exp(-0.5 * (k / np.float32(gamma)) ** 2).astype(np.float32)


def _spatial_norm(taps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 1) n_s = rsqrt(sum_{j != i} K_s[i, j] + 1e-20) on ``taps``'
    device, in float32. The separable conv of ones at (y, x) is the sum of
    the taps inside the frame along y times that along x, taken here in
    closed form (no conv, so no TF32 on a card); it includes the centre tap
    (weight 1), which the -1 takes back out. The same for every frame."""
    taps = taps.float()
    r = taps.shape[0] // 2
    offs = torch.arange(-r, r + 1, device=taps.device)

    def inside(size):
        pos = torch.arange(size, device=taps.device)[:, None] + offs[None, :]
        return torch.where((pos >= 0) & (pos < size), taps, 0.0).sum(dim=1)

    ones_conv = inside(h)[:, None] * inside(w)[None, :]
    return torch.rsqrt(ones_conv.reshape(h * w, 1) - 1.0 + _EPS_NORM)


def _prologue(probs: torch.Tensor):
    """The mean field's start from probabilities (classes on the last axis):
    the unaries U = -log(clamp(p, 1e-8)) and q0 = softmax(-U)."""
    unary = -torch.log(torch.clamp_min(probs, _EPS_PROB))
    return unary, torch.softmax(-unary, dim=-1)
