"""MS-SSIM reconstruction loss, NCHW (counterpart of
critic_vae_tpu/ops/msssim.py; reference: vae_nets.py:150-247).

The reference's MSSIM module carries two quirks that define the training
objective, and ``faithful=True`` (the default) keeps both:

1. its "gaussian" window has no minus sign in the exponent
   (vae_nets.py:171): ``exp(+(x-5)²/(2σ²))`` normalised, an edge-weighted
   kernel ``[0.424, 0.057, …, 0.057, 0.424]``;
2. the scales combine as ``prod(pow1[:-1] * pow2[-1])`` (vae_nets.py:246):
   the last scale's SSIM is broadcast into the product of the four contrast
   terms, four times its weight.

``faithful=False`` is the textbook form (``train --correct-msssim``).

Each windowed mean is the 11-tap window applied along H and then W, as two
depthwise convs with zero padding 5 (SAME; at the 4×4 last scale the pad is
wider than the image), and each scale halves by a 2×2 average pool. These
are library ops: the JAX package computes them with XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.parallel.mesh import global_mean, grouped

WINDOW_SIZE = 11
SIGMA = 1.5
WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
FLOOR = 1e-4  # the straight-through floor under the fractional powers


@functools.cache
def window_1d(faithful: bool = True, window_size: int = WINDOW_SIZE,
              sigma: float = SIGMA) -> np.ndarray:
    """The 1-D window; ``faithful=True`` keeps the sign bug (vae_nets.py:171)."""
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    sign = 1.0 if faithful else -1.0
    k = np.exp(sign * x**2 / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _window(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The separable depthwise window over NCHW ``x`` with SAME zero padding;
    ``k`` the 1-D window in x's dtype."""
    c, n = x.shape[1], k.shape[0]
    y = F.conv2d(x, k.view(1, 1, n, 1).expand(c, 1, n, 1), padding=(n // 2, 0), groups=c)
    return F.conv2d(y, k.view(1, 1, 1, n).expand(c, 1, 1, n), padding=(0, n // 2), groups=c)


def _ssim_level(img1: torch.Tensor, img2: torch.Tensor, k: torch.Tensor):
    """One scale (reference: vae_nets.py:181-215): (ssim, cs), each the mean
    over the whole batch."""
    mu1, mu2 = _window(img1, k), _window(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _window(img1 * img1, k) - mu1_sq
    sigma2_sq = _window(img2 * img2, k) - mu2_sq
    sigma12 = _window(img1 * img2, k) - mu1_mu2
    c1 = 0.01**2  # the reference fixes img_range at 1.0 (vae_nets.py:201)
    c2 = 0.03**2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return torch.mean(ssim_map), cs


def st_floor(x: torch.Tensor, eps: float = FLOOR) -> torch.Tensor:
    """max(x, eps) forward with the identity's gradient (straight through): a
    hard clamp would zero the gradient wherever it clamps and strand training
    at loss ≈ 1 with no signal back."""
    return x + (torch.clamp_min(x, eps) - x).detach()


def msssim_loss(img1: torch.Tensor, img2: torch.Tensor, *, faithful: bool = True,
                mesh=None) -> torch.Tensor:
    """1 − MS-SSIM over 5 scales of NCHW images (reference: vae_nets.py:217-247).

    Each scale's SSIM and CS are floored at 1e-4 before the fractional powers
    (:func:`st_floor`). They can go negative early in training, where
    ``x**0.28`` is NaN; the floor changes values only where the reference's
    objective is NaN.

    Each scale's SSIM and CS are means over the whole batch, so with a
    grouped ``mesh`` (parallel/mesh.py; the images this rank's equal share
    of the global batch) the 10 means are taken over the global batch, in
    one reduction, before the floor and the powers: the loss of the global
    batch on every rank, not a mean of the ranks' losses."""
    k = torch.from_numpy(window_1d(faithful)).to(device=img1.device, dtype=img1.dtype)
    weights = torch.tensor(WEIGHTS, dtype=img1.dtype, device=img1.device)
    mssim, mcs = [], []
    for _ in range(len(WEIGHTS)):
        sim, cs = _ssim_level(img1, img2, k)
        mssim.append(sim)
        mcs.append(cs)
        img1, img2 = F.avg_pool2d(img1, 2), F.avg_pool2d(img2, 2)
    mssim, mcs = torch.stack(mssim), torch.stack(mcs)
    if grouped(mesh):
        mssim, mcs = global_mean(mesh, torch.stack([mssim, mcs])).unbind()
    mssim, mcs = st_floor(mssim), st_floor(mcs)
    pow1 = mcs**weights
    pow2 = mssim**weights
    if faithful:
        return 1.0 - torch.prod(pow1[:-1] * pow2[-1])  # quirk 2
    return 1.0 - torch.prod(pow1[:-1]) * pow2[-1]
