"""The reference's critic and VAE (Critic-VAE ``critic_net.py`` and
``vae_nets.py``) in plain torch float32, NCHW, on a state dict ``p`` of
torch-layout tensors (bench_torch/weights.py's names).

* Critic: 4 × [conv3x3 SAME → ReLU → maxpool2], a valid 4x4 conv → ReLU,
  Linear → ReLU, Linear → sigmoid.
* Encoder: 4 × [conv5x5 SAME → BatchNorm → maxpool2 → ReLU], tanh after the
  last block, a channel-major flatten, then fc_mu and fc_var. BatchNorm
  uses its running statistics, or with ``train=True`` the batch's (biased
  variance) and returns the moved running statistics (momentum 0.1,
  unbiased variance).
* Decoder: Linear(latent + 1 → bottleneck) of the latent with the critic
  value appended, viewed as (C, S, S); conv5x5 → ReLU, then 3 × [nearest ×2
  → conv5x5 → ReLU], nearest ×2 → conv5x5, tanh unless ``tanh=False``. The
  upsampled image is formed, as published.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


def critic(p: State, x: torch.Tensor) -> torch.Tensor:
    """(B,) probabilities of NCHW frames in [0, 1]."""
    for i in range(4):
        w = p[f"convs.{i}.weight"]
        x = F.max_pool2d(F.relu(F.conv2d(x, w, p[f"convs.{i}.bias"], padding=w.shape[-1] // 2)), 2)
    h = F.relu(F.conv2d(x, p["conv4.weight"], p["conv4.bias"])).flatten(1)
    h = F.relu(F.linear(h, p["fc0.weight"], p["fc0.bias"]))
    return torch.sigmoid(F.linear(h, p["fc1.weight"], p["fc1.bias"]))[:, 0]


def _bn(x: torch.Tensor, p: State, i: int, train: bool, eps: float, momentum: float,
        stats: List):
    pre = f"encoder.bns.{i}"
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            stats.append(((1 - momentum) * p[f"{pre}.running_mean"] + momentum * mean,
                          (1 - momentum) * p[f"{pre}.running_var"]
                          + momentum * var * (n / (n - 1))))
    else:
        mean, var = p[f"{pre}.running_mean"], p[f"{pre}.running_var"]
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + eps)
    return y * p[f"{pre}.weight"][:, None, None] + p[f"{pre}.bias"][:, None, None]


def encoder(p: State, x: torch.Tensor, train: bool = False, eps: float = 1e-5,
            momentum: float = 0.1):
    """(mu, logvar), and with ``train`` the list of each block's moved
    running (mean, var) after them."""
    stats: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i in range(4):
        w = p[f"encoder.convs.{i}.weight"]
        y = F.conv2d(x, w, p[f"encoder.convs.{i}.bias"], padding=w.shape[-1] // 2)
        y = F.max_pool2d(_bn(y, p, i, train, eps, momentum, stats), 2)
        x = torch.tanh(y) if i == 3 else F.relu(y)
    flat = x.flatten(1)
    mu = F.linear(flat, p["encoder.fc_mu.weight"], p["encoder.fc_mu.bias"])
    logvar = F.linear(flat, p["encoder.fc_var.weight"], p["encoder.fc_var.bias"])
    return (mu, logvar, stats) if train else (mu, logvar)


def decoder(p: State, z: torch.Tensor, value: torch.Tensor, tanh: bool = True) -> torch.Tensor:
    """(B, 3, H, W) decode of latents ``z`` at critic values ``value``."""
    x = F.linear(torch.cat([z, value.reshape(-1, 1).to(z.dtype)], dim=1),
                 p["decoder.input.weight"], p["decoder.input.bias"])
    c = p["decoder.convs.0.weight"].shape[1]
    side = int(round((x.shape[1] / c) ** 0.5))
    x = x.view(z.shape[0], c, side, side)
    for i in range(5):
        if i:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        w = p[f"decoder.convs.{i}.weight"]
        x = F.conv2d(x, w, p[f"decoder.convs.{i}.bias"], padding=w.shape[-1] // 2)
        if i < 4:
            x = F.relu(x)
    return torch.tanh(x) if tanh else x
