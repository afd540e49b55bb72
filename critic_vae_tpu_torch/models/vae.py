"""Critic-conditioned VAE, eval forward, NCHW (counterpart of
critic_vae_tpu/models/vae.py::encode and ``decode(fused=False)``).

* Encoder: 4x[conv5x5 SAME -> BatchNorm (running stats) -> maxpool2 ->
  ReLU], Tanh after the last block; channel-major flatten to the bottleneck,
  then fc_mu / fc_var.
* Decoder: the critic value is concatenated onto the latent, Linear(33 ->
  bottleneck), viewed as (C, S, S), 4x[conv5x5 -> ReLU -> nearest x2], a
  last conv5x5 to 3 channels, Tanh unless ``apply_tanh=False``.

NCHW makes the JAX package's channel-major flatten/unflatten (its
transposes around the fc layers) the natural ``view``. BatchNorm runs in
float32 and casts back to the activation dtype, as the JAX package's
``_batchnorm`` does; every other layer runs in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from critic_vae_tpu_torch.models.critic import conv, linear

ENCODER_DIMS = (32, 64, 128, 256)
LATENT_DIM = 32
BOTTLENECK = 4096
BN_EPS = 1e-5


def batchnorm_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm in float32, cast back to x's dtype."""
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean[:, None, None]) * inv[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK):
        super().__init__()
        cins = (channels,) + tuple(dims[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 5, padding=2) for ci, co in zip(cins, dims)
        )
        self.bns = nn.ModuleList(nn.BatchNorm2d(co, eps=BN_EPS) for co in dims)
        self.fc_mu = nn.Linear(bottleneck, latent_dim)
        self.fc_var = nn.Linear(bottleneck, latent_dim)

    def forward(self, x: torch.Tensor):
        """x (B, 3, 64, 64) -> (mu, logvar), each (B, latent)."""
        last = len(self.convs) - 1
        for i, (layer, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.max_pool2d(batchnorm_eval(bn, conv(layer, x)), 2)
            x = torch.tanh(x) if i == last else F.relu(x)
        flat = x.flatten(1)
        return linear(self.fc_mu, flat), linear(self.fc_var, flat)


class Decoder(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK):
        super().__init__()
        self.input = nn.Linear(latent_dim + 1, bottleneck)
        pairs = [(dims[3], dims[2]), (dims[2], dims[1]), (dims[1], dims[0]),
                 (dims[0], dims[0]), (dims[0], channels)]
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 5, padding=2) for ci, co in pairs)
        spatial = int(round((bottleneck / dims[3]) ** 0.5))
        if spatial * spatial * dims[3] != bottleneck:
            raise ValueError(
                f"decoder bottleneck {bottleneck} does not factor into "
                f"(C={dims[3]}) x S x S"
            )
        self.start_shape = (dims[3], spatial, spatial)

    def forward(self, z: torch.Tensor, value: torch.Tensor,
                apply_tanh: bool = True) -> torch.Tensor:
        """z (B, latent), value (B,) -> (B, 3, 64, 64), pre-tanh unless
        ``apply_tanh``."""
        zin = torch.cat([z, value.reshape(-1, 1).to(z.dtype)], dim=1)
        x = linear(self.input, zin).view(z.shape[0], *self.start_shape)
        for layer in self.convs[:-1]:
            x = F.relu(conv(layer, x))
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = conv(self.convs[-1], x)
        return torch.tanh(x) if apply_tanh else x


class VAE(nn.Module):
    def __init__(self, dims=ENCODER_DIMS, channels: int = 3,
                 latent_dim: int = LATENT_DIM, bottleneck: int = BOTTLENECK):
        super().__init__()
        self.encoder = Encoder(dims, channels, latent_dim, bottleneck)
        self.decoder = Decoder(dims, channels, latent_dim, bottleneck)

    def encode(self, x: torch.Tensor):
        return self.encoder(x)

    def decode(self, z: torch.Tensor, value: torch.Tensor,
               apply_tanh: bool = True) -> torch.Tensor:
        return self.decoder(z, value, apply_tanh)
