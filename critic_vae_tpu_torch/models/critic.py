"""The frozen critic CNN, eval forward, NCHW (counterpart of
critic_vae_tpu/models/critic.py::critic_apply).

4x[conv3x3 SAME -> ReLU -> maxpool2] with dims (8, 8, 8, 16), a valid 4x4
conv to a 32-d embedding -> ReLU, Linear(32->32) -> ReLU, Linear(32->1),
sigmoid. Dropout is train-only in the reference and absent here.

Parameters stay float32; as in the JAX package, each layer casts its weights
to the input's dtype, so a bfloat16 input runs the whole net in bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (weights cast per call, as the JAX
    package does; the float32 master weights are never rounded in place)."""
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                    padding=layer.padding)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Critic(nn.Module):
    def __init__(self, dims=(8, 8, 8, 16), bottleneck: int = 32, channels: int = 3):
        super().__init__()
        cins = (channels,) + tuple(dims[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 3, padding=1) for ci, co in zip(cins, dims)
        )
        self.conv4 = nn.Conv2d(dims[-1], bottleneck, 4)
        self.fc0 = nn.Linear(bottleneck, bottleneck)
        self.fc1 = nn.Linear(bottleneck, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, 64, 64) in [0, 1] -> (B, 1) probabilities, in x's dtype."""
        for layer in self.convs:
            x = F.max_pool2d(F.relu(conv(layer, x)), 2)
        h = F.relu(conv(self.conv4, x)).flatten(1)
        h = F.relu(linear(self.fc0, h))
        return torch.sigmoid(linear(self.fc1, h))
