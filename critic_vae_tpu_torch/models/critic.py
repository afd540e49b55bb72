"""The frozen critic CNN, eval forward, NCHW (counterpart of
critic_vae_tpu/models/critic.py::critic_apply).

4x[conv3x3 SAME -> ReLU -> maxpool2] with dims (8, 8, 8, 16), a valid 4x4
conv to a 32-d embedding -> ReLU, Linear(32->32) -> ReLU, Linear(32->1),
sigmoid. Dropout (``dropout_rate > 0``) is the train mode of
``critic_apply(train=True)``: after block 2's and block 3's pools and after
fc0's ReLU, ``where(mask, h / keep, 0)``, the masks drawn from a
``torch.Generator`` or given (the JAX package's bernoulli draws, for parity).

Parameters stay float32; as in the JAX package, each layer casts its weights
to the input's dtype, so a bfloat16 input runs the whole net in bfloat16.

The serving formulations of ``critic_apply`` are options of
:meth:`Critic.forward`: the phase-packed (``fused_pool=True``) and
space-to-depth (``"s2d"``, first block only) conv+pool of ops/poolconv.py,
the float32 first conv (``block0_f32``) and the resume point
``start_block`` of the merged front end (ops/mask.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from critic_vae_tpu_torch.ops.poolconv import conv_pool2_max, s2d_conv_pool2_phases


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``layer`` applied with its weights cast to ``dtype`` (default x's
    dtype), per call, as the JAX package does; the float32 master weights are
    never rounded in place. The bias is added after the conv, in ``dtype``,
    as the JAX package's ``conv(x, w) + b``: in bfloat16 the conv's output is
    rounded before the sum, so the sum rounds twice (a bias folded into the
    conv rounds once and gives another bf16 value in ~30% of outputs)."""
    dtype = x.dtype if dtype is None else dtype
    y = F.conv2d(x, layer.weight.to(dtype), padding=layer.padding)
    return y + layer.bias.to(dtype)[:, None, None]


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w + b`` with the bias after the product, in ``dtype``, as
    :func:`conv`."""
    dtype = x.dtype if dtype is None else dtype
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each op in x's dtype: XLA expands the JAX
    package's ``jax.nn.sigmoid`` so, and in bfloat16 it rounds after every
    op (``torch.sigmoid`` rounds once, and differs by a bf16 ulp in ~1.7% of
    the bf16 values, 0.5 + 2^-8 against 0.5 for small logits among them).
    Not for a graph that autograd differentiates: once exp(-x) overflows
    (x below about -88 in float32) its backward is NaN, where
    ``jax.nn.sigmoid``'s is y(1 - y); ops/saliency.py differentiates
    ``torch.sigmoid`` of the logits instead."""
    return 1 / (1 + torch.exp(-x))


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

    def forward(self, x: torch.Tensor, *, fused_pool: bool | str = False,
                block0_f32: bool = False, downstream_dtype: torch.dtype | None = None,
                start_block: int = 0, return_logits: bool = False, tap: int | None = None,
                dropout_rate: float = 0.0, generator: torch.Generator | None = None,
                dropout_masks=None):
        """x (B, 3, 64, 64) in [0, 1] -> (B, 1) probabilities, or the
        pre-sigmoid logits with ``return_logits``.

        ``fused_pool``: ``True`` runs every block as the phase-packed
        stride-2 conv; ``"s2d"`` runs the first block as the space-to-depth
        3×3 phase conv. ``block0_f32``: the first conv in float32, its output
        cast to ``downstream_dtype``. ``downstream_dtype``: the dtype of
        everything after block 0 (default x's). ``start_block``: resume at
        this block with x the previous block's post-pool activation.
        ``tap=k`` (0-3) also returns block k's post-pool activation, as
        ``critic_apply(tap_offset=(k, zeros))`` does: ``(out, activation)``,
        so that ``torch.autograd.grad`` of the output w.r.t. it is LayerCAM's
        d out / d A (ops/saliency.py).

        ``dropout_rate > 0`` is training's dropout, as ``critic_apply(train=True,
        dropout_rate=...)``: the keep masks of block 2's pooled (B, 8, 8, 8),
        block 3's pooled (B, 16, 4, 4) and fc0's (B, 32) are ``dropout_masks``
        (three bool tensors in that order, NCHW) or, without them, uniform
        draws from ``generator`` below ``1 - dropout_rate``."""
        if dropout_rate > 0.0 and dropout_masks is None and generator is None:
            raise ValueError("dropout requires a generator or dropout_masks")
        masks = iter(dropout_masks or ())

        def dropout(h):
            if dropout_rate <= 0.0:
                return h
            keep = 1.0 - dropout_rate
            mask = next(masks, None)
            if mask is None:
                mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            return torch.where(mask.to(h.device), h / keep, 0.0).to(h.dtype)

        if tap is not None and not start_block <= tap < len(self.convs):
            raise ValueError(
                f"tap block must be in {start_block}..{len(self.convs) - 1} (post-pool "
                f"activations), got {tap}")
        dtype = x.dtype if downstream_dtype is None else downstream_dtype
        tapped = None
        for i in range(start_block, len(self.convs)):
            layer = self.convs[i]
            if fused_pool == "s2d" and i == 0:
                y = s2d_conv_pool2_phases(x, layer.weight.to(dtype))
                x = F.relu(y.amax(dim=1) + layer.bias.to(dtype)[:, None, None])
            elif fused_pool is True:
                x = F.relu(conv_pool2_max(x, layer.weight.to(dtype), layer.bias.to(dtype)))
            else:
                if block0_f32 and i == 0:
                    x = conv(layer, x.float()).to(dtype)
                else:
                    x = conv(layer, x, dtype)
                x = F.max_pool2d(F.relu(x), 2)
            if i == tap:
                tapped = x
            if i >= 2:
                x = dropout(x)
        h = F.relu(conv(self.conv4, x, dtype)).flatten(1)
        h = dropout(F.relu(linear(self.fc0, h, dtype)))
        logit = linear(self.fc1, h, dtype)
        out = logit if return_logits else sigmoid(logit)
        return out if tap is None else (out, tapped)
