"""Operations of the ``--quality`` chain's saliency stage, counted from a
configuration's shapes (a multiply-add is two operations), the same
whatever implements them. A frame runs each test-time view (two mirrors ×
three shifts with ``tta_flip`` and ``tta_shift``) through:

* the critic's forward: its convs, head conv and linears (flops.py's
  count);
* the backward from the logit to block ``cam_block``'s post-pool
  activation: the input gradients of the layers after it, each as many
  operations as its forward (the critic's weights take no gradient);
* the upsample of the (h, w) map to (H, W): the products W_h @ map (2·H·h·w)
  and (W_h @ map) @ W_w^T (2·H·w·W).

The stage runs in float32 with TF32 off (ops/saliency.py), so every
operation counts at the float32 peak. Pooling, ReLU, the LayerCAM product
and sum, rolls, flips and the minimum are elementwise and left out."""

from __future__ import annotations

from typing import Dict

from bench_torch.counts import flops


def views(cfg: Dict) -> int:
    """The test-time views of a frame."""
    return (2 if cfg["tta_flip"] else 1) * (3 if cfg["tta_shift"] else 1)


def frame(cfg: Dict) -> float:
    """Operations of one frame's saliency stage."""
    dims, k, s = cfg["critic_dims"], cfg["critic_kernel"], cfg["frame_size"]
    conv, linear = flops._critic(cfg)
    # block i's conv runs at s >> i; the backward reaches block cam_block's output
    after = sum(2 * (s >> i) ** 2 * dims[i - 1] * dims[i] * k * k
                for i in range(cfg["cam_block"] + 1, len(dims)))
    head, bott = cfg["critic_head_kernel"], cfg["critic_bottleneck"]
    backward = after + 2 * dims[-1] * head * head * bott + linear
    h = s >> (cfg["cam_block"] + 1)
    upsample = 2 * s * h * h + 2 * s * h * s
    return views(cfg) * (conv + linear + backward + upsample)
