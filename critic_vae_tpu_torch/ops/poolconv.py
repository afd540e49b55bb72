"""Fused SAME-conv + maxpool2 by phase packing, NCHW/OIHW (counterpart of
critic_vae_tpu/ops/poolconv.py).

The four pool candidates ``y[2i+a, 2j+b]`` of a K×K stride-1 SAME conv are
one stride-2 conv with a (K+1)×(K+1) kernel and 4·C_out output channels:
phase (a, b)'s kernel embedded at offset (a, b), zero elsewhere. ``max``
over the four phase groups is the 2×2 max-pool, and any per-channel affine
(BatchNorm) applied per phase before the max commutes with the reference's
conv → affine → pool order, negative scales included.

The space-to-depth form goes one step further: a ≤6-tap window read at even
offsets is a 3-block window over 2×2 pixel blocks, so the same phases are one
3×3 stride-1 conv over the (B, 4·C_in, H/2+2, W/2+2) space-to-depth input
with weights ``w3[o, (p, q, c), u, v] = w6[o, c, 2u+p, 2v+q]``.

Layouts and channel orders are the JAX package's, in NCHW/OIHW:

* packed output channel ``(2a+b)·C_out + c`` is phase (a, b) of channel c
  (phase-major), so the phase tensors view as (B, 4, C_out, H/2, W/2);
* a space-to-depth channel is ``(2p+q)·C + c`` (block order (p, q, c));
* a K=3 kernel's packed 4×4 window sits at offset (1, 1) of the 6×6 window.

These are plain convs (cuDNN on the card), as they were XLA convs in the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_pool_phases(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K, K) → (4·C_out, C_in, K+1, K+1) phase-packed kernel,
    phase-major output channels."""
    k = w.shape[-1]
    if w.shape[-2] != k:
        raise ValueError(f"pack_pool_phases: square kernels only, got {tuple(w.shape)}")
    # F.pad pads the last dim first: (left, right, top, bottom) = (b, 1-b, a, 1-a)
    return torch.cat([F.pad(w, (b, 1 - b, a, 1 - a)) for a in (0, 1) for b in (0, 1)])


def conv_pool2_phases(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """All four pool candidates of ``maxpool2(convKxK_SAME(x, w))`` in one
    stride-2 conv: x (B, C_in, H, W), H and W even; w (C_out, C_in, K, K), K
    odd. Returns the pre-bias phase tensors (B, 4, C_out, H/2, W/2)."""
    k = w.shape[-1]
    y = F.conv2d(x, pack_pool_phases(w.to(x.dtype)), stride=2, padding=(k - 1) // 2)
    b, _, h2, w2 = y.shape
    return y.view(b, 4, w.shape[0], h2, w2)


def conv_pool2_max(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``maxpool2(conv_same(x, w) + b)``: the bias is added after the max (it
    is constant over the candidate set)."""
    return conv_pool2_phases(x, w).amax(dim=1) + b.to(x.dtype)[:, None, None]


def _embed6(w_packed: torch.Tensor, k: int) -> torch.Tensor:
    """A packed (K+1)×(K+1) phase kernel inside the 6×6 window whose base
    offset is 2i−2 (pad 2): K=5 is the identity, K=3 sits at offset (1, 1)."""
    if k == 5:
        return w_packed
    if k == 3:
        return F.pad(w_packed, (1, 1, 1, 1))
    raise ValueError(f"s2d pool-conv supports K in (3, 5), got {k}")


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, 4·C, H/2, W/2), channel ``(2p+q)·C + c`` holding
    pixel (2i+p, 2j+q) of channel c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)  # (b, c, i, p, j, q)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def s2d_pool_weights(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K, K) → (4·C_out, 4·C_in, 3, 3) space-to-depth phase
    kernel."""
    w6 = _embed6(pack_pool_phases(w), w.shape[-1])  # (4·C_out, C_in, 6, 6)
    cout4, cin = w6.shape[:2]
    w3 = w6.reshape(cout4, cin, 3, 2, 3, 2)         # (o, c, u, p, v, q)
    return w3.permute(0, 3, 5, 1, 2, 4).reshape(cout4, 4 * cin, 3, 3)


def s2d_conv_pool2_phases(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The contract of :func:`conv_pool2_phases`, computed as one 3×3
    stride-1 conv over the 2×2 space-to-depth of the input padded by 2.
    Returns (B, 4, C_out, H/2, W/2) pre-bias phase tensors."""
    w3 = s2d_pool_weights(w.to(x.dtype))
    xs = space_to_depth2(F.pad(x, (2, 2, 2, 2)))    # (B, 4·C_in, H/2+2, W/2+2)
    y = F.conv2d(xs, w3)
    b, _, h2, w2 = y.shape
    return y.view(b, 4, w.shape[0], h2, w2)
