"""The ``--quality`` mask chain over one episode, in plain torch float32 with
TF32 off: the frozen critic's LayerCAM (Jiang et al., "LayerCAM: Exploring
Hierarchical Class Activation Maps for Localization", IEEE TIP 2021) over
six test-time views, min-combined, then the episode's mean-max
normalisation and the threshold of reference/video.py.

For frames x (B, 3, H, W) in [0, 1]:

* the critic (Critic-VAE ``critic_net.py``, the state dict's names as
  reference/nets.py reads them) runs to block ``block``'s post-pool
  activation A, then on from A to the pre-sigmoid logit;
* the map is ReLU(d logit / d A · A) summed over A's channels, (B, h, w);
* it is upsampled to (H, W) by Lanczos3 matrices, R = W_h @ map @ W_w^T,
  and clamped at 0;
* the views are {identity, mirror} × {0, +shift, −shift} columns: a view
  is the frames mirrored, then rolled; the columns its roll wrapped round
  are set to +inf in its map, which is then rolled and mirrored back, and
  the six maps' elementwise minimum is the frame's map;
* the score is the sigmoid of the identity view's logit.

Departures from the paper, each the JAX package's choice: the upsample is
``jax.image.resize``'s Lanczos3 (half-pixel centres, the taps that fall
outside the input dropped and the rest renormalised to sum 1), where the
paper upsamples bilinearly; the logit, not a class score after a softmax,
is differentiated (the critic has one output); the test-time views and
their minimum are not in the paper. Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from bench_torch.reference import exact_float32

State = Dict[str, torch.Tensor]


def _blocks(p: State, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Critic blocks lo..hi-1: conv3x3 SAME → ReLU → maxpool2."""
    for i in range(lo, hi):
        w = p[f"convs.{i}.weight"]
        x = F.max_pool2d(F.relu(F.conv2d(x, w, p[f"convs.{i}.bias"], padding=w.shape[-1] // 2)), 2)
    return x


def _logit(p: State, x: torch.Tensor) -> torch.Tensor:
    """(B,) pre-sigmoid logits of the last block's activation: the valid
    4x4 conv → ReLU, Linear → ReLU, Linear."""
    h = F.relu(F.conv2d(x, p["conv4.weight"], p["conv4.bias"])).flatten(1)
    h = F.relu(F.linear(h, p["fc0.weight"], p["fc0.bias"]))
    return F.linear(h, p["fc1.weight"], p["fc1.bias"])[:, 0]


def lanczos3(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 matrix of the Lanczos3 upsample along one axis
    (n_out > n_in): output pixel o samples the input at (o + 0.5) · n_in /
    n_out − 0.5, weighting input pixel j by sinc(d) · sinc(d / 3) for d,
    the distance, under 3; each row divided by its sum. Built in float64,
    rounded once."""
    pos = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    d = (pos[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]).abs()
    w = torch.where(d < 3.0, torch.sinc(d) * torch.sinc(d / 3.0), torch.zeros_like(d))
    return (w / w.sum(dim=1, keepdim=True)).to(device=device, dtype=torch.float32)


def layercam(p: State, x: torch.Tensor, block: int):
    """(logits (B,), upsampled and clamped LayerCAM maps (B, H, W)) of NCHW
    frames ``x``."""
    with torch.enable_grad():
        a = _blocks(p, x, 0, block + 1).detach().requires_grad_(True)
        logit = _logit(p, _blocks(p, a, block + 1, 4))
        (g,) = torch.autograd.grad(logit.sum(), a)
    cam = F.relu(g * a.detach()).sum(dim=1)
    h, w = x.shape[2:]
    up = lanczos3(cam.shape[1], h, x.device) @ cam @ lanczos3(cam.shape[2], w, x.device).T
    return logit.detach(), up.clamp_min(0.0)


def views_min(p: State, x: torch.Tensor, block: int, flip: bool, shift: int):
    """(preds (B,), the min-combined maps (B, H, W)) over the test-time
    views of NCHW frames ``x``."""
    width = x.shape[3]
    cols = torch.arange(width, device=x.device)
    out = preds = None
    for mirror in ((False, True) if flip else (False,)):
        for dx in ((0, shift, -shift) if shift else (0,)):
            v = x.flip(3) if mirror else x
            logit, m = layercam(p, torch.roll(v, dx, dims=3), block)
            if dx:
                # view column c holds frame column c - dx: wrapped where that
                # falls outside [0, W)
                src = cols - dx
                m = torch.where(((src < 0) | (src >= width))[None, None, :], math.inf, m)
                m = torch.roll(m, -dx, dims=2)
            if mirror:
                m = m.flip(2)
            if not mirror and dx == 0:
                preds = torch.sigmoid(logit)
            out = m if out is None else torch.minimum(out, m)
    return preds, out


def episode(critic_p: State, frames_u8: torch.Tensor, threshold: int, block: int = 1,
            flip: bool = True, shift: int = 2, chunk: int = 512) -> Dict:
    """Preds (L,), uint8 maps (L, H, W) and threshold masks (L, H, W) of
    (L, H, W, 3) uint8 frames on the device, the views computed ``chunk``
    frames at a time."""
    with exact_float32(), torch.inference_mode(False):
        preds, maps = [], []
        for lo in range(0, frames_u8.shape[0], chunk):
            x = frames_u8[lo:lo + chunk].float().permute(0, 3, 1, 2) / 255.0
            pr, m = views_min(critic_p, x, block, flip, shift)
            preds.append(pr)
            maps.append(m)
        sal = torch.cat(maps)
        mean_max = sal.amax(dim=(1, 2)).mean()
        if mean_max > 0:
            d = torch.minimum(sal, mean_max) * (1.0 / mean_max)
        else:
            d = torch.zeros_like(sal)
        maps_u8 = torch.trunc(d * 255.0).to(torch.uint8)
        return {"preds": torch.cat(preds), "diff_u8": maps_u8,
                "thr_masks": maps_u8.to(torch.int32) > int(threshold)}
