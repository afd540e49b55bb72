"""Recon-difference mask stage (counterpart of critic_vae_tpu/ops/mask.py).

Per frame: critic score; encode; decode the same latent twice, at the
critic value and at 0, as one 2B batch; |tanh diff| -> Rec.601 grey ->
per-frame max (kernel B1 on CUDA). Then the global mean-max normalisation to
uint8 and the threshold compare.

The uint8 semantics are the reference's and are spelled out here, because
torch's float -> uint8 cast alone gives none of them:

* ``normalize_diffs_given_mean`` multiplies by the reciprocal ``factor`` and
  truncates (its values lie in [0, 255]);
* ``quantize_recons`` maps non-finite to 0, truncates, then wraps mod 256;
* ``threshold_masks`` compares in int32, so t > 255 gives all False.
"""

from __future__ import annotations

import torch

from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops.diff_mask import diff_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def diff_images(vae: VAE, x: torch.Tensor, values: torch.Tensor):
    """Batched double-decode diff of NCHW frames ``x`` (B, 3, H, W).

    Returns (diff (B, H, W) f32, max_value (B,) f32). The reconstructions
    are never formed: only their pre-tanh activations reach kernel B1."""
    mu, _ = vae.encode(x)
    b = mu.shape[0]
    pre = vae.decode(
        torch.cat([mu, mu]),
        torch.cat([values.reshape(b), torch.zeros(b, dtype=values.dtype, device=values.device)]),
        apply_tanh=False,
    )
    return diff_mask(pre[:b], pre[b:])


def normalize_diffs(diffs: torch.Tensor, max_values: torch.Tensor):
    """Two-pass mean-max normalisation -> (diff_u8 (B, H, W), mean_max)."""
    mean_max = torch.mean(max_values)
    return normalize_diffs_given_mean(diffs, mean_max), mean_max


def normalize_diffs_given_mean(diffs: torch.Tensor, mean_max) -> torch.Tensor:
    """Clamp at ``mean_max``, scale by its reciprocal (0 if it is 0), and
    quantize with the reference's truncating ``(d*255).astype(uint8)``."""
    mean = torch.as_tensor(mean_max, dtype=torch.float32, device=diffs.device)
    factor = torch.where(mean != 0, 1.0 / torch.where(mean == 0, 1.0, mean), 0.0)
    clamped = torch.minimum(diffs, mean) * factor
    # in [0, 255] for finite diffs; trunc makes the cast's truncation explicit
    return torch.trunc(clamped * 255.0).to(torch.uint8)


def quantize_recons(recon: torch.Tensor) -> torch.Tensor:
    """Float reconstruction -> uint8 with the reference's host cast
    ``(x*255).astype(np.uint8)``: non-finite -> 0, truncation toward zero,
    modulo-256 wrap of negatives."""
    scaled = recon.float() * 255.0
    scaled = torch.where(torch.isfinite(scaled), scaled, 0.0)
    return torch.remainder(torch.trunc(scaled), 256.0).to(torch.uint8)


def threshold_masks(diff_u8: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """diff_u8 (B, H, W) uint8 x thresholds (T,) -> (T, B, H, W) bool,
    compared in int32 (t > 255 gives all False)."""
    return diff_u8[None].to(torch.int32) > thresholds.to(torch.int32)[:, None, None, None]


def iou_stacked(gt: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Whole-stack IoU per threshold: gt (B, H, W) x masks (T, B, H, W) ->
    (T,) float32 (0/0 -> 1.0)."""
    g = gt[None].bool()
    m = masks.bool()
    tp = torch.sum(g & m, dim=(1, 2, 3))
    union = tp + torch.sum(g & ~m, dim=(1, 2, 3)) + torch.sum(~g & m, dim=(1, 2, 3))
    ratio = tp.to(torch.float32) / torch.clamp_min(union, 1).to(torch.float32)
    return torch.where(union == 0, 1.0, ratio)


@torch.inference_mode()
def episode_forward(vae: VAE, critic: Critic, frames: torch.Tensor, *,
                    compute_dtype: str = "float32"):
    """Per-frame stage of the video pipeline over one batch (the JAX
    ``episode_forward`` for ``mask_source="diff"``, split front end, mask
    only).

    ``frames`` (B, H, W, 3), uint8 (normalised on the device as f32/255) or
    float in [0, 1]. Returns dict(preds (B,), diff (B, H, W), max_value
    (B,)), all float32 on ``frames``' device."""
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    cdt = DTYPES[compute_dtype]
    x = frames.to(cdt).permute(0, 3, 1, 2).contiguous()
    preds = critic(x)[:, 0]
    diff, max_value = diff_images(vae, x, preds.to(cdt))
    return {"preds": preds.float(), "diff": diff, "max_value": max_value}
