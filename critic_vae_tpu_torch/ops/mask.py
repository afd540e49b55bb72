"""Recon-difference mask stage (counterpart of critic_vae_tpu/ops/mask.py).

Per frame: critic score; encode; decode the same latent twice, at the
critic value and at 0, as one 2B batch; |tanh diff| -> Rec.601 grey ->
per-frame max (kernel B1 on CUDA; tanh in the decode's dtype, as the JAX
default). Then the global mean-max normalisation to
uint8 and the threshold compare.

The front end (the critic's and the encoder's first convs over the
3-channel frames) is ``merged`` by default, as in the JAX package: one
3→40-channel 5×5 conv of the encoder's weights and the critic's zero-padded
3×3 ones, each branch then applying its own bias, BN, pool and activation
(:func:`merged_front_end`). ``split`` runs the two nets whole and takes the
serving options of the JAX ``episode_forward`` (``fused_pool``, ``fold_bn``,
``pool_impl``, ``block0_f32``); ``auto`` resolves as the JAX package does
(:func:`resolve_front_end`).

The uint8 semantics are the reference's and are spelled out here, because
torch's float -> uint8 cast alone gives none of them:

* ``normalize_diffs_given_mean`` multiplies by the reciprocal ``factor`` and
  truncates (its values lie in [0, 255]);
* ``quantize_recons`` maps non-finite to 0, truncates, then wraps mod 256;
* ``threshold_masks`` compares in int32, so t > 255 gives all False.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE, batchnorm_eval
from critic_vae_tpu_torch.ops.diff_mask import diff_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRONT_ENDS = ("split", "merged")


def diff_images(vae: VAE, x: torch.Tensor, values: torch.Tensor, *,
                use_pallas: bool | None = None, fused_pool=False,
                fold_bn: bool = False, pool_impl: str = "reduce_window",
                block0_f32: bool = False, downstream_dtype: torch.dtype | None = None,
                start_block: int = 0):
    """Batched double-decode diff of NCHW frames ``x`` (B, 3, H, W), or of
    block ``start_block-1``'s activation; the options are the encoder's.

    ``use_pallas`` picks the JAX package's tail arithmetic: ``None`` or
    ``False`` its default, tanh in the decode's dtype (bf16-rounded for a
    bf16 decode), ``True`` its Pallas kernel's, tanh of the widened decode in
    float32. Both run kernel B1 on CUDA.

    Returns (diff (B, H, W) f32, max_value (B,) f32). The reconstructions
    are never formed: only their pre-tanh activations reach kernel B1."""
    mu, _ = vae.encode(x, fused_pool=fused_pool, fold_bn=fold_bn, pool_impl=pool_impl,
                       block0_f32=block0_f32, start_block=start_block,
                       downstream_dtype=downstream_dtype)
    b = mu.shape[0]
    pre = vae.decode(
        torch.cat([mu, mu]),
        torch.cat([values.reshape(b), torch.zeros(b, dtype=values.dtype, device=values.device)]),
        apply_tanh=False,
    )
    return diff_mask(pre, f32_tanh=bool(use_pallas))


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


def resolve_front_end(front_end: str, *, fused_pool=False, fold_bn: bool = False,
                      block0_f32: bool = False) -> str:
    """``auto`` → ``merged`` unless ``block0_f32``, ``fused_pool`` or
    ``fold_bn`` asks for the split first convs; ``split`` and ``merged`` pass
    through; any other name raises."""
    if front_end == "auto":
        front_end = "split" if (block0_f32 or fused_pool or fold_bn) else "merged"
    if front_end not in FRONT_ENDS:
        raise ValueError(f"unknown front_end {front_end!r} (split|merged)")
    return front_end


def merged_conv0_weight(vae: VAE, critic: Critic) -> torch.Tensor:
    """(C_enc + C_critic, 3, K, K) float32: the encoder's first conv weights
    and the critic's, zero-padded to the encoder's K, stacked on dim 0."""
    enc0, cr0 = vae.encoder.convs[0], critic.convs[0]
    kh = enc0.kernel_size[0] - cr0.kernel_size[0]
    lo, hi = kh // 2, kh - kh // 2
    return torch.cat([enc0.weight, F.pad(cr0.weight, (lo, hi, lo, hi))])


def merged_front_end(vae: VAE, critic: Critic, x: torch.Tensor, cdt: torch.dtype):
    """Block 0 of both nets from one 3→(C_enc + C_critic)-channel conv.

    The critic's 3×3 first conv, zero-padded to the encoder's 5×5, and the
    encoder's first conv share one conv over NCHW ``x``, in x's dtype; each
    branch adds its bias in that dtype before the cast to ``cdt``, then runs
    its own order: encoder BN → pool → ReLU, critic ReLU → pool. Returns
    (h_enc, h_critic), the post-pool activations that the nets resume from
    at ``start_block=1``."""
    enc0, bn0, cr0 = vae.encoder.convs[0], vae.encoder.bns[0], critic.convs[0]
    conv_dt = x.dtype
    ne = enc0.out_channels
    y = F.conv2d(x, merged_conv0_weight(vae, critic).to(conv_dt), padding=enc0.padding)
    ye = (y[:, :ne] + enc0.bias.to(conv_dt)[:, None, None]).to(cdt)
    h_enc = F.relu(F.max_pool2d(batchnorm_eval(bn0, ye), 2))
    yc = F.relu((y[:, ne:] + cr0.bias.to(conv_dt)[:, None, None]).to(cdt))
    return h_enc, F.max_pool2d(yc, 2)


@torch.inference_mode()
def episode_forward(vae: VAE, critic: Critic, frames: torch.Tensor, *,
                    compute_dtype: str = "float32", fused_pool=False, fold_bn: bool = False,
                    pool_impl: str = "reduce_window", block0_f32: bool = False,
                    front_end: str = "auto"):
    """Per-frame stage of the video pipeline over one batch (the JAX
    ``episode_forward`` for ``mask_source="diff"``, mask only).

    ``frames`` (B, H, W, 3), uint8 (normalised on the device as f32/255) or
    float in [0, 1]. ``front_end``: ``auto`` (default), ``split`` or
    ``merged`` (:func:`resolve_front_end`). The serving options reach the
    split front end: ``fused_pool=True`` gives the critic ``"s2d"`` and the
    encoder its FUSED_POOL_SERVING, a 4-tuple goes to the encoder alone;
    ``fold_bn`` and ``pool_impl`` are the encoder's; ``block0_f32`` runs both
    first convs in float32 on the float32 frames. Returns dict(preds (B,),
    diff (B, H, W), max_value (B,)), all float32 on ``frames``' device."""
    front_end = resolve_front_end(front_end, fused_pool=fused_pool, fold_bn=fold_bn,
                                  block0_f32=block0_f32)
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    cdt = DTYPES[compute_dtype]
    # block0_f32: the first convs read the float32 frames, no compute-dtype copy
    x = (frames.float() if block0_f32 else frames.to(cdt)).permute(0, 3, 1, 2).contiguous()
    if front_end == "merged":
        h_enc, h_cr = merged_front_end(vae, critic, x, cdt)
        preds = critic(h_cr, start_block=1)[:, 0]
        diff, max_value = diff_images(vae, h_enc, preds.to(cdt), start_block=1)
    else:
        ddt = cdt if block0_f32 else None
        preds = critic(x, fused_pool="s2d" if fused_pool is True else fused_pool,
                       block0_f32=block0_f32, downstream_dtype=ddt)[:, 0]
        diff, max_value = diff_images(vae, x, preds.to(cdt), fused_pool=fused_pool,
                                      fold_bn=fold_bn, pool_impl=pool_impl,
                                      block0_f32=block0_f32, downstream_dtype=ddt)
    return {"preds": preds.float(), "diff": diff, "max_value": max_value}
