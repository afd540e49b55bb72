"""Recon-difference mask stage (counterpart of critic_vae_tpu/ops/mask.py),
and beside it the saliency mask source (``mask_source="saliency"``: the
critic's saliency maps of ops/saliency.py in the diff maps' place).

Per frame: critic score; encode; decode the same latent twice, at the
critic value and at 0, as one 2B batch; |tanh diff| -> Rec.601 grey ->
per-frame max (kernel B1 on CUDA; tanh of the widened decode in float32, as
the JAX package's compiled tails). Then the global mean-max normalisation to
uint8 and the threshold compare.

The bfloat16 arithmetic is the JAX package's as XLA compiles it: each op
rounds to bf16, except a sum or a tanh whose only use is a cast to float32
(XLA drops that rounding), which is the encoder's conv bias before its
BatchNorm (ops/epilogue.py::batchnorm_eval) and tanh before the difference.

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

The pipelines' whole-stack IoUs are counted on the masks' device
(``iou_counts``) and divided on the host as ops/iou.py does
(``ious_from_counts``).
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops import epilogue
from critic_vae_tpu_torch.ops.epilogue import batchnorm_eval
from critic_vae_tpu_torch.ops.diff_mask import diff_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRONT_ENDS = ("split", "merged")


def decode_pair(vae: VAE, x: torch.Tensor, values: torch.Tensor, **encode_options):
    """The encode of ``x`` and the (2B, 3, H, W) pre-tanh double decode of
    its mu, at ``values`` and at 0."""
    mu, _ = vae.encode(x, **encode_options)
    b = mu.shape[0]
    return vae.decode(
        torch.cat([mu, mu]),
        torch.cat([values.reshape(b), torch.zeros(b, dtype=values.dtype, device=values.device)]),
        apply_tanh=False,
    )


def diff_images(vae: VAE, x: torch.Tensor, values: torch.Tensor, *, fused_pool=False,
                fold_bn: bool = False, pool_impl: str = "reduce_window",
                block0_f32: bool = False, downstream_dtype: torch.dtype | None = None,
                start_block: int = 0):
    """Batched double-decode diff of NCHW frames ``x`` (B, 3, H, W), or of
    block ``start_block-1``'s activation; the options are the encoder's.

    Both tails of the JAX ``diff_images`` (its XLA default and its Pallas
    kernel) compute tanh of the widened decode in float32 once compiled:
    the XLA tail casts tanh's bf16 result to float32 for the difference, and
    XLA drops the rounding between the two (its excess-precision rule). Here
    kernel B1 computes that.

    Returns (diff (B, H, W) f32, max_value (B,) f32). The reconstructions
    are never formed: only their pre-tanh activations reach kernel B1."""
    pre = decode_pair(vae, x, values, fused_pool=fused_pool, fold_bn=fold_bn,
                       pool_impl=pool_impl, block0_f32=block0_f32,
                       downstream_dtype=downstream_dtype, start_block=start_block)
    return diff_mask(pre)


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


def iou_counts(gt: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Whole-stack (tp, fn, fp) counts of ``masks`` (..., *gt.shape) against
    the ground truth ``gt``, summed over gt's axes on the masks' device:
    (..., 3) int64, one triple per leading index."""
    g, m = gt.bool(), masks.bool()
    axes = tuple(range(m.dim() - g.dim(), m.dim()))
    tp = torch.sum(g & m, dim=axes)
    return torch.stack([tp, torch.sum(g) - tp, torch.sum(m, dim=axes) - tp], dim=-1)


def ious_from_counts(counts: torch.Tensor, round_digits: int | None = 3) -> list[float]:
    """(..., 3) counts of :func:`iou_counts` -> one IoU a triple, in the
    leading axes' order, read back in one copy (or a numpy copy of them
    already on the host). The arithmetic is
    ops/iou.py::iou's on the same counts (Python ints, tp / (tp + fn + fp),
    0/0 -> 1.0, rounded to ``round_digits``; None leaves it unrounded), so
    each IoU is bitwise the one numpy gives for the same masks."""
    out = []
    for tp, fn, fp in counts.reshape(-1, 3).tolist():
        union = tp + fn + fp
        val = 1.0 if union == 0 else tp / union
        out.append(round(val, round_digits) if round_digits is not None else val)
    return out


def resolve_front_end(front_end: str, *, fused_pool=False, fold_bn: bool = False,
                      block0_f32: bool = False, mask_source: str = "diff") -> str:
    """``auto`` → ``merged`` unless ``block0_f32``, ``fused_pool`` or
    ``fold_bn`` asks for the split first convs, or the mask source is
    ``saliency``; ``split`` and ``merged`` pass through; any other name
    raises."""
    if front_end == "auto":
        split = block0_f32 or fused_pool or fold_bn or mask_source != "diff"
        front_end = "split" if split else "merged"
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
    branch adds its bias in that dtype before the cast to ``cdt`` (the
    encoder's sum unrounded into BN when the dtypes agree, as XLA compiles
    it), then runs its own order: encoder BN → pool → ReLU, critic ReLU →
    pool; with the dtypes alike both branches are one ``pool_epilogue``
    (ops/epilogue.py: one launch of the ``block_epilogue`` kernel for
    float32 on the card without autograd). Returns
    (h_enc, h_critic), the post-pool activations that the nets resume from
    at ``start_block=1``."""
    enc0, bn0, cr0 = vae.encoder.convs[0], vae.encoder.bns[0], critic.convs[0]
    conv_dt = x.dtype
    ne = enc0.out_channels
    y = F.conv2d(x, merged_conv0_weight(vae, critic).to(conv_dt), padding=enc0.padding)
    if conv_dt == cdt:  # the bias sum feeds BN unrounded (ops/epilogue.py::batchnorm_eval)
        return epilogue.pool_epilogue(y, enc0.bias, bn0, cr0.bias,
                                      cache=vae.encoder.epilogue_cache)
    ye = batchnorm_eval(bn0, (y[:, :ne] + enc0.bias.to(conv_dt)[:, None, None]).to(cdt))
    yc = F.relu((y[:, ne:] + cr0.bias.to(conv_dt)[:, None, None]).to(cdt))
    return F.relu(F.max_pool2d(ye, 2)), F.max_pool2d(yc, 2)


MASK_SOURCES = ("diff", "saliency")


def episode_forward(vae: VAE, critic: Critic, frames: torch.Tensor, *,
                    compute_dtype: str = "float32", fused_pool=False, fold_bn: bool = False,
                    pool_impl: str = "reduce_window", block0_f32: bool = False,
                    front_end: str = "auto", with_recons: bool = False,
                    recons_u8: bool = False, mask_source: str = "diff",
                    saliency_logits: bool = False, saliency_samples: int = 1,
                    saliency_noise: float = 0.0, saliency_sigma: float | None = None,
                    saliency_seed: int | None = None, saliency_method: str = "gradient",
                    saliency_cam_block: int = 1, saliency_cam_upsample: str = "lanczos3",
                    saliency_tta_flip: bool = False, saliency_tta_shift: int = 0,
                    saliency_rows: tuple | None = None):
    """Per-frame stage of the video pipeline over one batch (the JAX
    ``episode_forward``).

    ``frames`` (B, H, W, 3), uint8 (normalised on the device as f32/255) or
    float in [0, 1]. ``front_end``: ``auto`` (default), ``split`` or
    ``merged`` (:func:`resolve_front_end`). The serving options reach the
    split front end: ``fused_pool=True`` gives the critic ``"s2d"`` and the
    encoder its FUSED_POOL_SERVING, a 4-tuple goes to the encoder alone;
    ``fold_bn`` and ``pool_impl`` are the encoder's; ``block0_f32`` runs both
    first convs in float32 on the float32 frames. Returns dict(preds (B,),
    diff (B, H, W), max_value (B,)), all float32 on ``frames``' device.

    ``mask_source="saliency"`` takes the critic's saliency maps
    (ops/saliency.py::critic_saliency, with the ``saliency_*`` options) as
    ``diff`` and their per-frame max as ``max_value``; the stage runs in
    float32 with TF32 off whatever ``compute_dtype``, and ``preds`` are
    probabilities. SmoothGrad (``saliency_noise > 0``) draws its noise from a
    generator seeded ``saliency_seed`` on the frames' device (required then);
    ``saliency_rows=(start, total)`` says that ``frames`` are rows start.. of
    a batch of ``total`` (a rank's rows under a mesh), whose whole noise is
    drawn and these rows' taken, so each frame gets the noise it gets in
    one process.
    ``auto`` resolves to ``split`` for it; ``merged`` and ``block0_f32``
    raise, with the JAX package's messages. The diff source runs under
    ``torch.inference_mode``, the saliency stage with autograd.

    ``with_recons`` adds ``recon_one`` and ``recon_zero`` (B, H, W, 3): tanh
    of the two decodes, in float32 (the decode widened first: XLA drops the
    bf16 rounding of the JAX package's tanh before its cast to float32), as
    uint8 by :func:`quantize_recons` with ``recons_u8``; with the saliency
    source the split encoder's decodes at ``preds`` in ``compute_dtype``.
    Without it nothing more is computed than for the masks."""
    if mask_source not in MASK_SOURCES:
        raise ValueError(f"unknown mask_source {mask_source!r} (diff|saliency)")
    front_end = resolve_front_end(front_end, fused_pool=fused_pool, fold_bn=fold_bn,
                                  block0_f32=block0_f32, mask_source=mask_source)
    if front_end == "merged" and mask_source != "diff":
        raise ValueError(
            "front_end='merged' fuses the critic/encoder first convs on the "
            "diff mask path; the saliency source differentiates through the "
            "whole critic and has no split first conv to merge"
        )
    if block0_f32 and mask_source != "diff":
        raise ValueError(
            "block0_f32 applies to the diff path's first conv blocks; the "
            "saliency stage already runs in float32 end-to-end "
            "(ops/saliency.py) — combining them would only silently run "
            "the with_recons VAE decode in f32 instead of compute_dtype"
        )
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    cdt = DTYPES[compute_dtype]
    if mask_source == "diff":
        return _diff_forward(vae, critic, frames, cdt, front_end=front_end,
                             fused_pool=fused_pool, fold_bn=fold_bn, pool_impl=pool_impl,
                             block0_f32=block0_f32, with_recons=with_recons,
                             recons_u8=recons_u8)
    from critic_vae_tpu_torch.ops.saliency import critic_saliency

    generator = None
    if saliency_noise > 0.0:
        if saliency_seed is None:
            raise ValueError("episode_forward: saliency SmoothGrad sampling needs saliency_seed")
        generator = torch.Generator(device=frames.device).manual_seed(int(saliency_seed))
    sigma_kw = {} if saliency_sigma is None else {"smooth_sigma": saliency_sigma}
    preds, sal = critic_saliency(
        critic, frames.float().permute(0, 3, 1, 2), logits=saliency_logits,
        samples=saliency_samples, noise=saliency_noise, generator=generator,
        method=saliency_method, cam_block=saliency_cam_block,
        cam_upsample=saliency_cam_upsample, tta_flip=saliency_tta_flip,
        tta_shift=saliency_tta_shift, noise_rows=saliency_rows, **sigma_kw)
    out = {"preds": preds, "diff": sal, "max_value": sal.amax(dim=(1, 2))}
    if with_recons:
        with torch.inference_mode():
            x = frames.to(cdt).permute(0, 3, 1, 2).contiguous()
            out.update(recons_from_decode(decode_pair(vae, x, preds.to(cdt)), recons_u8))
    return out


def recons_from_decode(pre: torch.Tensor, recons_u8: bool) -> dict:
    """recon_one and recon_zero (B, H, W, 3) of the (2B, 3, H, W) pre-tanh
    double decode: tanh of the widened decode, uint8 with ``recons_u8``."""
    recon = torch.tanh(pre.float()).permute(0, 2, 3, 1)
    if recons_u8:
        recon = quantize_recons(recon)
    b = pre.shape[0] // 2
    return {"recon_one": recon[:b], "recon_zero": recon[b:]}


@torch.inference_mode()
def _diff_forward(vae: VAE, critic: Critic, frames: torch.Tensor, cdt: torch.dtype, *,
                  front_end: str, fused_pool, fold_bn: bool, pool_impl: str,
                  block0_f32: bool, with_recons: bool, recons_u8: bool):
    """The diff source of :func:`episode_forward` on float frames."""
    # block0_f32: the first convs read the float32 frames, no compute-dtype copy
    x = (frames.float() if block0_f32 else frames.to(cdt)).permute(0, 3, 1, 2).contiguous()
    if front_end == "merged":
        h_enc, h_cr = merged_front_end(vae, critic, x, cdt)
        preds = critic(h_cr, start_block=1)[:, 0]
        pre = decode_pair(vae, h_enc, preds.to(cdt), start_block=1)
    else:
        ddt = cdt if block0_f32 else None
        preds = critic(x, fused_pool="s2d" if fused_pool is True else fused_pool,
                       block0_f32=block0_f32, downstream_dtype=ddt)[:, 0]
        pre = decode_pair(vae, x, preds.to(cdt), fused_pool=fused_pool, fold_bn=fold_bn,
                           pool_impl=pool_impl, block0_f32=block0_f32, downstream_dtype=ddt)
    diff, max_value = diff_mask(pre)
    out = {"preds": preds.float(), "diff": diff, "max_value": max_value}
    if with_recons:
        out.update(recons_from_decode(pre, recons_u8))
    return out
