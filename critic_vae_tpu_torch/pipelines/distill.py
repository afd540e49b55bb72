"""Pseudo-label masks for mask self-distillation (counterpart of
critic_vae_tpu/pipelines/distill.py).

The frozen critic's LayerCAM maps (ops/saliency.py, through the video
pipeline's device stage), the global mean-max normalisation to uint8, the
threshold, and the CAM-tuned dense CRF (pipelines/video.py ``_refine`` on
the resolved backend: on CUDA at 64x64 the device CRF, kernel B2) give one
mask a training frame; ``train(mask_distill=...)`` pushes the VAE's
recon-difference signal into their support. No ground truth is involved.

Two warnings say when the labels are noise: more than 20% of the
critic-positive frames with an empty mask, and a LayerCAM ``deletion_drop``
(train/critic.py::critic_cam_health) under its gate.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.device import resolve_device
from critic_vae_tpu_torch.models.critic import Critic

# the JAX package's LayerCAM measurements: thr-IoU peaks at threshold 90, and
# the CAM-tuned CRF tuple (w1, alpha, beta, w2, gamma, iters)
DEFAULT_CAM_THRESHOLD = 90
CAM_TUNED_CRF_PARAMS: Tuple[float, float, float, float, float, float] = (
    132.0, 32.0, 3.1, 8.0, 1.8, 10,
)


def build_pseudo_masks(critic: Critic, frames: np.ndarray, *,
                       threshold: int = DEFAULT_CAM_THRESHOLD, cam_block: int = 1,
                       run_crf: bool = True, crf_params: Tuple = CAM_TUNED_CRF_PARAMS,
                       crf_backend: str = "auto", batch_size: int = 512,
                       device="cuda", mesh=None) -> np.ndarray:
    """(N, H, W) bool LayerCAM (+ CAM-tuned CRF) masks of (N, H, W, 3)
    frames, uint8 or float in [0, 1], computed on ``device`` (the card unless
    the caller asks for the CPU). ``run_crf=False`` returns the thresholded
    LayerCAM masks; ``crf_backend`` resolves as crf/policy.py says. With a
    ``mesh`` (parallel/mesh.py) the saliency stage and the device CRF run
    over its ranks, each on its rows, and every rank returns every mask."""
    from critic_vae_tpu_torch.crf.policy import resolve_crf_backend
    from critic_vae_tpu_torch.ops.mask import normalize_diffs_given_mean
    from critic_vae_tpu_torch.pipelines.video import _refine, episode_device_stage
    from critic_vae_tpu_torch.train.critic import (CAM_HEALTH_MIN_DELETION_DROP,
                                                   critic_cam_health)

    device = resolve_device(device)
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames_u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    else:
        frames_u8 = frames
    critic = critic.to(device)
    frames_dev = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(device)
    # the saliency source never decodes: no VAE
    preds, maxes, diff_chunks, valids, _ = episode_device_stage(
        None, critic, frames_dev, batch_size, with_recons=False, mask_source="saliency",
        saliency_opts={"method": "layercam", "cam_block": cam_block}, mesh=mesh)
    mean_max = float(np.mean(maxes.cpu().numpy()))
    thr_masks = torch.cat([normalize_diffs_given_mean(chunk, mean_max)[:valid] > threshold
                           for chunk, valid in zip(diff_chunks, valids)])
    thr_host = thr_masks.cpu().numpy()
    # no ground truth exists in real use: frames the critic scores positive
    # should have non-empty CAM support, and erasing it should gut the score
    positive = preds.cpu().numpy()[:len(thr_host)] > 0.5
    warn_reasons = []
    if positive.any():
        empty_rate = float((~thr_host[positive].any(axis=(1, 2))).mean())
        if empty_rate > 0.2:
            warn_reasons.append(
                f"{empty_rate:.0%} of critic-positive frames have EMPTY "
                f"pseudo-masks")
    health = critic_cam_health(critic, frames_u8, cam_block=cam_block, threshold=threshold,
                               device=device)
    if health["deletion_drop"] < CAM_HEALTH_MIN_DELETION_DROP:
        warn_reasons.append(
            f"CAM deletion_drop {health['deletion_drop']:.3f} < "
            f"{CAM_HEALTH_MIN_DELETION_DROP}")
    if warn_reasons:
        warnings.warn(
            "build_pseudo_masks: " + "; ".join(warn_reasons) + " — the "
            "critic's LayerCAM localization looks DEGENERATE (a no-GT "
            "instance property accuracy does not reveal; docs/RESULTS.md "
            "round 5). Distilling from these labels tests nothing: "
            "retrain the critic with soft trunk-area labels "
            "(train/critic.py::soft_trunk_labels, `traincritic --labels "
            "soft`) or another seed until critic_cam_health passes.",
            stacklevel=2,
        )
    if not run_crf:
        return thr_host
    backend = resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                                  device=device)
    if backend == "device":
        return _refine(frames_dev, thr_masks, tuple(crf_params), backend,
                       mesh=mesh).cpu().numpy()
    return np.asarray(_refine(frames_u8, thr_host, tuple(crf_params), backend)).astype(bool)
