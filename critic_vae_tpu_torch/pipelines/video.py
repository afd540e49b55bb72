"""Video / mask-evaluation pipeline (counterpart of
critic_vae_tpu/pipelines/video.py ``episode_device_stage``, ``eval_episode``
and ``threshold_sweep``, device-CRF path, no reconstructions).

Per frame: critic score, encode, double decode, diff/grey/max (kernel B1),
then the global mean-max normalisation to uint8, the threshold, the exact
device CRF (kernel B2 plus the mean-field, or the ``int8``/``vmem`` builds)
and whole-stack IoU. ``eval_episode`` keeps everything up to the masks on
the device and scores on the host; ``threshold_sweep`` runs the device
stage once and scores every threshold on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops.iou import iou
from critic_vae_tpu_torch.ops.mask import (
    episode_forward,
    normalize_diffs_given_mean,
    threshold_masks,
)

# the reference's -thresh sweep (vae.py:121-123): 0..120 step 10
DEFAULT_SWEEP = tuple(range(0, 130, 10))


def _normalize_threshold_chunk(diff: torch.Tensor, mean_max: torch.Tensor,
                               thresholds: torch.Tensor):
    """One chunk's mean-max normalisation to uint8 and its (T, B, H, W)
    masks for all thresholds at once."""
    u8 = normalize_diffs_given_mean(diff, mean_max)
    return u8, threshold_masks(u8, thresholds)


def _sweep_chunk_stats(masks: torch.Tensor, gt: torch.Tensor):
    """(tp, fn, fp) int64 counts per threshold of (T, B, H, W) masks
    against (B, H, W) ground truth, on the masks' device."""
    g = gt[None].bool()
    m = masks.bool()
    return (torch.sum(g & m, dim=(1, 2, 3)), torch.sum(g & ~m, dim=(1, 2, 3)),
            torch.sum(~g & m, dim=(1, 2, 3)))


@dataclasses.dataclass
class EpisodeResult:
    preds: np.ndarray                 # (N,)
    diff_u8: np.ndarray               # (N, H, W) uint8 normalized diff maps
    thr_masks: np.ndarray             # (N, H, W) bool
    crf_masks: Optional[np.ndarray]   # (N, H, W) bool, or None without CRF
    thr_iou: Optional[float]
    crf_iou: Optional[float]


def episode_device_stage(vae: VAE, critic: Critic, frames_u8: torch.Tensor,
                         batch_size: int = 512, *, compute_dtype: str = "float32"):
    """Run :func:`episode_forward` over device-resident uint8 frames (N, H,
    W, 3) in chunks of ``batch_size``, the last padded by repeating its last
    frame, so every chunk has one shape.

    Returns (preds (N,), max_value (N,), diff_chunks, valids): the trimmed
    per-frame outputs, the per-chunk diff maps as they came (still padded)
    and each chunk's count of valid frames — all on the device."""
    n = frames_u8.shape[0]
    preds, maxes, diff_chunks, valids = [], [], [], []
    for i in range(0, n, batch_size):
        chunk = frames_u8[i : i + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            pad = chunk[-1:].expand(batch_size - valid, -1, -1, -1)
            chunk = torch.cat([chunk, pad])
        out = episode_forward(vae, critic, chunk, compute_dtype=compute_dtype)
        preds.append(out["preds"][:valid])
        maxes.append(out["max_value"][:valid])
        diff_chunks.append(out["diff"])
        valids.append(valid)
    return torch.cat(preds), torch.cat(maxes), diff_chunks, valids


def eval_episode(vae: VAE, critic: Critic, frames_u8: np.ndarray,
                 gt: Optional[np.ndarray], *, device: torch.device,
                 threshold: int = 50, crf_params: Tuple = REFERENCE_CRF_PARAMS,
                 run_crf: bool = True, batch_size: int = 512,
                 compute_dtype: str = "float32", crf_backend: str = "auto") -> EpisodeResult:
    """The mask pipeline over an episode (reference: eval_textured_frames).

    Args:
      frames_u8: (N, H, W, 3) uint8 raw frames; they go to ``device`` once
        and feed both the nets (normalised there) and the CRF (raw).
      gt: (N, H, W) bool ground truth, or None to skip IoU scoring.
      crf_backend: "auto" or "device" (crf/policy.py). The device CRF's
        build is ``auto`` unless ``CRITIC_VAE_TPU_CRF_BUILD`` names another
        (crf/device.py::_resolve_build), as in the JAX package.
    """
    if run_crf:
        from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

        resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                            device=device)
    frames = torch.from_numpy(np.ascontiguousarray(frames_u8, dtype=np.uint8)).to(device)
    preds, max_value, diff_chunks, valids = episode_device_stage(
        vae, critic, frames, batch_size, compute_dtype=compute_dtype,
    )
    # global two-pass normalisation: the mean of the trimmed per-frame maxima
    mean_max = torch.mean(max_value)
    t = torch.tensor([threshold], dtype=torch.int32, device=device)
    u8_parts, thr_parts = [], []
    for diff, valid in zip(diff_chunks, valids):
        u8 = normalize_diffs_given_mean(diff, mean_max)[:valid]
        u8_parts.append(u8)
        thr_parts.append(threshold_masks(u8, t)[0])
    diff_u8 = torch.cat(u8_parts)
    thr = torch.cat(thr_parts)

    crf = None
    if run_crf:
        from critic_vae_tpu_torch.crf.device import refine_masks_device

        crf = refine_masks_device(frames, thr, crf_params, fetch=False)

    thr_masks = thr.cpu().numpy()
    crf_masks = crf.cpu().numpy() if crf is not None else None
    return EpisodeResult(
        preds=preds.cpu().numpy(),
        diff_u8=diff_u8.cpu().numpy(),
        thr_masks=thr_masks,
        crf_masks=crf_masks,
        thr_iou=iou(gt, thr_masks) if gt is not None else None,
        crf_iou=iou(gt, crf_masks) if gt is not None and crf_masks is not None else None,
    )


def threshold_sweep(vae: VAE, critic: Critic, frames_u8: np.ndarray, gt: np.ndarray,
                    thresholds: Sequence[int] = DEFAULT_SWEEP, *, device: torch.device,
                    crf_params: Tuple = REFERENCE_CRF_PARAMS, run_crf: bool = True,
                    batch_size: int = 512, compute_dtype: str = "float32",
                    crf_backend: str = "auto") -> List[Dict]:
    """Threshold sweep with the device stage run once (reference: -video
    -thresh, which re-runs the whole pipeline per threshold).

    All T threshold masks and their whole-stack IoUs come from one
    vectorised pass on the device; the device CRF refines the T mask sets
    together (crf/device.py::refine_masks_multi_device) and its IoUs are
    counted on the device too. Returns one dict per threshold:
    ``threshold``, ``thr_iou`` (3 digits) and ``crf_iou`` (3 digits, None
    without ``run_crf``). Arguments as in :func:`eval_episode`; ``gt`` is
    required.
    """
    if run_crf:
        from critic_vae_tpu_torch.crf.policy import resolve_crf_backend

        resolve_crf_backend(crf_backend, frames_u8.shape[1], frames_u8.shape[2],
                            device=device)
    frames = torch.from_numpy(np.ascontiguousarray(frames_u8, dtype=np.uint8)).to(device)
    gt_dev = torch.from_numpy(np.ascontiguousarray(gt, dtype=bool)).to(device)
    _, max_value, diff_chunks, valids = episode_device_stage(
        vae, critic, frames, batch_size, compute_dtype=compute_dtype,
    )
    mean_max = torch.mean(max_value)
    t = torch.tensor(list(thresholds), dtype=torch.int32, device=device)
    counts = torch.zeros((3, len(t)), dtype=torch.int64, device=device)
    mask_parts = []
    offset = 0
    for diff, valid in zip(diff_chunks, valids):
        masks = _normalize_threshold_chunk(diff, mean_max, t)[1][:, :valid]
        counts += torch.stack(_sweep_chunk_stats(masks, gt_dev[offset : offset + valid]))
        if run_crf:
            mask_parts.append(masks)
        offset += valid
    thr_ious = _ious(counts)

    crf_ious = [None] * len(t)
    if run_crf:
        from critic_vae_tpu_torch.crf.device import refine_masks_multi_device

        refined = refine_masks_multi_device(frames, torch.cat(mask_parts, dim=1), crf_params,
                                            fetch=False)
        crf_ious = [round(v, 3) for v in _ious(torch.stack(_sweep_chunk_stats(refined, gt_dev)))]
    return [{"threshold": int(th), "thr_iou": round(thr_ious[i], 3), "crf_iou": crf_ious[i]}
            for i, th in enumerate(thresholds)]


def _ious(counts: torch.Tensor) -> List[float]:
    """(3, T) (tp, fn, fp) counts -> T IoUs with ops/iou.py semantics:
    Python-int counts, float64 division, 0/0 -> 1."""
    tp, fn, fp = counts.cpu().tolist()
    return [1.0 if a + b + c == 0 else a / (a + b + c) for a, b, c in zip(tp, fn, fp)]
