"""Class-balanced critic-binned frame sampling (counterpart of
critic_vae_tpu/data/sampler.py; reference: vae_utility.py:393-462).

Trajectories stream in; each frame's critic score picks its bin, high
(pred >= 0.7), mid (0.4 <= pred <= 0.6) or low (pred <= 0.25), and at most
150 frames a trajectory enter each bin; frames in (0.25, 0.4) or (0.6, 0.7)
are dropped; a trajectory ends early once all three bins are full; the
collection stops at ``total_images`` frames, checked at trajectory
boundaries (so the total can overshoot, as the reference's does).

Each trajectory is scored on the card in chunks (:func:`score_frames`);
the bin bookkeeping is the host's sequential chain (:func:`select_balanced`,
the reference's if/elif order). The JAX package pads ragged chunks to two
bucket shapes to bound XLA compiles; PyTorch compiles nothing, so the port
scores chunks as they come, with the same scores.

With ``recon_fn`` (the ``dataset`` command, pipelines/dataset.py) the set
holds reconstructions instead: recon@pred of the high-bin frames, recon@0
of the low-bin ones, both of the mid-bin ones (reference:
vae_utility.py:431-443).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.device import no_tf32, resolve_device
from critic_vae_tpu_torch.models.critic import Critic

BinThresholds = Tuple[float, float, float, float]  # (low_max, mid_lo, mid_hi, high_min)
DEFAULT_THRESHOLDS: BinThresholds = (0.25, 0.4, 0.6, 0.7)


def score_frames(critic: Critic, frames: np.ndarray, batch_size: int = 1024) -> np.ndarray:
    """Critic scores (N,) float32 of (N, H, W, 3) float frames in [0, 1],
    ``batch_size`` at a time on the critic's device, in float32 with TF32
    off."""
    device = next(critic.parameters()).device
    if len(frames) == 0:
        return np.zeros((0,), np.float32)
    out = []
    with torch.inference_mode(), no_tf32():
        for i in range(0, len(frames), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(frames[i:i + batch_size], np.float32))
            x = x.to(device).permute(0, 3, 1, 2).contiguous()
            out.append(critic(x)[:, 0])
        return torch.cat(out).cpu().numpy()


def select_balanced(preds: np.ndarray, collect: int = 150,
                    thresholds: BinThresholds = DEFAULT_THRESHOLDS
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential bin selection over one trajectory's scores: (selected
    indices, bins) with bins 0 low, 1 mid, 2 high; the reference's per-frame
    if/elif chain and early break (vae_utility.py:431-457)."""
    low_max, mid_lo, mid_hi, high_min = thresholds
    c_low = c_mid = c_high = 0
    idx: List[int] = []
    bins: List[int] = []
    for i, pred in enumerate(preds):
        if c_high >= collect and c_low >= collect and c_mid >= collect:
            break
        if mid_lo <= pred <= mid_hi and c_mid < collect:
            idx.append(i)
            bins.append(1)
            c_mid += 1
        elif pred >= high_min and c_high < collect:
            idx.append(i)
            bins.append(2)
            c_high += 1
        elif pred <= low_max and c_low < collect:
            idx.append(i)
            bins.append(0)
            c_low += 1
    return np.asarray(idx, np.int64), np.asarray(bins, np.int64)


def balanced_critic_sampler(trajectories: Iterable[Tuple[str, np.ndarray]], critic: Critic, *,
                            total_images: int = 50_000, collect: int = 150,
                            thresholds: BinThresholds = DEFAULT_THRESHOLDS,
                            batch_size: int = 1024, device="cuda",
                            recon_fn: Optional[Callable[[np.ndarray, np.ndarray],
                                                        Tuple[np.ndarray, np.ndarray]]] = None,
                            progress: Optional[Callable[[int], None]] = None) -> np.ndarray:
    """A balanced training set, (N, H, W, 3) float32, from (name, frames)
    trajectories (frames (T, H, W, 3) float32 in [0, 1]), the critic moved
    to ``device`` (the card unless the caller asks for the CPU).
    ``recon_fn(frames, preds) -> (recon_at_pred, recon_at_zero)`` builds the
    reconstruction set instead (module doc)."""
    critic = critic.to(resolve_device(device))
    out: List[np.ndarray] = []
    n = 0
    for _name, frames in trajectories:
        if n >= total_images:
            break
        preds = score_frames(critic, frames, batch_size)
        idx, bins = select_balanced(preds, collect, thresholds)
        if len(idx) == 0:
            continue
        if recon_fn is None:
            out.append(frames[idx])
            n += len(idx)
        else:
            recon_pred, recon_zero = recon_fn(frames[idx], preds[idx])
            take_pred = bins >= 1  # mid + high
            take_zero = bins <= 1  # low + mid
            out.append(np.asarray(recon_pred)[take_pred])
            out.append(np.asarray(recon_zero)[take_zero])
            n += int(take_pred.sum()) + int(take_zero.sum())
        if progress is not None:
            progress(n)
    if not out:
        return np.zeros((0, 64, 64, 3), np.float32)
    return np.concatenate(out, axis=0)
