"""Critic training (counterpart of critic_vae_tpu/train/critic.py): binary
tree-trunk classifiers trained with BCE on frame-level labels, so the stack
can be built from labelled episodes without a pretrained critic.

One step: the batch (uint8 normalised on the device), the critic's
train-mode forward with dropout (models/critic.py), BCE on the logits as
``optax.sigmoid_binary_cross_entropy`` computes it (``-y·log σ(z) -
(1-y)·log σ(-z)``), the mean, the gradients, and Adam as ``optax.adam(lr)``
(b1 0.9, b2 0.999, eps 1e-8; torch's fused Adam). The multi-step loop
gathers each batch on the device from a device-resident dataset by a row of
a (K, B) index tensor; the epoch's order is
``np.random.default_rng(seed).permutation``, the JAX package's bit for bit.

The JAX package draws the initial weights and the dropout masks from
threefry, which torch cannot reproduce: ``train_critic`` starts from
``io/weights.py::numpy_critic_params(seed)`` (``initial_params`` takes any
other) and draws dropout from a ``torch.Generator`` seeded ``seed + 1``;
the step takes the JAX package's masks (``dropout_masks``) for parity.

:func:`critic_cam_health` is the no-ground-truth LayerCAM health report
(ops/saliency.py), :func:`train_critic_selected` the best-of-N recipe by it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.optim.adam import adam

from critic_vae_tpu_torch.device import no_tf32, resolve_device
from critic_vae_tpu_torch.io.weights import (critic_from_params, critic_to_params,
                                             numpy_critic_params)
from critic_vae_tpu_torch.models.critic import Critic

ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)  # optax.adam's defaults

# Gate for critic_cam_health's deletion_drop: the JAX package measured
# healthy critics at ~0.42 and degenerate ones at ~0.08; 0.25 splits the gap.
CAM_HEALTH_MIN_DELETION_DROP = 0.25
# The strict gate of CAM-grade critics, a retry target
# (train_critic_selected(health_target=...), traincritic --cam-health-target).
CAM_HEALTH_TARGET_STRICT = 0.65


def labels_from_masks(gt: np.ndarray, min_pixels: int = 1) -> np.ndarray:
    """Frame-level trunk-visibility labels from per-pixel GT masks."""
    return (gt.reshape(len(gt), -1).sum(axis=1) >= min_pixels).astype(np.float32)


def soft_trunk_labels(gt: np.ndarray, percentile: float = 90.0) -> np.ndarray:
    """Soft trunk-area labels: each frame's trunk pixel count over the
    ``percentile``-th positive frame's, clipped to [0, 1] (the JAX
    package's CAM-robust recipe)."""
    counts = np.asarray(gt).reshape(len(gt), -1).sum(axis=1).astype(np.float32)
    pos = counts[counts > 0]
    scale = float(np.percentile(pos, percentile)) if len(pos) else 1.0
    return np.clip(counts / max(scale, 1.0), 0.0, 1.0)


@dataclasses.dataclass
class CriticTrainState:
    """The critic being trained, Adam's moments and counts (one a parameter,
    in ``critic.parameters()`` order) and the dropout generator."""

    critic: Critic
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    counts: List[torch.Tensor]
    generator: torch.Generator

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.critic.parameters())


def init_critic_state(params: Dict[str, np.ndarray], *, device, seed: int = 0
                      ) -> CriticTrainState:
    """A fresh state from JAX-layout numpy critic ``params`` on ``device``,
    the dropout generator seeded ``seed``."""
    device = torch.device(device)
    critic = critic_from_params(params).to(device).requires_grad_(True)
    ps = list(critic.parameters())
    return CriticTrainState(
        critic=critic, mu=[torch.zeros_like(p) for p in ps], nu=[torch.zeros_like(p) for p in ps],
        counts=[torch.zeros((), dtype=torch.float32, device=device) for _ in ps],
        generator=torch.Generator(device=device).manual_seed(seed))


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: -y·log σ(z) - (1-y)·log σ(-z)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def make_critic_step(*, learning_rate: float = 1e-3, dropout_rate: float = 0.3):
    """``step(state, batch, labels, dropout_masks=None) -> loss``: one step
    on ``batch`` (B, H, W, 3), uint8 or float in [0, 1], and (B,) float
    labels, updating ``state`` in place; the loss a float32 device scalar.
    ``dropout_masks`` (three bool tensors, NCHW) replace the generator's
    draws."""

    def step(state: CriticTrainState, batch: torch.Tensor, labels: torch.Tensor,
             dropout_masks=None) -> torch.Tensor:
        if batch.dtype == torch.uint8:
            batch = batch.float() / 255.0
        x = batch.float().permute(0, 3, 1, 2).contiguous()
        logits = state.critic(x, return_logits=True, dropout_rate=dropout_rate,
                              generator=state.generator, dropout_masks=dropout_masks)[:, 0]
        loss = torch.mean(sigmoid_bce(logits, labels.float()))
        params = state.params
        grads = [g.contiguous() for g in torch.autograd.grad(loss, params)]
        with torch.no_grad():
            adam(params, grads, state.mu, state.nu, [], state.counts, fused=True,
                 amsgrad=False, lr=learning_rate, weight_decay=0.0, maximize=False, **ADAM)
        return loss.detach()

    return step


def make_critic_multi_step(**options):
    """``multi_step(state, dataset, labels, idx, dropout_masks=None) ->
    losses``: K steps of :func:`make_critic_step` (``options`` are its) over
    a device-resident ``dataset`` (N, H, W, 3) and ``labels`` (N,), each
    batch gathered on the device by a row of the int (K, B) ``idx``; the
    losses stacked to (K,) on the device. ``dropout_masks``: one step's
    masks a step."""
    step = make_critic_step(**options)

    def multi_step(state, dataset, labels, idx, dropout_masks=None):
        return torch.stack([
            step(state, dataset.index_select(0, idx[k]), labels.index_select(0, idx[k]),
                 None if dropout_masks is None else dropout_masks[k])
            for k in range(idx.shape[0])])

    return multi_step


def train_critic(frames: np.ndarray, labels: np.ndarray, *, epochs: int = 15,
                 batch_size: int = 128, learning_rate: float = 1e-3, dropout_rate: float = 0.3,
                 seed: int = 0, progress: Optional[bool] = True,
                 initial_params: Optional[Dict[str, np.ndarray]] = None, device="cuda"
                 ) -> Tuple[Dict[str, np.ndarray], float]:
    """Train a critic on (N, 64, 64, 3) frames, uint8 or float in [0, 1],
    and (N,) labels in [0, 1], on ``device`` (the card unless the caller asks
    for the CPU), float32 with TF32 off. Starts from ``initial_params``
    (default ``numpy_critic_params(seed)``). Returns (JAX-layout numpy
    params, the last step's loss)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = frames.astype(np.float32)
    labels = np.asarray(labels, np.float32)
    n = len(frames)
    steps_per_epoch = n // batch_size
    if steps_per_epoch == 0:
        raise ValueError(f"{n} frames < one batch ({batch_size})")
    device = resolve_device(device)
    params = numpy_critic_params(seed) if initial_params is None else initial_params
    state = init_critic_state(params, device=device, seed=seed + 1)
    multi_step = make_critic_multi_step(learning_rate=learning_rate, dropout_rate=dropout_rate)
    dataset_dev = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    labels_dev = torch.from_numpy(labels).to(device)
    shuffle = np.random.default_rng(seed)
    loss = float("nan")
    with no_tf32():
        for ep in range(epochs):
            order = shuffle.permutation(n)[: steps_per_epoch * batch_size]
            idx = torch.from_numpy(order.reshape(steps_per_epoch, batch_size).astype(np.int32))
            losses = multi_step(state, dataset_dev, labels_dev, idx.to(device))
            loss = float(losses[-1].item())
            if progress:
                print(f"    critic ep:{ep} loss:{loss:.4f}", end="\r")
    if progress:
        print()
    return critic_to_params(state.critic), loss


def _as_critic(critic, device) -> Critic:
    """A Critic module on ``device`` from a module or JAX-layout params."""
    if not isinstance(critic, Critic):
        critic = critic_from_params(critic)
    return critic.to(device)


def critic_accuracy(critic, frames: np.ndarray, labels: np.ndarray, batch_size: int = 1024,
                    device="cuda") -> float:
    """Eval-mode binary accuracy at threshold 0.5 of a critic (module or
    JAX-layout params)."""
    from critic_vae_tpu_torch.data.sampler import score_frames

    f = frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8 else frames
    preds = score_frames(_as_critic(critic, resolve_device(device)), f, batch_size)
    return float(((preds > 0.5) == (np.asarray(labels) > 0.5)).mean())


def critic_cam_health(critic, frames: np.ndarray, *, cam_block: int = 1, threshold: int = 90,
                      batch_size: int = 256, max_frames: int = 512, device="cuda") -> dict:
    """No-ground-truth LayerCAM health of a critic (module or JAX-layout
    params), as the JAX package's ``critic_cam_health``: on the first
    ``max_frames`` frames, ``positive_fraction`` (preds > 0.5), ``n_frames``,
    ``empty_rate`` (critic-positive frames whose thresholded CAM is empty),
    ``deletion_drop`` (the mean drop of their prediction when the CAM's
    support is erased with the frame's mean colour) and ``cam_top5_mass``
    (the share of CAM mass in the top 5% of pixels). Python floats."""
    from critic_vae_tpu_torch.data.sampler import score_frames
    from critic_vae_tpu_torch.ops.mask import normalize_diffs_given_mean
    from critic_vae_tpu_torch.ops.saliency import critic_saliency

    device = resolve_device(device)
    critic = _as_critic(critic, device)
    frames = np.asarray(frames)[:max_frames]
    f32 = (frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8
           else frames.astype(np.float32))
    preds_l, maps_l = [], []
    for i in range(0, len(f32), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(f32[i:i + batch_size])).to(device)
        p, m = critic_saliency(critic, x.permute(0, 3, 1, 2), method="layercam",
                               cam_block=cam_block)
        preds_l.append(p.cpu().numpy())
        maps_l.append(m.cpu().numpy())
    preds = np.concatenate(preds_l)
    maps = np.concatenate(maps_l)

    mean_max = float(np.mean(maps.max(axis=(1, 2))))
    if mean_max == 0.0:
        u8 = np.zeros(maps.shape, np.uint8)
    else:
        u8 = normalize_diffs_given_mean(torch.from_numpy(maps), np.float32(mean_max)).numpy()
    masks = u8 > threshold
    pos = preds > 0.5

    out = {"positive_fraction": float(pos.mean()), "n_frames": int(len(frames))}
    if not pos.any():
        out.update(empty_rate=1.0, deletion_drop=0.0, cam_top5_mass=1.0)
        return out
    out["empty_rate"] = float((~masks[pos].any(axis=(1, 2))).mean())

    fill = f32.mean(axis=(1, 2), keepdims=True)
    erased = np.where(masks[..., None], fill, f32)
    p_del = score_frames(critic, erased, batch_size)
    out["deletion_drop"] = float((preds[pos] - p_del[pos]).mean())

    flat = maps.reshape(len(maps), -1)
    k = max(1, flat.shape[1] // 20)
    top = np.partition(flat, -k, axis=1)[:, -k:].sum(axis=1)
    tot = np.maximum(flat.sum(axis=1), 1e-9)
    out["cam_top5_mass"] = float((top[pos] / tot[pos]).mean())
    return out


def train_critic_selected(frames: np.ndarray, labels: np.ndarray, *, candidates: int = 4,
                          base_seed: int = 0, health_frames: Optional[np.ndarray] = None,
                          health_target: Optional[float] = None,
                          progress: Optional[bool] = True, device="cuda", **train_kw
                          ) -> Tuple[Dict[str, np.ndarray], dict, list]:
    """Train up to ``candidates`` critics (seeds ``base_seed..``) and keep the
    one with the largest ``deletion_drop`` (:func:`critic_cam_health` on
    ``health_frames``, default ``frames``). With ``health_target`` the first
    candidate reaching it is kept at once, and ``health_target_met`` says
    whether one did. Returns ``(params, health + selected_seed, per-seed
    reports)``, as the JAX package's ``train_critic_selected``."""
    if candidates < 1:
        raise ValueError(f"candidates must be >= 1, got {candidates}")
    hf = frames if health_frames is None else health_frames
    best = None
    reports = []
    for c in range(candidates):
        seed = base_seed + c
        params, loss = train_critic(frames, labels, seed=seed, progress=progress,
                                    device=device, **train_kw)
        health = critic_cam_health(params, hf, device=device)
        reports.append({"seed": seed, "final_loss": float(loss), **health})
        if progress:
            print(f"    candidate seed {seed}: deletion_drop={health['deletion_drop']:.3f}")
        if best is None or health["deletion_drop"] > best[1]["deletion_drop"]:
            best = (params, health, seed)
        if health_target is not None and health["deletion_drop"] >= health_target:
            best = (params, health, seed)
            break
    out_health = {**best[1], "selected_seed": best[2]}
    if health_target is not None:
        out_health["health_target_met"] = best[1]["deletion_drop"] >= health_target
    return best[0], out_health, reports
