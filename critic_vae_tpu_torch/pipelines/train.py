"""VAE training: epochs over a device-resident dataset, logging, and
checkpoint/resume (counterpart of critic_vae_tpu/pipelines/train.py).

Reference behaviour (vae.py:33-66): epochs over the frames, a fresh shuffle
each epoch, batch 128 with the tail batch dropped, Adam lr 5e-5, TensorBoard
scalars every 30 batches at step ``row·B + N·ep``, the weights saved at the
end.

The dataset goes to the card once (uint8 stays uint8, anything else
float32), and each dispatch runs a chunk of steps (train/step.py
``make_multi_step``) whose batches are gathered on the card; the host sends
a (K, B) int32 index tensor and reads the chunk's losses back once. A chunk
is an epoch, or ``checkpoint_every_steps`` steps when checkpoints are on.
The shuffle is ``np.random.default_rng(seed).permutation`` an epoch, so the
batch order is the JAX package's bit for bit, and a resume replays it.

Over the ranks of the process group (parallel/mesh.py: one rank a device,
every rank running this function with the same dataset and seed) the steps
are data-parallel (train/step.py); one process without a group runs no
collective. ``shard_dataset`` resolves the layout as
the JAX package does: ``"auto"`` shards the dataset when the ranks divide
both its frames and the batch (else the primary prints ``replicating``),
``True`` requires it and ``False`` replicates. Sharded, each rank holds
only its block of rows on its device and the shuffle is
``sharded_epoch_indices``, one permutation a shard, so the layout is part
of the resume meta. Only the primary (rank 0) writes checkpoints, events,
JSONL and progress lines; every rank restores from the checkpoints.

Checkpoints are ``ckpt-{step}.npz`` (train/step.py ``state_tree``, the
port's own layout) with a ``.meta.json`` beside each, the newest
``keep_checkpoints`` kept. :func:`save_final_weights` writes the JAX
package's artifact layout, which its ``load_final_weights`` and the port's
read. The initial weights are ``numpy_vae_params(seed)``, not the JAX
package's threefry draw, which torch cannot reproduce; ``initial_params``
takes any other.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from critic_vae_tpu_torch.device import no_tf32, resolve_device
from critic_vae_tpu_torch.io import checkpoint as ckpt_io
from critic_vae_tpu_torch.io.events import MetricLogger
from critic_vae_tpu_torch.io.weights import numpy_vae_params, vae_to_params
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.parallel.distributed import is_primary
from critic_vae_tpu_torch.parallel.mesh import make_mesh, row_slice
from critic_vae_tpu_torch.train.step import (TrainState, init_train_state, load_state_tree,
                                             make_multi_step,
                                             sharded_epoch_indices, state_tree)


def train(critic: Critic, dataset: np.ndarray, *, epochs: int = 7, batch_size: int = 128,
          learning_rate: float = 5e-5, kld_weight: float = 1e-3, faithful_msssim: bool = True,
          compute_dtype: str = "float32", seed: int = 0, log_every_batches: int = 30,
          log_dir: Optional[str] = None, checkpoint_dir: Optional[str] = None,
          checkpoint_every_steps: int = 500, keep_checkpoints: int = 3, resume: bool = True,
          initial_params=None, progress: bool = True, log_images: bool = False,
          value_consistency: float = 0.0, mask_distill: float = 0.0,
          pseudo_masks: Optional[np.ndarray] = None, film: bool = False,
          shard_dataset="auto", device="cuda") -> TrainState:
    """Train the VAE on (N, 64, 64, 3) frames, uint8 or float in [0, 1], on
    ``device`` (the card unless the caller asks for the CPU), float32
    convs and matmuls without TF32. ``initial_params``: a JAX-layout
    ``(params, bn_state)`` to start from (default ``numpy_vae_params(seed,
    film=film)``). ``mask_distill > 0`` needs ``pseudo_masks`` (N, H, W),
    row-aligned with the dataset (pipelines/distill.py), which go to the
    device as uint8 beside it. Trains over every rank of the process group;
    ``shard_dataset``: ``"auto"``, True or False, the dataset's layout over
    the ranks (the module's note). Returns the final :class:`TrainState`,
    equal on every rank."""
    dataset = np.asarray(dataset)
    if dataset.ndim != 4:
        raise ValueError(f"dataset must be (N, H, W, C), got {dataset.shape}")
    if mask_distill > 0.0:
        if pseudo_masks is None:
            raise ValueError("mask_distill > 0 requires pseudo_masks")
        pseudo_masks = np.asarray(pseudo_masks).astype(np.uint8)
        if pseudo_masks.shape != dataset.shape[:3]:
            raise ValueError(
                f"pseudo_masks {pseudo_masks.shape} must be row-aligned with "
                f"the dataset {dataset.shape[:3]}"
            )
    if dataset.dtype != np.uint8:
        dataset = dataset.astype(np.float32, copy=False)
    num_samples = len(dataset)
    steps_per_epoch = num_samples // batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset of {num_samples} frames is smaller than one batch ({batch_size})")
    device = resolve_device(device)
    mesh = make_mesh(0, device)
    primary = is_primary()
    shard_ds = False
    if mesh.size > 1 and shard_dataset:
        d = mesh.size
        if num_samples % d == 0 and batch_size % d == 0:
            shard_ds = True
        elif shard_dataset != "auto":
            raise ValueError(
                f"shard_dataset=True needs the dataset ({num_samples}) and "
                f"batch size ({batch_size}) divisible by the mesh size ({d})"
            )
        elif primary:
            print(f"dataset not shardable over {d} devices ({num_samples} % {d} or "
                  f"{batch_size} % {d} != 0); replicating")
    params, bn_state = (numpy_vae_params(seed, film=film) if initial_params is None
                        else initial_params)
    state = init_train_state(params, bn_state, device=device, seed=seed)
    meta = {"num_samples": num_samples, "batch_size": batch_size, "seed": seed, "film": film,
            "shard_dataset": shard_ds}

    start_step = 0
    if resume and checkpoint_dir:
        # every rank restores the same state (a filesystem the ranks share)
        latest = ckpt_io.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            _validate_resume_meta(latest[0], meta)
            load_state_tree(state, ckpt_io.load_pytree(latest[0], state_tree(state)))
            start_step = int(latest[1])
            if primary:
                print(f"resumed from {latest[0]} (step {start_step})")

    critic = critic.to(device)
    step_options = dict(learning_rate=learning_rate, kld_weight=kld_weight,
                        faithful_msssim=faithful_msssim, compute_dtype=compute_dtype,
                        value_consistency=value_consistency, mask_distill=mask_distill)
    rows = row_slice(mesh, num_samples) if shard_ds else slice(None)
    # sharded, only this rank's block of rows goes to its device
    dataset_dev = torch.from_numpy(dataset[rows]).to(device)
    if mask_distill > 0.0:
        pseudo_masks = pseudo_masks[rows]
    multi_step = make_multi_step(critic, mesh=mesh, **step_options)
    masks_dev = torch.from_numpy(pseudo_masks).to(device) if mask_distill > 0.0 else None
    logger = MetricLogger(log_dir) if log_dir and primary else None
    shuffle_rng = np.random.default_rng(seed)

    def draw_epoch_idx() -> np.ndarray:
        if shard_ds:
            return sharded_epoch_indices(shuffle_rng, num_samples, batch_size, mesh.size)
        order = shuffle_rng.permutation(num_samples)
        # drop the tail batch like the reference (vae.py:44-46)
        return order[:steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size).astype(np.int32)

    start_epoch, start_row = divmod(start_step, steps_per_epoch)
    for _ in range(start_epoch):  # replay the shuffle stream up to the resumed epoch
        draw_epoch_idx()
    dispatch = steps_per_epoch
    if checkpoint_dir and 0 < checkpoint_every_steps < steps_per_epoch:
        dispatch = checkpoint_every_steps

    t0 = time.time()
    last_metrics = None
    last_ckpt_step = start_step
    try:
        with no_tf32():
            for ep in range(start_epoch, epochs):
                idx_epoch = draw_epoch_idx()
                first_row = start_row if ep == start_epoch else 0
                rows = []
                row = first_row
                while row < steps_per_epoch:
                    idx_chunk = idx_epoch[row:row + dispatch]
                    losses = multi_step(state, dataset_dev, torch.from_numpy(idx_chunk).to(device),
                                        masks=masks_dev)
                    rows.append({k: v.cpu().numpy() for k, v in losses.items()})
                    row += len(idx_chunk)
                    cur_step = ep * steps_per_epoch + row
                    if checkpoint_dir and cur_step - last_ckpt_step >= checkpoint_every_steps:
                        if primary:
                            _save_ckpt(checkpoint_dir, state, keep_checkpoints, meta)
                        last_ckpt_step = cur_step
                host = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
                last_metrics = {k: float(v[-1]) for k, v in host.items()}
                if logger:
                    # the reference's cadence: every 30 batches at step
                    # batch_i + num_samples·ep (vae.py:60-64)
                    for r in range(0, steps_per_epoch, log_every_batches):
                        if r >= first_row:
                            logger.log({k: float(v[r - first_row]) for k, v in host.items()},
                                       r * batch_size + num_samples * ep)
                if log_images and logger:
                    _log_probe_images(logger, state, critic, dataset,
                                      step=num_samples * (ep + 1))
                if progress and primary:
                    imgs_done = num_samples * (ep + 1)
                    rate = (imgs_done - start_step * batch_size) / max(time.time() - t0, 1e-9)
                    print(f"    ep:{ep}, imgs:{imgs_done}, "
                          f"loss:{last_metrics['total_loss']:.4f}, {rate:.0f} img/s", end="\r")
        if progress and primary and last_metrics is not None:
            print()
    finally:
        if logger:
            logger.close()
    if checkpoint_dir and primary:
        _save_ckpt(checkpoint_dir, state, keep_checkpoints, meta)
    return state


def _log_probe_images(logger: MetricLogger, state: TrainState, critic: Critic,
                      dataset: np.ndarray, step: int) -> None:
    """Originals over their reconstructions (the mu-decode at the critic's
    score, eval-mode BatchNorm) of the first 4 frames, logged as the image
    ``recon_probe`` (the reference's image_summary is dead code,
    logger.py:17-28). The primary's alone: the state is equal on every rank
    and the forward runs no collective."""
    probe = dataset[:4]
    if probe.dtype == np.uint8:
        probe = probe.astype(np.float32) / 255.0
    device = state.step.device
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(probe)).to(device).permute(0, 3, 1, 2)
        recon = state.vae.evaluate(x, critic(x)[:, 0]).permute(0, 2, 3, 1).cpu().numpy()
    strip = np.concatenate([np.concatenate(list(probe), axis=1),
                            np.concatenate(list(recon), axis=1)], axis=0)
    logger.events.image("recon_probe", np.clip(strip, 0.0, 1.0), step=step)


def _meta_path(ckpt_path: str) -> str:
    return ckpt_path[:-len(".npz")] + ".meta.json"


def _save_ckpt(directory: str, state: TrainState, keep: int, meta: dict) -> None:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{ckpt_io.PREFIX}{int(state.step)}.npz")
    ckpt_io.save_pytree(path, state_tree(state))
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)
    ckpt_io.prune_checkpoints(directory, keep)
    if keep:  # drop the sidecars of pruned checkpoints
        for name in os.listdir(directory):
            if name.endswith(".meta.json") and not os.path.exists(
                    os.path.join(directory, name[:-len(".meta.json")] + ".npz")):
                os.unlink(os.path.join(directory, name))


def _validate_resume_meta(ckpt_path: str, ours: dict) -> None:
    """Refuse to resume when the shuffle replay would misalign: the epoch
    and its permutations are rebuilt from the step by num_samples //
    batch_size, the seed and the dataset's layout (one global permutation,
    or one a shard), and a FiLM flag changes the state's structure. A meta
    without ``shard_dataset`` (written before sharded training) was not
    sharded."""
    mpath = _meta_path(ckpt_path)
    if not os.path.exists(mpath):
        return
    with open(mpath) as f:
        meta = json.load(f)
    meta.setdefault("film", False)
    meta.setdefault("shard_dataset", False)
    mismatched = {k: (meta.get(k), ours[k]) for k in ours if meta.get(k) != ours[k]}
    if mismatched:
        raise ValueError(
            f"cannot resume from {ckpt_path}: run configuration changed "
            f"(checkpoint vs now): {mismatched}. The deterministic shuffle "
            "replay would misalign — pass resume=False (CLI: --no-resume) or "
            "restore the original dataset/batch size/seed.")


def save_final_weights(state: TrainState, encoder_path: str, decoder_path: str) -> None:
    """The encoder (``params`` + ``bn_state``) and the decoder (``params``)
    in separate files, the JAX package's artifact layout (reference:
    vae.py:162-163), which both packages' ``load_final_weights`` read."""
    params, bn = vae_to_params(state.vae)
    ckpt_io.save_pytree(encoder_path, {"params": params["encoder"], "bn_state": bn})
    ckpt_io.save_pytree(decoder_path, {"params": params["decoder"]})
