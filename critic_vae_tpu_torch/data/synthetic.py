"""Synthetic minerl-episode generator (X.npy / Y.npy format).

The bundled episode blobs are absent from the reference mount
(``.MISSING_LARGE_BLOBS``), so CI and benchmarks need a generator that emits
episodes in the exact on-disk format the video pipeline consumes
(vae_utility.py:70-82): ``X.npy`` uint8 RGB frames and ``Y.npy`` uint8 RGB
ground truth whose all-channels-true pixels mark the tree trunk.

Scenes are Minecraft-like: sky/grass split plus vertical brown "trunks" with
leaf blobs, random camera jitter frame to frame; roughly half the frames
contain a trunk so critic-bin logic gets both classes.

Copied into the port (numpy only) because importing it from
critic_vae_tpu runs that package's ``__init__``, which imports jax;
tests/test_torch_data.py pins the copy to the original bit for bit.
"""

from __future__ import annotations

import os

import numpy as np


def generate_frames(
    num_frames: int = 64,
    size: int = 64,
    seed: int = 0,
    trunk_fraction: float = 0.55,
):
    """Returns (frames uint8 (N,S,S,3), gt bool (N,S,S))."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((num_frames, size, size, 3), np.uint8)
    gt = np.zeros((num_frames, size, size), bool)

    sky = np.array([120, 167, 255], np.uint8)
    grass = np.array([96, 140, 56], np.uint8)
    trunk = np.array([103, 82, 49], np.uint8)
    leaves = np.array([45, 90, 30], np.uint8)

    for i in range(num_frames):
        # clamp: rng.integers(2, horizon) below needs horizon > 2, which the
        # jitter can violate for small `size`
        horizon = max(3, size // 2 + rng.integers(-6, 7))
        img = np.empty((size, size, 3), np.uint8)
        img[:horizon] = sky
        img[horizon:] = grass
        img = (img.astype(np.int16) + rng.integers(-10, 11, img.shape)).clip(0, 255)

        if rng.random() < trunk_fraction:
            n_trunks = rng.integers(1, 3)
            for _ in range(n_trunks):
                cx = int(rng.integers(6, size - 6))
                half_w = int(rng.integers(2, 5))
                top = int(rng.integers(2, horizon))
                x0, x1 = max(cx - half_w, 0), min(cx + half_w, size)
                img[top:, x0:x1] = trunk + rng.integers(-8, 9, 3)
                gt[i, top:, x0:x1] = True
                # leaf canopy above/around the trunk (not ground truth)
                ly0 = max(top - 10, 0)
                lx0, lx1 = max(x0 - 6, 0), min(x1 + 6, size)
                canopy = rng.random((max(top - ly0, 1), lx1 - lx0)) < 0.7
                region = img[ly0:top, lx0:lx1]
                region[canopy[: region.shape[0]]] = leaves

        frames[i] = img.clip(0, 255).astype(np.uint8)
    return frames, gt


def generate_episode(
    out_dir: str, num_frames: int = 64, size: int = 64, seed: int = 0
) -> None:
    """Write X.npy / Y.npy in the reference's on-disk episode format."""
    frames, gt = generate_frames(num_frames, size, seed)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "X.npy"), frames)
    # Y.npy is RGB; the loader reduces with np.all(..., -1) (vae_utility.py:73)
    y = np.where(gt[..., None], 255, 0).astype(np.uint8).repeat(3, axis=-1)
    np.save(os.path.join(out_dir, "Y.npy"), y)
