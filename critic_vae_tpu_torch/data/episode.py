"""Episode data source: the X.npy / Y.npy minerl-episode format.

Reference behavior (vae_utility.py:70-82): load ``X.npy`` (RGB uint8 frames)
and ``Y.npy`` (per-pixel RGB ground-truth), reduce the GT to a boolean mask
with ``np.all(..., axis=-1)``, and slice ``[100:5000:2]`` — yielding 550
frames from the 1200-frame bundled episode.

Copied into the port (numpy only) because importing it from
critic_vae_tpu runs that package's ``__init__``, which imports jax;
tests/test_torch_data.py pins the copy to the original bit for bit.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

DEFAULT_SLICE = (100, 5000, 2)  # vae_utility.py:75-77


def load_episode(
    episode_dir: str,
    episode_slice: Tuple[int, int, int] | None = DEFAULT_SLICE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load an episode directory containing X.npy and (optionally) Y.npy.

    Returns:
      frames: (N, 64, 64, 3) uint8 RGB (raw, NOT normalized — the reference
        feeds raw uint8 frames to the CRF and normalized copies to the nets).
      gt: (N, 64, 64) bool tree-trunk masks, or None when the episode ships
        no Y.npy (unlabeled footage — beyond the reference, which assumes
        ground truth exists, vae_utility.py:70-82; the pipeline then skips
        IoU scoring and bin diagnostics).
    """
    frames = np.load(os.path.join(episode_dir, "X.npy"))
    y_path = os.path.join(episode_dir, "Y.npy")
    gt = np.all(np.load(y_path), axis=-1) if os.path.exists(y_path) else None
    if episode_slice is not None:
        s = slice(*episode_slice)
        frames = frames[s]
        gt = gt[s] if gt is not None else None
    return (
        np.ascontiguousarray(frames),
        np.ascontiguousarray(gt) if gt is not None else None,
    )


def normalize_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 HWC frames → float32 in [0,1] (reference adjust_values,
    vae_utility.py:324-328). Stays NHWC — no CHW transpose on TPU."""
    return frames.astype(np.float32) / 255.0
