"""Image pre/post-processing helpers, NHWC (counterpart of
critic_vae_tpu/utils/image.py; reference: vae_utility.py:324-343, 382-390):
the [0, 1] normalisation and the uint8 quantisation, as thin names over
data/episode.py and viz/panels.py."""

from __future__ import annotations

import numpy as np


def adjust_values(obs) -> np.ndarray:
    """uint8 image(s) -> float32 in [0, 1] (reference: adjust_values,
    vae_utility.py:324-328)."""
    from critic_vae_tpu_torch.data.episode import normalize_frames

    return normalize_frames(np.asarray(obs))


def reverse_preprocess(recon) -> np.ndarray:
    """Float reconstruction(s) -> uint8 HWC for display (reference:
    reverse_preprocess, vae_utility.py:330-335)."""
    from critic_vae_tpu_torch.viz.panels import to_uint8_rgb

    return to_uint8_rgb(recon)


def to_np_image(x) -> np.ndarray:
    """A tensor or array -> host numpy (reference ``to_np``, vae_utility.py:382)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)
