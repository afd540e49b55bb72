"""The reconstruction dataset and the second VAE's data (counterpart of
critic_vae_tpu/pipelines/dataset.py; reference: vae.py:130-153,
vae_utility.py:416-443).

``build_recon_dataset`` collects a balanced set with the critic
(data/sampler.py) and keeps VAE reconstructions instead of frames:
recon@pred for high-critic frames, recon@0 for low, both for mid. Each chunk
is one eval-mode encode at mu and one decode of [mu, mu] at [pred, 0] on the
device. The artifact is a compressed float32 ``.npz``; ``load_dataset`` also
reads a raw ``.npy`` (memory-mapped) and the reference's pickles through a
restricted unpickler that resolves numpy's array globals and nothing else.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.data.sampler import balanced_critic_sampler
from critic_vae_tpu_torch.device import no_tf32, resolve_device
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE


def make_recon_fn(vae: VAE, batch_size: int = 512, device="cuda"):
    """``recon_fn(frames, preds) -> (recon_at_pred, recon_at_zero)`` for the
    sampler: (n, H, W, 3) float frames in [0, 1] and (n,) critic values to two
    (n, H, W, 3) float32 numpy arrays of tanh'd decodes, ``batch_size`` frames
    a chunk on ``device`` (the card unless the caller asks for the CPU),
    float32 with TF32 off. The JAX package pads ragged chunks to bucket
    shapes for XLA's compiles; eval-mode frames are independent, so the port
    takes chunks as they come."""
    device = resolve_device(device)
    vae = vae.to(device)

    def recon_fn(frames: np.ndarray, preds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        outs_pred, outs_zero = [], []
        with torch.inference_mode(), no_tf32():
            for i in range(0, len(frames), batch_size):
                x = torch.from_numpy(np.ascontiguousarray(frames[i:i + batch_size], np.float32))
                x = x.to(device).permute(0, 3, 1, 2).contiguous()
                v = torch.from_numpy(np.asarray(preds[i:i + batch_size], np.float32)).to(device)
                mu = vae.encode(x)[0]
                b = mu.shape[0]
                both = vae.decode(torch.cat([mu, mu]), torch.cat([v, torch.zeros_like(v)]))
                both = both.permute(0, 2, 3, 1).cpu().numpy()
                outs_pred.append(both[:b])
                outs_zero.append(both[b:])
        return np.concatenate(outs_pred), np.concatenate(outs_zero)

    return recon_fn


def build_recon_dataset(trajectories: Iterable, critic: Critic, vae: VAE, *,
                        total_images: int = 50_000, collect: int = 150,
                        device="cuda") -> np.ndarray:
    """The reconstruction dataset, (N, H, W, 3) float32 (reference:
    load_minerl_data(recon_dset=True), vae_utility.py:422-443)."""
    return balanced_critic_sampler(trajectories, critic, total_images=total_images,
                                   collect=collect, device=device,
                                   recon_fn=make_recon_fn(vae, device=device))


def save_dataset(path: str, dataset: np.ndarray) -> None:
    np.savez_compressed(path, frames=dataset.astype(np.float32))


_ALLOWED_PICKLE_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),  # numpy >= 2 module path
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


def _numpy_only_unpickler(file):
    """A pickle.Unpickler that resolves only numpy's array globals; any other
    global raises instead of running arbitrary code."""
    import importlib
    import pickle

    class NumpyOnly(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) in _ALLOWED_PICKLE_GLOBALS:
                return getattr(importlib.import_module(module), name)
            raise pickle.UnpicklingError(
                f"global {module}.{name} is forbidden in dataset pickles "
                "(only numpy arrays are expected)"
            )

    return NumpyOnly(file)


def load_dataset(path: str) -> np.ndarray:
    """A recon dataset as (N, H, W, 3) float32 NHWC: the ``.npz`` artifact,
    a raw ``.npy`` (memory-mapped), or the reference's pickle, a list of (1,
    3, H, W) float32 frames (reference: vae.py:135-136), converted into one
    preallocated array while the list is consumed from its tail."""
    import zipfile

    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f".npy dataset must be (N, H, W, 3), got {arr.shape}")
        return arr
    if zipfile.is_zipfile(path):
        with np.load(path) as data:
            return data["frames"]
    with open(path, "rb") as f:
        dset = _numpy_only_unpickler(f).load()
    if not isinstance(dset, list) or not dset:
        raise ValueError(
            "unrecognized dataset pickle: expected a non-empty list of "
            "(1, 3, H, W) frames (reference vae_utility.py:422-443)"
        )
    first = np.squeeze(np.asarray(dset[0]))
    if first.ndim != 3 or first.shape[0] != 3:
        raise ValueError(
            f"unrecognized dataset pickle layout {first.shape}; expected a "
            "list of (1, 3, H, W) frames (reference vae_utility.py:422-443)"
        )
    c, h, w = first.shape
    out = np.empty((len(dset), h, w, c), np.float32)
    for i in range(len(dset) - 1, -1, -1):  # consume and free from the tail
        a = np.squeeze(np.asarray(dset.pop()))
        if a.shape != (c, h, w):
            raise ValueError(
                f"dataset pickle frame {i} has shape {a.shape}, expected {(c, h, w)}"
            )
        out[i] = a.transpose(1, 2, 0)
    return out
