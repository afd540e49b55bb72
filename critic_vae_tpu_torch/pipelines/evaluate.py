"""Image evaluation and injection (counterpart of
critic_vae_tpu/pipelines/evaluate.py; reference: vae.py:68-108).

``eval``: per still frame the critic score, the double decode of its mu (at
the score and at 0) and the diff map, normalised by the two-pass global
mean-max over exactly this image set, drawn as 4-panel strips. ``inject``:
each frame's mu decoded at a ladder of critic values, drawn beside the
original.

Each chunk decodes its pair once, pre-tanh: kernel B1 (ops/diff_mask.py)
takes the map from that decode, and the reconstructions are tanh of the
same tensor (ops/mask.py ``recons_from_decode``). float32 runs with TF32
off, as the JAX package's float32 is exact. Arrays in and out are NHWC
numpy, as the JAX package's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from critic_vae_tpu_torch.device import no_tf32, resolve_device
from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import INJECT_VALUES, VAE
from critic_vae_tpu_torch.ops.diff_mask import diff_mask
from critic_vae_tpu_torch.ops.mask import (decode_pair, normalize_diffs_given_mean,
                                          recons_from_decode)

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def load_image_dir(path: str) -> Tuple[np.ndarray, List[str]]:
    """Every image of a directory as one (N, H, W, 3) float32 batch in
    [0, 1], files sorted by name (the reference iterates raw ``os.listdir``
    order, vae.py:70). No image, or images of mixed sizes, raise."""
    from PIL import Image

    files = sorted(f for f in os.listdir(path) if f.lower().endswith(IMAGE_SUFFIXES))
    if not files:
        raise FileNotFoundError(f"no images (.jpg/.jpeg/.png/.bmp) in {path}")
    arrays = [np.asarray(Image.open(os.path.join(path, f)).convert("RGB"), dtype=np.float32)
              / 255.0 for f in files]
    shapes = {a.shape for a in arrays}
    if len(shapes) > 1:
        raise ValueError(f"images in {path} have mixed sizes {sorted(shapes)}; the batched "
                         "eval pipeline needs one resolution")
    return np.stack(arrays), files


def _chunks(images: np.ndarray, batch_size: int, device: torch.device):
    """(NCHW float32 chunk on ``device``, valid rows): ``batch_size`` rows a
    chunk, the last padded with copies of its last frame (one shape, as the
    JAX package's)."""
    for i in range(0, len(images), batch_size):
        chunk = images[i:i + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - valid, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device)
        yield x.permute(0, 3, 1, 2).contiguous(), valid


def evaluate_images(vae: VAE, critic: Critic, images: np.ndarray, batch_size: int = 512, *,
                    device="cuda") -> dict:
    """Critic and double-decode diff over (N, H, W, 3) float stills on
    ``device`` (the card unless the caller asks for the CPU; the models are
    moved there), chunked at ``batch_size`` with tail padding. The
    normalisation's mean is taken over the per-image maxima trimmed of the
    padding, so results do not depend on the chunking.

    Returns dict(preds (N,), recon_one, recon_zero (N, H, W, 3) float32,
    diff_u8 (N, H, W) uint8), numpy."""
    n = len(images)
    if n == 0:
        shp = (0,) + tuple(images.shape[1:])
        return {"preds": np.zeros((0,), np.float32), "recon_one": np.zeros(shp, np.float32),
                "recon_zero": np.zeros(shp, np.float32), "diff_u8": np.zeros(shp[:-1], np.uint8)}
    device = resolve_device(device)
    vae, critic = vae.to(device), critic.to(device)
    outs = {"preds": [], "recon_one": [], "recon_zero": []}
    diffs, maxima = [], []
    with torch.inference_mode(), no_tf32():
        for x, valid in _chunks(images, min(batch_size, n), device):
            preds = critic(x)[:, 0]
            pre = decode_pair(vae, x, preds)
            diff, max_value = diff_mask(pre)
            rec = recons_from_decode(pre, recons_u8=False)
            for k, v in (("preds", preds), ("recon_one", rec["recon_one"]),
                         ("recon_zero", rec["recon_zero"])):
                outs[k].append(v[:valid])
            diffs.append(diff[:valid])
            maxima.append(max_value[:valid])
        mean_max = torch.mean(torch.cat(maxima))
        diff_u8 = torch.cat([normalize_diffs_given_mean(d, mean_max) for d in diffs])
        out = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        out["diff_u8"] = diff_u8.cpu().numpy()
    return out


def inject_images(vae: VAE, critic: Critic, images: np.ndarray,
                  values: Optional[np.ndarray] = None, batch_size: int = 256, *,
                  device="cuda") -> dict:
    """The injection ladder over (N, H, W, 3) float stills: each frame's mu
    decoded at ``values`` (default 0, 0.2, …, 1, the reference's
    inject_n = 6) as one batched decode of B·K latents a chunk, chunked at
    ``batch_size`` with tail padding. Returns dict(preds (N,), recons (N, K,
    H, W, 3) float32), numpy."""
    k = len(INJECT_VALUES) if values is None else len(values)
    n = len(images)
    if n == 0:
        return {"preds": np.zeros((0,), np.float32),
                "recons": np.zeros((0, k) + tuple(images.shape[1:]), np.float32)}
    device = resolve_device(device)
    vae, critic = vae.to(device), critic.to(device)
    preds_out, recons_out = [], []
    with torch.inference_mode(), no_tf32():
        for x, valid in _chunks(images, min(batch_size, n), device):
            preds_out.append(critic(x)[:valid, 0])
            recons_out.append(vae.inject(x, values)[:valid].permute(0, 1, 3, 4, 2))
        return {"preds": torch.cat(preds_out).cpu().numpy(),
                "recons": torch.cat(recons_out).float().cpu().numpy()}


def save_eval_strips(results: dict, images: np.ndarray, out_dir: str) -> List[str]:
    """The 4-panel strips ``image-%03d.png`` (reference: vae.py:102-108)."""
    from critic_vae_tpu_torch.viz.panels import final_frame

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(len(images)):
        img = final_frame(images[i], results["recon_one"][i], results["recon_zero"][i],
                          results["diff_u8"][i], results["preds"][i])
        p = os.path.join(out_dir, f"image-{i:03d}.png")
        img.save(p, format="png")
        paths.append(p)
    return paths


def save_inject_strips(results: dict, images: np.ndarray, out_dir: str) -> List[str]:
    """The original beside its K injected reconstructions, ``image-%03d.png``."""
    from critic_vae_tpu_torch.viz.panels import inject_strip

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(len(images)):
        p = os.path.join(out_dir, f"image-{i:03d}.png")
        inject_strip(images[i], list(results["recons"][i])).save(p, format="png")
        paths.append(p)
    return paths
