"""The upsample of ``jax.image.resize`` for (B, h, w) maps (counterpart of
the call at critic_vae_tpu/ops/saliency.py, LayerCAM's upsample).

``jax.image.resize`` is separable: along each resized axis it multiplies by
a (out, in) weight matrix, ``R = W_h @ X @ W_w^T``. Each output row of W is
the kernel at the output pixel's half-centred sample position,
``(o + 0.5) * in/out - 0.5``, over the input pixels, with the taps that fall
outside the input dropped and the rest renormalised to sum to 1 (no reflect
or clamp padding: Lanczos3's first row at 16 -> 64 is [1.1807, -0.2275,
0.0468]). Downsampling widens the kernel by in/out (``antialias``, the JAX
default). ``nearest`` picks input pixel floor((o + 0.5) * in/out).

torch has neither Lanczos3 nor JAX's cubic: ``F.interpolate``'s bicubic is
Keys' a = -0.75, JAX's a = -0.5. So the matrices are built here in numpy,
float64 rounded to float32 (JAX builds them in float32; the two agree within
1e-6), and applied as two float32 products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

METHODS = ("bilinear", "bicubic", "lanczos3", "nearest")


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0) / (np.pi ** 2 * x ** 2)
    return np.where(x > 3.0, 0.0, np.where(x > 1e-3, y, 1.0))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"lanczos3": _lanczos3, "bicubic": _keys_cubic, "bilinear": _triangle}


@functools.lru_cache(maxsize=None)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 matrix W with ``resize(x) = W @ x`` along
    one axis, as ``jax.image.resize`` computes it (``antialias=True``)."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r} ({'|'.join(METHODS)})")
    if in_size == out_size:  # JAX skips the axis: every kernel interpolates
        return np.eye(out_size, dtype=np.float32)
    scale = out_size / in_size
    if method == "nearest":
        src = np.floor(((np.arange(out_size) + 0.5) * in_size / out_size)
                       .astype(np.float32)).astype(np.int64)
        w = np.zeros((out_size, in_size), np.float64)
        w[np.arange(out_size), src] = 1.0
        return w.astype(np.float32)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    kernel_scale = max(1.0 / scale, 1.0)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, method: str, device: torch.device):
    """:func:`weight_matrix` on ``device``, uploaded once and shared by every
    call (read only). A copy of pageable memory to a card waits until the
    card's queue has drained, so an upload a call held the host and the card
    in step, two waits a LayerCAM view."""
    with torch.inference_mode(False):
        return torch.from_numpy(weight_matrix(in_size, out_size, method)).to(device)


def resize_maps(maps: torch.Tensor, size: tuple, method: str) -> torch.Tensor:
    """(B, h, w) float32 maps -> (B, H, W) as ``jax.image.resize(maps, (B, H,
    W), method)``: ``W_h @ maps @ W_w^T`` in float32 on the maps' device.
    On a card the caller turns TF32 off for JAX's ``Precision.HIGHEST``."""
    out_h, out_w = size
    b, h, w = maps.shape
    wh = _device_matrix(h, out_h, method, maps.device)
    ww = _device_matrix(w, out_w, method, maps.device)
    return torch.matmul(torch.matmul(wh, maps.float()), ww.T)
