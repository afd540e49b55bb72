"""Exact dense-CRF mean-field on the device (counterpart of
critic_vae_tpu/crf/device.py, mask-refinement path).

Per frame of N = H*W pixels the bilateral term is the full N x N matrix M
built by kernel B2 (crf/fused_build.py); the spatial term
exp(-(dx^2+dy^2)/2 gamma^2) is exactly separable, so its message is a
truncated separable Gaussian depthwise conv. Messages run over j != i:

    Q <- softmax(-U + M @ Q + w2 * n_s * (K_s @ (n_s * Q)))   x iters
    seg = argmax Q

with U = -log(clamp(prob, 1e-8)) and Q0 = softmax(-U). Frames go in padded
fixed-size chunks; the chunk's M stack is the only N^2 temporary.

The M @ Q message accumulates in float32 whatever M's storage dtype, as the
JAX package's ``preferred_element_type=f32`` does. For a bf16 M on CUDA that
is ``torch.bmm(M, Q_bf16, torch.float32)`` — the ``out_dtype`` overload of
``bmm``, which PyTorch documents for float32 output from bf16 operands on
CUDA only. A plain bf16 ``bmm`` would round the messages to bf16. On the CPU
the same product is ``bmm`` of the bf16 values widened to float32 (bf16
products are exact in float32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS

_EPS_PROB = 1e-8   # unary clamp, as densecrf.cpp
_EPS_NORM = 1e-20  # normalizer epsilon, as densecrf.cpp

# Per-chunk budget for the N^2 bilateral matrices. The JAX package sized it
# for a 16 GB TPU chip (its crf/device.py _run_chunked); kept as is until it
# is measured on the 80 GB H100 (ROADMAP A.5). At 64x64 it allows 95 f32 or
# 190 bf16 frames, above the default chunk of 64.
_MEM_BUDGET = 6 * 1024**3

_NOT_PORTED = {
    "xla": "the Gram-form 'xla' build",
    "int8": "kernels B3/B4 behind build='int8'",
    "vmem": "kernel B5 behind build='vmem'",
}


def _coords(h: int, w: int, device) -> torch.Tensor:
    """(N, 2) pixel coordinates in (x, y) order, float32."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)


def _spatial_taps(gamma: float, h: int, w: int) -> np.ndarray:
    """1-D taps of the separable spatial Gaussian, truncated where it is
    numerically zero (>= 8 gamma) and clamped to the frame, so the length is
    odd and SAME padding is symmetric."""
    radius = min(int(np.ceil(8.0 * gamma)), max(h, w) - 1)
    k = np.arange(-radius, radius + 1, dtype=np.float32)
    return np.exp(-0.5 * (k / np.float32(gamma)) ** 2).astype(np.float32)


def _sep_conv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise (B, C, H, W) conv with outer(taps, taps): along H, then W."""
    c, k = x.shape[1], taps.shape[0]
    r = k // 2
    x = F.conv2d(x, taps.view(1, 1, k, 1).repeat(c, 1, 1, 1), padding=(r, 0), groups=c)
    return F.conv2d(x, taps.view(1, 1, 1, k).repeat(c, 1, 1, 1), padding=(0, r), groups=c)


def _message(mb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M @ Q with float32 accumulation and output (see the module note)."""
    if mb.dtype == torch.float32:
        return torch.bmm(mb, q)
    qm = q.to(mb.dtype)
    if mb.is_cuda:
        return torch.bmm(mb, qm, torch.float32)
    return torch.bmm(mb.float(), qm.float())


def _mean_field_iterate(mb: torch.Tensor, prob: torch.Tensor, taps: torch.Tensor,
                        w2, h: int, w: int, iters: int) -> torch.Tensor:
    """Mean-field given the chunk's bilateral matrices ``mb`` (C, N, N):
    (C, N, L) probabilities -> (C, N) uint8 argmax labels.

    The spatial conv includes the centre tap (its own q, weight 1), so the
    j != i message and the normalizer's row sum subtract it back out."""
    c, n, L = prob.shape
    ones = torch.ones((1, 1, h, w), dtype=torch.float32, device=prob.device)
    rowsum_s = _sep_conv(ones, taps).reshape(n, 1) - 1.0
    ns = torch.rsqrt(rowsum_s + _EPS_NORM)  # (N, 1), the same for every frame
    unary = -torch.log(torch.clamp_min(prob, _EPS_PROB))
    q = torch.softmax(-unary, dim=-1)
    for _ in range(iters):
        msg = _message(mb, q)
        y = ns * q
        y_img = y.view(c, h, w, L).permute(0, 3, 1, 2)
        sp = _sep_conv(y_img, taps).permute(0, 2, 3, 1).reshape(c, n, L) - y
        msg = msg + w2 * ns * sp
        q = torch.softmax(msg - unary, dim=-1)
    return torch.argmax(q, dim=-1).to(torch.uint8)


def _crf_chunk_from_masks(imgs_u8: torch.Tensor, masks_u8: torch.Tensor,
                          taps: torch.Tensor, w1, w2, alpha, beta, *, h: int,
                          w: int, iters: int, compute_dtype: str) -> torch.Tensor:
    """One chunk: (C, N, 3) uint8 frames and (C, N) 0/1 masks -> (C, N) uint8
    labels. The class probabilities are the stacked (1 - mask, mask)
    planes, built on the device."""
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral

    m = masks_u8.float()
    probs = torch.stack([1.0 - m, m], dim=-1)
    mb = build_bilateral(imgs_u8, w1, alpha, beta, h=h, w=w, out_dtype=compute_dtype)
    return _mean_field_iterate(mb, probs, taps, w2, h, w, iters)


def _resolve_build(build: str) -> str:
    """Only ``auto`` is ported: kernel B2 on a CUDA tensor, its plain version
    on a CPU tensor (crf/fused_build.build_bilateral). There is no
    environment override, so nothing can route a run away from the kernel."""
    if build == "auto":
        return build
    if build in _NOT_PORTED:
        raise NotImplementedError(
            f"build={build!r}: {_NOT_PORTED[build]} is not ported yet (ROADMAP A.9)"
        )
    raise ValueError(f"unknown build {build!r} (auto)")


def _run_chunked(flat_imgs: torch.Tensor, flat_masks: torch.Tensor, params, h: int,
                 w: int, frame_chunk: int, compute_dtype: str, *, build: str = "auto",
                 fetch: bool = True):
    """Refine (n, N, 3) frames / (n, N) masks in fixed-size chunks, padded
    by repeating the last frame. Returns (n, N) uint8 labels, as numpy with
    ``fetch`` or as a device tensor without."""
    w1, alpha, beta, w2, gamma, iters = params
    _resolve_build(build)
    n = flat_imgs.shape[0]
    if n == 0:
        out = torch.empty((0, h * w), dtype=torch.uint8, device=flat_imgs.device)
        return out.cpu().numpy() if fetch else out
    taps = torch.from_numpy(_spatial_taps(float(gamma), h, w)).to(flat_imgs.device)
    elem_bytes = 2 if compute_dtype == "bfloat16" else 4
    frame_chunk = min(frame_chunk, n)
    frame_chunk = max(1, min(frame_chunk, _MEM_BUDGET // ((h * w) ** 2 * elem_bytes)))
    segs = []
    for i in range(0, n, frame_chunk):
        imgs = flat_imgs[i : i + frame_chunk]
        masks = flat_masks[i : i + frame_chunk]
        valid = imgs.shape[0]
        if valid < frame_chunk:
            pad = frame_chunk - valid
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, -1, -1)])
            masks = torch.cat([masks, masks[-1:].expand(pad, -1)])
        seg = _crf_chunk_from_masks(
            imgs.contiguous(), masks, taps, w1, w2, alpha, beta,
            h=h, w=w, iters=int(iters), compute_dtype=compute_dtype,
        )
        segs.append(seg[:valid])
    out = torch.cat(segs) if len(segs) > 1 else segs[0]
    return out.cpu().numpy() if fetch else out


@torch.inference_mode()
def refine_masks_device(frames_u8, thr_masks, params: Tuple = REFERENCE_CRF_PARAMS, *,
                        frame_chunk: int = 64, compute_dtype: str = "auto",
                        build: str = "auto", fetch: bool = True, device=None):
    """Refine (n, H, W) threshold masks of (n, H, W, 3) uint8 frames with the
    exact dense CRF; returns (n, H, W) bool, as numpy with ``fetch`` or as a
    tensor on the device without.

    Tensors are used where they lie; numpy inputs need ``device``.
    ``compute_dtype="auto"`` stores M in bf16 on CUDA (the kernel's fast
    path; held to >= 99.9% segmentation agreement with float32) and float32
    on the CPU."""
    if device is None:
        if not isinstance(frames_u8, torch.Tensor):
            raise ValueError("refine_masks_device: numpy inputs need an explicit device")
        device = frames_u8.device
    device = torch.device(device)
    frames = torch.as_tensor(frames_u8, device=device)
    if frames.dtype != torch.uint8:
        raise TypeError(f"refine_masks_device: frames must be uint8, got {frames.dtype}")
    n, h, w_, _ = frames.shape
    if tuple(thr_masks.shape) != (n, h, w_):
        raise ValueError(
            f"thr_masks shape {tuple(thr_masks.shape)} does not match frames {tuple(frames.shape)}"
        )
    masks = torch.as_tensor(thr_masks, device=device).to(torch.uint8).reshape(n, h * w_)
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    out = _run_chunked(
        frames.reshape(n, h * w_, 3), masks, params, h, w_, frame_chunk,
        compute_dtype, build=build, fetch=fetch,
    )
    return out.reshape(n, h, w_).astype(bool) if fetch else out.reshape(n, h, w_).bool()
