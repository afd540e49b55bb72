"""Kernel B2: the device CRF's normalized bilateral message matrix.

Counterpart of critic_vae_tpu/crf/fused_build.py::build_bilateral. Per frame
of N = H*W pixels, with features (x, y)/alpha and rgb/beta:

    K[i,j] = exp(-1/2 |dxy|^2 - 1/2 |drgb|^2) for i != j, exactly 0 on i == j
    n_i    = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)
    M[i,j] = (n_i * n_j) * K[i,j]

The CUDA kernel is ``csrc/bilateral_build.cu``;
:func:`build_bilateral_reference` is its plain version. Both take the
differences per coordinate (never a Gram product), so the diagonal's
exponent is exactly 0 and the ``logp < 0`` predicate excludes it; the JAX
package's Gram form (``_normalized_kernel``) carries ~1e-3 relative error in
the exponent and is not what either version computes.
"""

from __future__ import annotations

import torch

from critic_vae_tpu_torch.crf.device import _EPS_NORM, _coords
from critic_vae_tpu_torch.kernels import build as kb

OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def build_bilateral_reference(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int,
                              w: int, out_dtype: str = "bfloat16",
                              row_block: int = 512) -> torch.Tensor:
    """Plain PyTorch version: (C, N, 3) uint8 -> (C, N, N) M in ``out_dtype``.

    Built one frame at a time in blocks of ``row_block`` rows, so a 64x64
    frame holds one (N, N) float32 K and never an (N, N, 3) difference."""
    c, n, _ = imgs_u8.shape
    dev = imgs_u8.device
    pos = _coords(h, w, dev) / _f32(alpha, dev)  # (N, 2)
    col = imgs_u8.float() / _f32(beta, dev)      # (C, N, 3)
    sqrt_w1 = torch.sqrt(_f32(w1, dev))
    out = torch.empty((c, n, n), dtype=OUT_DTYPES[out_dtype], device=dev)
    k = torch.empty((n, n), dtype=torch.float32, device=dev)
    for ci in range(c):
        for r0 in range(0, n, row_block):
            r1 = min(n, r0 + row_block)
            dp = pos[r0:r1, None, :] - pos[None, :, :]
            logp = -0.5 * (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1])
            dc = col[ci, r0:r1, None, :] - col[ci, None, :, :]
            logc = -0.5 * (dc[..., 0] * dc[..., 0] + dc[..., 1] * dc[..., 1]
                           + dc[..., 2] * dc[..., 2])
            k[r0:r1] = torch.where(logp < 0.0, torch.exp(logp + logc), 0.0)
        nvec = sqrt_w1 * torch.rsqrt(k.sum(dim=1) + _EPS_NORM)
        out[ci] = ((nvec[:, None] * nvec[None, :]) * k).to(out.dtype)
    return out


def build_bilateral(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int, w: int,
                    out_dtype: str = "bfloat16") -> torch.Tensor:
    """(C, N, 3) uint8 frames -> (C, N, N) normalized bilateral matrices M,
    diag(M) = 0, stored in ``out_dtype`` ("bfloat16" or "float32").

    CUDA tensors launch kernel B2 (or raise); CPU tensors take the plain
    version."""
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 3 or imgs_u8.shape[2] != 3:
        raise ValueError(
            f"build_bilateral: want (C, N, 3) uint8, got {tuple(imgs_u8.shape)} {imgs_u8.dtype}"
        )
    c, n, _ = imgs_u8.shape
    if n != h * w:
        raise ValueError(f"build_bilateral: N={n} is not h*w={h}*{w}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"build_bilateral: out_dtype {out_dtype!r} (float32|bfloat16)")
    if imgs_u8.device.type == "cpu":
        return build_bilateral_reference(imgs_u8, w1, alpha, beta, h=h, w=w,
                                         out_dtype=out_dtype)
    if imgs_u8.device.type != "cuda":
        raise ValueError(f"build_bilateral: unsupported device {imgs_u8.device}")
    if not imgs_u8.is_contiguous():
        raise ValueError("build_bilateral: frames must be contiguous")
    lib = kb.library()
    dev = imgs_u8.device
    nvec = torch.empty((c, n), dtype=torch.float32, device=dev)
    out = torch.empty((c, n, n), dtype=OUT_DTYPES[out_dtype], device=dev)
    with torch.cuda.device(dev):
        status = lib.cvt_bilateral_build(
            imgs_u8.data_ptr(), c, n, w, float(w1), float(alpha), float(beta),
            nvec.data_ptr(), out.data_ptr(), int(out_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "bilateral_build")
    kb.LAUNCHES["bilateral_build"] += 1
    return out
