"""Kernel B1: the fused diff-mask tail of the mask stage.

Counterpart of critic_vae_tpu/ops/pallas_kernels.py::fused_diff_mask: from
the decoder's two pre-tanh outputs, |tanh(pre_zero) - tanh(pre_one)|, the
Rec.601 grey projection and the per-frame max. The CUDA kernel is
``csrc/diff_mask.cu``; :func:`diff_mask_reference` is its plain version.

The inputs are NCHW decoder outputs, (B, 3, H, W), f32 or bf16 — the two
halves ``pre[:B]`` and ``pre[B:]`` of one (2B, 3, H, W) decode. tanh runs in
float32 in both versions (bf16 inputs are widened first), as in the Pallas
kernel; for float32 inputs both equal the JAX package's XLA tail
(ops/mask.py ``diff_images``).
"""

from __future__ import annotations

import torch

from critic_vae_tpu_torch.kernels import build as kb

REC601 = (0.2989, 0.5870, 0.1140)


def diff_mask_reference(pre_one: torch.Tensor, pre_zero: torch.Tensor):
    """Plain PyTorch version: (grey (B, H, W) f32, max (B,) f32)."""
    d = torch.abs(torch.tanh(pre_zero.float()) - torch.tanh(pre_one.float()))
    grey = d[:, 0] * REC601[0] + d[:, 1] * REC601[1] + d[:, 2] * REC601[2]
    return grey, torch.amax(grey, dim=(1, 2))


def _check(pre_one: torch.Tensor, pre_zero: torch.Tensor) -> None:
    if pre_one.shape != pre_zero.shape or pre_one.dim() != 4 or pre_one.shape[1] != 3:
        raise ValueError(
            f"diff_mask: want two (B, 3, H, W) tensors, got "
            f"{tuple(pre_one.shape)} and {tuple(pre_zero.shape)}"
        )
    if pre_one.dtype != pre_zero.dtype or pre_one.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diff_mask: want float32 or bfloat16, got {pre_one.dtype}/{pre_zero.dtype}")
    if pre_one.device != pre_zero.device:
        raise ValueError(f"diff_mask: inputs on {pre_one.device} and {pre_zero.device}")


def diff_mask(pre_one: torch.Tensor, pre_zero: torch.Tensor):
    """(grey (B, H, W) f32, max (B,) f32) of the two pre-tanh decodes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    _check(pre_one, pre_zero)
    if pre_one.device.type == "cpu":
        return diff_mask_reference(pre_one, pre_zero)
    if pre_one.device.type != "cuda":
        raise ValueError(f"diff_mask: unsupported device {pre_one.device}")
    if not (pre_one.is_contiguous() and pre_zero.is_contiguous()):
        raise ValueError("diff_mask: inputs must be contiguous NCHW")
    b, _, h, w = pre_one.shape
    lib = kb.library()
    grey = torch.empty((b, h, w), dtype=torch.float32, device=pre_one.device)
    maxv = torch.empty((b,), dtype=torch.float32, device=pre_one.device)
    with torch.cuda.device(pre_one.device):
        status = lib.cvt_diff_mask(
            pre_one.data_ptr(), pre_zero.data_ptr(),
            int(pre_one.dtype == torch.bfloat16), b, h * w,
            grey.data_ptr(), maxv.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "diff_mask")
    kb.LAUNCHES["diff_mask"] += 1
    return grey, maxv
