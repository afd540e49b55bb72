"""Kernel B1: the fused diff-mask tail of the mask stage.

Counterpart of critic_vae_tpu/ops/pallas_kernels.py::fused_diff_mask and of
the XLA tail of critic_vae_tpu/ops/mask.py ``diff_images``: from the
decoder's two pre-tanh outputs, |tanh(pre_zero) - tanh(pre_one)|, the
Rec.601 grey projection and the per-frame max. The CUDA kernel is
``csrc/diff_mask.cu``; :func:`diff_mask_reference` is its plain version.

The input is one NCHW decode, (2B, 3, H, W), f32 or bf16: ``pre[:B]`` is
the decode at the critic value, ``pre[B:]`` the one at 0. tanh is taken in
float32 on the widened input: the arithmetic of both JAX tails as compiled,
its Pallas kernel and its XLA tail (XLA drops the rounding of a tanh whose
only use is a cast to float32).
"""

from __future__ import annotations

import contextlib

import torch

from critic_vae_tpu_torch.kernels import build as kb

REC601 = (0.2989, 0.5870, 0.1140)


def diff_mask_reference(pre: torch.Tensor):
    """Plain PyTorch version: (grey (B, H, W) f32, max (B,) f32)."""
    b = pre.shape[0] // 2
    d = torch.abs(torch.tanh(pre[b:].float()) - torch.tanh(pre[:b].float()))
    grey = d[:, 0] * REC601[0] + d[:, 1] * REC601[1] + d[:, 2] * REC601[2]
    return grey, torch.amax(grey, dim=(1, 2))


def _check(pre: torch.Tensor) -> None:
    if pre.dim() != 4 or pre.shape[1] != 3 or pre.shape[0] % 2:
        raise ValueError(f"diff_mask: want one (2B, 3, H, W) decode, got {tuple(pre.shape)}")
    if pre.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diff_mask: want float32 or bfloat16, got {pre.dtype}")


def diff_mask(pre: torch.Tensor):
    """(grey (B, H, W) f32, max (B,) f32) of the (2B, 3, H, W) decode ``pre``.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    _check(pre)
    if pre.device.type == "cpu":
        return diff_mask_reference(pre)
    if pre.device.type != "cuda":
        raise ValueError(f"diff_mask: unsupported device {pre.device}")
    if not pre.is_contiguous():
        raise ValueError("diff_mask: the decode must be contiguous NCHW")
    b2, _, h, w = pre.shape
    lib = kb.library()
    grey = torch.empty((b2 // 2, h, w), dtype=torch.float32, device=pre.device)
    maxv = torch.empty((b2 // 2,), dtype=torch.float32, device=pre.device)
    index = pre.device.index
    # switch the current device only when the decode lies on another card;
    # the raw stream handle skips building a torch.cuda.Stream each call
    on = (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index))
    with on:
        status = lib.cvt_diff_mask(
            pre.data_ptr(), int(pre.dtype == torch.bfloat16), b2 // 2, h * w,
            grey.data_ptr(), maxv.data_ptr(), torch._C._cuda_getCurrentRawStream(index),
        )
    kb.check(status, "diff_mask")
    kb.LAUNCHES["diff_mask"] += 1
    return grey, maxv
