"""Kernel ``block_epilogue``: a conv block's post-conv chain of the mask
stage in one pass.

After each cuDNN conv of the mask stage ATen runs the block's glue as
separate passes over the full-resolution float32 output. The CUDA kernel
``csrc/block_epilogue.cu`` reads the conv output once and writes only the
block's output, bitwise the ATen chain's on the same conv output:

* :func:`pool_epilogue` (encoder and critic blocks, the merged front end):
  the channels of ``bn`` are an encoder block's, ``+ bias``, eval BatchNorm
  (:func:`batchnorm_eval`), the 2×2 max pool, ReLU (or none: the encoder's
  last block takes ATen's tanh after); the channels after them a critic
  block's, ``+ bias``, ReLU, the 2×2 max.
* :func:`shuffle_epilogue` (the decoder's phase-split upconvs,
  ``ops/upconv.py``): the ``F.pixel_shuffle(·, 2)`` interleave, ``+ bias``,
  ReLU on stages 1–3.

The two are the blocks' one entry point: each runs the kernel where
:func:`fused` holds, a float32 tensor on the card while no autograd
records (the mask stage runs under ``inference_mode``), and raises on a
shape the kernel cannot take. Everywhere else (training, the saliency
stage's autograd, bfloat16, the CPU) it runs the plain chain,
:func:`pool_epilogue_reference` or :func:`shuffle_epilogue_reference`, in
the callers' dtype rules. Without autograd each call runs inside a
``block.epilogue`` span (:func:`span`), fused or not.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.utils.profiling import span as _span

SPAN = "block.epilogue"


def batchnorm_eval(bn: nn.BatchNorm2d, x: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Eval-mode BatchNorm in float32 over dim -3 (channels of (..., C, H,
    W)), cast back to x's dtype.

    ``bias``: a conv bias, cast to x's dtype and added to x in float32,
    unrounded. That is the JAX package's ``_batchnorm(conv(x, w) + b)`` as
    XLA compiles it: the sum's only use is BN's cast to float32, and XLA
    drops the sum's rounding to the activation dtype (its excess-precision
    rule), so in bfloat16 the sum is not rounded before BN."""
    xf = x.float()
    if bias is not None:
        xf = xf + bias.to(x.dtype).float()[:, None, None]
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (xf - bn.running_mean[:, None, None]) * inv[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


def fused(y: torch.Tensor) -> bool:
    """Whether the epilogue of the conv output ``y`` runs as the kernel:
    float32 on the card, with no autograd recording."""
    return y.is_cuda and y.dtype == torch.float32 and not torch.is_grad_enabled()


def span():
    """The ``block.epilogue`` span around a block's epilogue while no
    autograd records, fused or not; nothing otherwise."""
    return contextlib.nullcontext() if torch.is_grad_enabled() else _span(SPAN)


def frozen(cache: dict, key, tensors, build):
    """``build()``'s tensor, made once from frozen ``tensors`` and again
    only when one's storage, device or in-place version changes (a load or a
    move rebuilds it); kept in ``cache`` under ``key``."""
    ident = tuple((t.data_ptr(), t.device, None if t.is_inference() else t._version)
                  for t in tensors)
    hit = cache.get(key)
    if hit is None or hit[0] != ident:
        with torch.no_grad():
            hit = (ident, build())
        cache[key] = hit
    return hit[1]


def pool_params(cache: dict, bias: torch.Tensor, bn: nn.BatchNorm2d,
                tail_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The (4, C) float32 rows (bias, mean, inv, beta) of an encoder block's
    epilogue, ``inv = rsqrt(running_var + eps) · weight`` as
    :func:`batchnorm_eval` computes it, cached in ``cache`` with the frozen
    weights (:func:`frozen`). ``tail_bias``: the bias of channels after the
    BN ones (the merged front end's critic), appended with 0 in their other
    rows."""
    tensors = (bias, bn.running_mean, bn.running_var, bn.weight, bn.bias)

    def build():
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        rows = torch.stack([bias.float(), bn.running_mean, inv, bn.bias])
        if tail_bias is not None:
            tail = torch.zeros((4, tail_bias.shape[0]), dtype=rows.dtype, device=rows.device)
            tail[0] = tail_bias
            rows = torch.cat([rows, tail], dim=1)
        return rows.contiguous()

    tail = () if tail_bias is None else (tail_bias,)
    return frozen(cache, (id(bn), bool(tail)), tensors + tail, build)


def _column(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype)[:, None, None]


def pool_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                            bn: nn.BatchNorm2d | None = None,
                            tail_bias: torch.Tensor | None = None, relu: bool = True):
    """Plain version of :func:`pool_epilogue`: the blocks' ATen chains on
    the conv output ``y`` (B, C, H, W), in y's dtype: the encoder's
    :func:`batchnorm_eval` → pool → ReLU (none with ``relu`` False), the
    critic's ``+ bias`` (cast to y's dtype) → ReLU → pool."""
    n = 0 if bn is None else bn.num_features
    b, c, ho, wo = y.shape[0], y.shape[1], y.shape[2] // 2, y.shape[3] // 2
    out_bn = out_plain = y.new_empty((b, 0, ho, wo))
    if n:  # a whole y is not sliced: autograd keeps the graph it had
        out_bn = F.max_pool2d(batchnorm_eval(bn, y if n == c else y[:, :n], bias), 2)
        out_bn = F.relu(out_bn) if relu else out_bn
    if n < c:
        plain_bias = bias if bn is None else tail_bias
        out_plain = F.max_pool2d(F.relu((y if n == 0 else y[:, n:])
                                        + _column(plain_bias, y.dtype)), 2)
    return out_bn, out_plain


def _launch_on(t: torch.Tensor):
    index = t.device.index
    return (contextlib.nullcontext() if index == torch.cuda.current_device()
            else torch.cuda.device(index))


def _kernel_input(y: torch.Tensor, params: torch.Tensor, name: str) -> torch.Tensor:
    """``y`` as the kernel reads it, NCHW: a conv output in another layout
    (cuDNN keeps a channels-last input's, as the saliency stage's permuted
    frames give it) is copied to it first. Raises unless y is 16-byte
    aligned and its constants contiguous float32 on y's card."""
    y = y.contiguous()
    if params.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 constants, got {params.dtype}")
    if not params.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: want 16-byte aligned NCHW and contiguous constants")
    if params.device != y.device:
        raise ValueError(f"{name}: the constants lie on {params.device}, not {y.device}")
    return y


def _width(t: torch.Tensor | None, want: int, what: str, name: str) -> None:
    if t is None or t.shape != (want,):
        raise ValueError(f"{name}: want a ({want},) {what}, got "
                         f"{None if t is None else tuple(t.shape)}")


def pool_epilogue(y: torch.Tensor, bias: torch.Tensor, bn: nn.BatchNorm2d | None = None,
                  tail_bias: torch.Tensor | None = None, *, relu: bool = True,
                  cache: dict | None = None):
    """(out_bn (B, N, H/2, W/2), out_plain (B, C − N, H/2, W/2)) of the conv
    output ``y`` (B, C, H, W), H even and W a multiple of 8, N the channels
    of ``bn`` (0 without one). The first N: ``+ bias``, eval BatchNorm, the
    2×2 max, ReLU if ``relu``. The others: ``+ bias`` (``tail_bias`` when
    there is a ``bn``), ReLU, the 2×2 max. ``cache``: where the BN constants
    are kept with the frozen weights (:func:`pool_params`; the encoder's
    ``epilogue_cache``); without one they are built each call.

    One launch of the kernel where :func:`fused` holds, else
    :func:`pool_epilogue_reference`."""
    name = "pool_epilogue"
    if y.dim() != 4:
        raise ValueError(f"{name}: want a (B, C, H, W) conv output, got {tuple(y.shape)}")
    b, c, h, w = y.shape
    n = 0 if bn is None else bn.num_features
    if n > c or h % 2 or w % 8:
        raise ValueError(f"{name}: want BN channels <= C, H even and W % 8 == 0, got "
                         f"{n} BN channels, {tuple(y.shape)}")
    _width(bias, n or c, "bias", name)
    if bn is not None and n < c:
        _width(tail_bias, c - n, "tail bias", name)
    with span():
        if not fused(y):
            return pool_epilogue_reference(y, bias, bn, tail_bias, relu)
        params = bias if bn is None else pool_params({} if cache is None else cache, bias, bn,
                                                     tail_bias)
        return _pool_kernel(y, params, n, relu)


def _pool_kernel(y: torch.Tensor, params: torch.Tensor, n: int, relu: bool):
    """One launch of ``block_epilogue_pool``: ``params`` the (C,) bias when
    ``n`` is 0, else :func:`pool_params`' rows."""
    y = _kernel_input(y, params, "pool_epilogue")
    b, c, h, w = y.shape
    out_bn = torch.empty((b, n, h // 2, w // 2), dtype=y.dtype, device=y.device)
    out_plain = torch.empty((b, c - n, h // 2, w // 2), dtype=y.dtype, device=y.device)
    with _launch_on(y):
        status = kb.library().cvt_block_epilogue_pool(
            y.data_ptr(), b, c, h, w, params.data_ptr(), n, int(relu), out_bn.data_ptr(),
            out_plain.data_ptr(), torch._C._cuda_getCurrentRawStream(y.device.index))
    kb.check(status, "block_epilogue")
    kb.LAUNCHES["block_epilogue"] += 1
    return out_bn, out_plain


def shuffle_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain version of :func:`shuffle_epilogue`: ``ops/upconv.py``'s
    interleave, ``+ bias`` (cast to y's dtype) and the decoder's ReLU."""
    x = F.pixel_shuffle(y, 2) + _column(bias, y.dtype)
    return F.relu(x) if relu else x


def shuffle_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """The (B, C, 2H, 2W) ``F.pixel_shuffle(y, 2) + bias``, ReLU if ``relu``,
    of a phase conv output ``y`` (B, 4C, H, W) with W a multiple of 4.

    One launch of the kernel where :func:`fused` holds, else
    :func:`shuffle_epilogue_reference`."""
    name = "shuffle_epilogue"
    if y.dim() != 4 or y.shape[1] % 4 or y.shape[3] % 4:
        raise ValueError(f"{name}: want a (B, 4C, H, W) phase conv output with W % 4 == 0, "
                         f"got {tuple(y.shape)}")
    _width(bias, y.shape[1] // 4, "bias", name)
    with span():
        if not fused(y):
            return shuffle_epilogue_reference(y, bias, relu)
        return _shuffle_kernel(y, bias, relu)


def _shuffle_kernel(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """One launch of ``block_epilogue_shuffle``."""
    y = _kernel_input(y, bias, "shuffle_epilogue")
    b, c4, h, w = y.shape
    out = torch.empty((b, c4 // 4, 2 * h, 2 * w), dtype=y.dtype, device=y.device)
    with _launch_on(y):
        status = kb.library().cvt_block_epilogue_shuffle(
            y.data_ptr(), b, c4 // 4, h, w, bias.data_ptr(), int(relu), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(y.device.index))
    kb.check(status, "block_epilogue")
    kb.LAUNCHES["block_epilogue"] += 1
    return out
