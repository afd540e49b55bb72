"""Kernel B2: the device CRF's bilateral kernel and its normalizers.

Counterpart of critic_vae_tpu/crf/fused_build.py::build_bilateral. Per frame
of N = H*W pixels, with features (x, y)/alpha and rgb/beta:

    K[i,j] = exp(-1/2 |dxy|^2 - 1/2 |drgb|^2) for i != j, exactly 0 on i == j
    g_i    = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)

The JAX package stores the normalized M[i,j] = (g_i * g_j) * K[i,j]; B2
stores K and g (:class:`BilateralPair`), and the mean field applies g to its
vector, M @ q = g * (K @ (g * q)), so that K's store need not wait for g.

The CUDA kernel is ``csrc/bilateral_build.cu``;
:func:`build_bilateral_reference` is its plain version. Both take the
differences per coordinate (never a Gram product), so the diagonal's
exponent is exactly 0 and the ``logp < 0`` predicate excludes it; the JAX
package's Gram form (``_normalized_kernel``) carries ~1e-3 relative error in
the exponent and is not what either version computes.

K computed so is bitwise symmetric, and the kernel exploits it: the
symmetric-tile build (``csrc/bilateral_tile.cuh``, shared with B5) computes
each distinct entry once for K[I, J] and K[J, I] of a pair of ``TILE``-pixel
tiles, in the same pass adds it into per-tile row partials in
``row_sum_slots(N)`` fixed slots, and sums those in slot order into g.

The int8 build (``build="int8"``) has two more kernels on the same K:

* B3 :func:`build_kernel_i8` (``csrc/kernel_i8_build.cu``): one pass of
  the same symmetric-tile build stores int8 ``round(127 k)`` of the
  unnormalized kernel for K8[I, J] and K8[J, I] of each tile pair, and
  adds the integer row partials of both halves into the f32 row sums of
  the stored values (exact: integers below 2^24);
* B4 :func:`matvec_i8` (``csrc/matvec_i8.cu``): per frame, the int8 K
  widened to bf16 times a bf16 (N, L) vector, summed in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from critic_vae_tpu_torch.crf.terms import _EPS_NORM, _coords
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.utils.profiling import span

OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_LAUNCH_FRAMES = 65535  # the kernels put frames on a grid's y or z axis
TILE = 64  # pixels a side of the symmetric build's tiles (csrc/bilateral_tile.cuh)
B2_PLANES = 6  # per-pixel planes of B2's and B3's builds: x, y, r, g, b and nb's slot,
               # which both leave unused (B2 writes its g apart)


def _f32(v, device) -> torch.Tensor:
    # a fill on the device: a tensor made on the host would be a copy that
    # waits for the stream
    return torch.full((), v, dtype=torch.float32, device=device)


def row_sum_slots(n: int) -> int:
    """Slots of the symmetric build's (C, slots, N) f32 row-sum scratch: one
    partial a ``TILE``-pixel tile of columns."""
    return -(-n // TILE)


def feature_planes(frames: int, n: int, planes: int, device) -> torch.Tensor:
    """The symmetric build's (frames, planes, N padded to whole tiles) f32
    per-pixel planes: the 5 bilateral features, nb, the entry's own."""
    return torch.empty((frames, planes, row_sum_slots(n) * TILE), dtype=torch.float32,
                       device=device)


def build_scratch(frames: int, n: int, planes: int, device) -> tuple:
    """B2's and B5's scratch: the feature planes and the (frames, slots, N)
    f32 row-sum partials."""
    return (feature_planes(frames, n, planes, device),
            torch.empty((frames, row_sum_slots(n), n), dtype=torch.float32, device=device))


def bilateral_k(imgs_u8: torch.Tensor, alpha, beta, *, h: int, w: int,
                row_block: int = 512):
    """Yield (frame, K) for each of the (C, N, 3) uint8 frames: the (N, N)
    float32 unnormalized bilateral kernel, diagonal exactly 0.

    Built in blocks of ``row_block`` rows, so a 64x64 frame holds one K and
    never an (N, N, 3) difference. The plain versions of B2, B3 and B5 all
    start from it."""
    c, n, _ = imgs_u8.shape
    dev = imgs_u8.device
    pos = _coords(h, w, dev) / _f32(alpha, dev)  # (N, 2)
    col = imgs_u8.float() / _f32(beta, dev)      # (C, N, 3)
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
        yield ci, k


class BilateralPair(NamedTuple):
    """B2's bilateral term: the normalized M is ``g[:, :, None] * g[:, None,
    :] * k``, and its message ``g * (k @ (g * q))``."""

    k: torch.Tensor  # (C, N, N) unnormalized kernel in B2's out_dtype, diagonal 0
    g: torch.Tensor  # (C, N) float32: sqrt(w1) * rsqrt(sum_j k[:, i, j] + 1e-20)


def build_bilateral_reference(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int,
                              w: int, out_dtype: str = "bfloat16",
                              row_block: int = 512) -> BilateralPair:
    """Plain PyTorch version: (C, N, 3) uint8 -> the pair of the (C, N, N) K
    in ``out_dtype`` and the (C, N) float32 g."""
    c, n, _ = imgs_u8.shape
    dev = imgs_u8.device
    sqrt_w1 = torch.sqrt(_f32(w1, dev))
    out = torch.empty((c, n, n), dtype=OUT_DTYPES[out_dtype], device=dev)
    g = torch.empty((c, n), dtype=torch.float32, device=dev)
    for ci, k in bilateral_k(imgs_u8, alpha, beta, h=h, w=w, row_block=row_block):
        g[ci] = sqrt_w1 * torch.rsqrt(k.sum(dim=1) + _EPS_NORM)
        out[ci] = k.to(out.dtype)
    return BilateralPair(out, g)


def _check_frames(name: str, imgs_u8: torch.Tensor, h: int, w: int) -> None:
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 3 or imgs_u8.shape[2] != 3:
        raise ValueError(
            f"{name}: want (C, N, 3) uint8, got {tuple(imgs_u8.shape)} {imgs_u8.dtype}"
        )
    if imgs_u8.shape[1] != h * w:
        raise ValueError(f"{name}: N={imgs_u8.shape[1]} is not h*w={h}*{w}")
    if imgs_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {imgs_u8.device}")
    if imgs_u8.device.type == "cuda" and not imgs_u8.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")
    if imgs_u8.device.type == "cuda" and imgs_u8.shape[0] > MAX_LAUNCH_FRAMES:
        raise ValueError(f"{name}: {imgs_u8.shape[0]} frames > {MAX_LAUNCH_FRAMES} in one launch")


def build_bilateral(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int, w: int,
                    out_dtype: str = "bfloat16") -> BilateralPair:
    """(C, N, 3) uint8 frames -> the :class:`BilateralPair` of the (C, N, N)
    unnormalized bilateral kernels K, diag(K) = 0, stored in ``out_dtype``
    ("bfloat16" or "float32"), and their (C, N) float32 normalizers g.

    CUDA tensors launch kernel B2 (or raise); CPU tensors take the plain
    version."""
    _check_frames("build_bilateral", imgs_u8, h, w)
    c, n, _ = imgs_u8.shape
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"build_bilateral: out_dtype {out_dtype!r} (float32|bfloat16)")
    if imgs_u8.device.type == "cpu":
        return build_bilateral_reference(imgs_u8, w1, alpha, beta, h=h, w=w,
                                         out_dtype=out_dtype)
    lib = kb.library()
    dev = imgs_u8.device
    feat, part = build_scratch(c, n, B2_PLANES, dev)
    out = torch.empty((c, n, n), dtype=OUT_DTYPES[out_dtype], device=dev)
    g = torch.empty((c, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), span("bilateral_build"):
        status = lib.cvt_bilateral_build(
            imgs_u8.data_ptr(), c, n, w, float(w1), float(alpha), float(beta),
            feat.data_ptr(), part.data_ptr(), out.data_ptr(), g.data_ptr(),
            int(out_dtype == "bfloat16"), torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "bilateral_build")
    kb.LAUNCHES["bilateral_build"] += 1
    return BilateralPair(out, g)


QUANT_SCALE = 127.0  # int8 fixed scale for k in [0, 1), as the JAX package


def build_kernel_i8_reference(imgs_u8: torch.Tensor, alpha, beta, *, h: int, w: int,
                              row_block: int = 512):
    """Plain PyTorch version of :func:`build_kernel_i8`."""
    c, n, _ = imgs_u8.shape
    k8 = torch.empty((c * n, n), dtype=torch.int8, device=imgs_u8.device)
    rowsum = torch.empty((c * n, 1), dtype=torch.float32, device=imgs_u8.device)
    for ci, k in bilateral_k(imgs_u8, alpha, beta, h=h, w=w, row_block=row_block):
        rows = slice(ci * n, (ci + 1) * n)
        k8[rows] = torch.round(k * QUANT_SCALE).to(torch.int8)
        # integers < 2^24: exact in any order
        rowsum[rows] = k8[rows].sum(dim=1, keepdim=True, dtype=torch.int32).float()
    return k8, rowsum


def build_kernel_i8(imgs_u8: torch.Tensor, alpha, beta, *, h: int, w: int):
    """(C, N, 3) uint8 frames -> (K_i8 (C*N, N) int8, rowsum (C*N, 1) f32).

    K_i8 = round_half_even(127 k) of the UNNORMALIZED kernel k in [0, 1)
    (diagonal 0), and ``rowsum`` the sums of the stored values, from which
    the caller normalizes (the exactly normalized 8-bit model of the JAX
    package's ``build_kernel_i8``). K8 is bitwise symmetric; the kernel
    computes each distinct entry once and its row sums are exact, so they
    are reproducible launch to launch. CUDA tensors launch kernel B3 (N
    must divide by 16, for its 16-byte stores and for B4) or raise, with
    (C, 6, N padded to 64) f32 feature planes as scratch; CPU tensors take
    the plain version."""
    _check_frames("build_kernel_i8", imgs_u8, h, w)
    c, n, _ = imgs_u8.shape
    if imgs_u8.device.type == "cpu":
        return build_kernel_i8_reference(imgs_u8, alpha, beta, h=h, w=w)
    if n % 16:
        raise ValueError(f"build_kernel_i8: N={n} must divide by 16 on CUDA")
    lib = kb.library()
    dev = imgs_u8.device
    feat = feature_planes(c, n, B2_PLANES, dev)
    k8 = torch.empty((c * n, n), dtype=torch.int8, device=dev)
    rowsum = torch.empty((c * n, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.cvt_kernel_i8_build(
            imgs_u8.data_ptr(), c, n, w, float(alpha), float(beta), feat.data_ptr(),
            k8.data_ptr(), rowsum.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "kernel_i8_build")
    kb.LAUNCHES["kernel_i8_build"] += 1
    return k8, rowsum


def matvec_i8_reference(k8: torch.Tensor, y_bf16: torch.Tensor, *, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`matvec_i8` (``y`` already bf16)."""
    c = k8.shape[0] // n
    k = k8.view(c, n, n).float()  # int8 -> f32 is exact, as int8 -> bf16
    return torch.bmm(k, y_bf16.float().view(c, n, -1)).view(c * n, -1)


def matvec_i8(k8: torch.Tensor, y: torch.Tensor, *, n: int) -> torch.Tensor:
    """Per-frame matvec of the quantized kernel, (C*N, N) int8 x (C*N, L) ->
    (C*N, L) f32:  out[f*N + i] = sum_j K_i8[f*N + i, j] * bf16(y[f*N + j]).

    ``y`` is cast to bf16 first, as the JAX package does; the sum is f32.
    CUDA tensors launch kernel B4 (N must divide by 16) or raise; CPU
    tensors take the plain version."""
    if k8.dtype != torch.int8 or k8.dim() != 2 or k8.shape[1] != n or k8.shape[0] % n:
        raise ValueError(f"matvec_i8: want (C*N, N={n}) int8, got {tuple(k8.shape)} {k8.dtype}")
    if y.dim() != 2 or y.shape[0] != k8.shape[0]:
        raise ValueError(f"matvec_i8: y {tuple(y.shape)} does not match K {tuple(k8.shape)}")
    if y.device != k8.device:
        raise ValueError(f"matvec_i8: K on {k8.device}, y on {y.device}")
    yb = y.to(torch.bfloat16)
    if k8.device.type == "cpu":
        return matvec_i8_reference(k8, yb, n=n)
    if k8.device.type != "cuda":
        raise ValueError(f"matvec_i8: unsupported device {k8.device}")
    if n % 16 or k8.shape[0] // n > MAX_LAUNCH_FRAMES:
        raise ValueError(f"matvec_i8: N={n} must divide by 16 and C by at most "
                         f"{MAX_LAUNCH_FRAMES} on CUDA")
    if not k8.is_contiguous() or k8.data_ptr() % 16:
        raise ValueError("matvec_i8: K must be contiguous and 16-byte aligned")
    yb = yb.contiguous()
    cn, lanes = yb.shape
    lib = kb.library()
    out = torch.empty((cn, lanes), dtype=torch.float32, device=k8.device)
    with torch.cuda.device(k8.device):
        status = lib.cvt_matvec_i8(
            k8.data_ptr(), yb.data_ptr(), cn // n, n, lanes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "matvec_i8")
    kb.LAUNCHES["matvec_i8"] += 1
    return out
