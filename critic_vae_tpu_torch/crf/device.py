"""Exact dense-CRF mean-field on the device (counterpart of
critic_vae_tpu/crf/device.py, mask-refinement paths).

Per frame of N = H*W pixels the bilateral term is the full N x N matrix M
built by kernel B2 (crf/fused_build.py); the spatial term
exp(-(dx^2+dy^2)/2 gamma^2) is exactly separable, so its message is a
truncated separable Gaussian depthwise conv. Messages run over j != i:

    Q <- softmax(-U + M @ Q + w2 * n_s * (K_s @ (n_s * Q)))   x iters
    seg = argmax Q

with U = -log(clamp(prob, 1e-8)) and Q0 = softmax(-U). Frames go in padded
fixed-size chunks; the chunk's M stack is the only N^2 temporary.

Builds (``_resolve_build``): ``auto``/``pallas`` is B2 as above; ``int8``
stores the unnormalized kernel as int8 (B3) and runs each iteration's
bilateral message as an int8 matvec (B4); ``vmem`` runs the whole mean
field, spatial term folded into one bf16 matrix, in kernel B5
(crf/fused_resident.py). ``refine_masks_multi_device`` refines T mask sets
of the same frames against one matrix, packed as T*L lanes of Q (the
threshold sweep).

The M @ Q message accumulates in float32 whatever M's storage dtype, as the
JAX package's ``preferred_element_type=f32`` does. For a bf16 M on CUDA that
is ``torch.bmm(M, Q_bf16, torch.float32)`` — the ``out_dtype`` overload of
``bmm``, which PyTorch documents for float32 output from bf16 operands on
CUDA only. A plain bf16 ``bmm`` would round the messages to bf16. On the CPU
the same product is ``bmm`` of the bf16 values widened to float32 (bf16
products are exact in float32).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS

_EPS_PROB = 1e-8   # unary clamp, as densecrf.cpp
_EPS_NORM = 1e-20  # normalizer epsilon, as densecrf.cpp

# Per-chunk budget for the N^2 workspaces, in bytes; MEM_ENV overrides it,
# as in the JAX package (its crf/device.py _run_chunked). The JAX package
# sized the default for a 16 GB TPU chip; kept as is until it is measured on
# the 80 GB H100 (ROADMAP A.7). At 64x64 it allows 95 f32, 190 bf16 or 381
# int8 frames, above the default chunk of 64.
_MEM_BUDGET = 6 * 1024**3
MEM_ENV = "CRITIC_VAE_TPU_CRF_MEM"

# the JAX package's build override (its crf/device.py _resolve_build)
BUILD_ENV = "CRITIC_VAE_TPU_CRF_BUILD"


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


def _spatial_norm(taps: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 1) n_s = rsqrt(sum_{j != i} K_s[i, j] + 1e-20) on ``taps``'
    device, in float32. The separable conv of ones at (y, x) is the sum of
    the taps inside the frame along y times that along x, taken here in
    closed form (no conv, so no TF32 on a card); it includes the centre tap
    (weight 1), which the -1 takes back out. The same for every frame."""
    taps = taps.float()
    r = taps.shape[0] // 2
    offs = torch.arange(-r, r + 1, device=taps.device)

    def inside(size):
        pos = torch.arange(size, device=taps.device)[:, None] + offs[None, :]
        return torch.where((pos >= 0) & (pos < size), taps, 0.0).sum(dim=1)

    ones_conv = inside(h)[:, None] * inside(w)[None, :]
    return torch.rsqrt(ones_conv.reshape(h * w, 1) - 1.0 + _EPS_NORM)


def _spatial_message(q: torch.Tensor, ns: torch.Tensor, taps: torch.Tensor, h: int,
                     w: int) -> torch.Tensor:
    """n_s * (K_s @ (n_s * q)) over j != i for (C, N, L) q, as a separable
    conv of the lanes' images less the centre tap."""
    c, n, lanes = q.shape
    y = ns * q
    y_img = y.view(c, h, w, lanes).permute(0, 3, 1, 2)
    sp = _sep_conv(y_img, taps).permute(0, 2, 3, 1).reshape(c, n, lanes) - y
    return ns * sp


def _message(mb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M @ Q with float32 accumulation and output (see the module note)."""
    if mb.dtype == torch.float32:
        return torch.bmm(mb, q)
    qm = q.to(mb.dtype)
    if mb.is_cuda:
        return torch.bmm(mb, qm, torch.float32)
    return torch.bmm(mb.float(), qm.float())


def _mean_field_iterate_multi(mb: torch.Tensor, probs: torch.Tensor, taps: torch.Tensor,
                              w2, h: int, w: int, iters: int) -> torch.Tensor:
    """T independent mean fields over the chunk's bilateral matrices ``mb``
    (C, N, N), packed into the lanes of Q: (C, N, T, L) probabilities ->
    (C, T, N) uint8 argmax labels. M is read once an iteration for all T."""
    c, n, t, L = probs.shape
    ns = _spatial_norm(taps, h, w)
    unary = -torch.log(torch.clamp_min(probs, _EPS_PROB))
    q = torch.softmax(-unary, dim=-1)
    for _ in range(iters):
        qf = q.reshape(c, n, t * L)
        msg = _message(mb, qf) + w2 * _spatial_message(qf, ns, taps, h, w)
        q = torch.softmax(msg.view(c, n, t, L) - unary, dim=-1)
    return torch.argmax(q, dim=-1).to(torch.uint8).transpose(1, 2)


def _chunk_mean_field_i8(imgs_u8: torch.Tensor, probs: torch.Tensor, taps: torch.Tensor,
                         w1, w2, alpha, beta, h: int, w: int, iters: int) -> torch.Tensor:
    """The int8 chunk body: kernel B3 stores the unnormalized kernel as
    int8 (scale 127) with the row sums of the stored values, and each
    iteration's bilateral message is kernel B4's int8 matvec with the
    normalizers folded into the vector,

        M @ q = g * (K_i8 @ (g * q)),  g = sqrt(w1/127) rsqrt(rowsum/127 + eps)

    the exactly normalized 8-bit model. (C, N, L) probabilities -> (C, N)
    uint8 labels."""
    from critic_vae_tpu_torch.crf.fused_build import QUANT_SCALE, build_kernel_i8, matvec_i8

    c, n, L = probs.shape
    k8, rowsum = build_kernel_i8(imgs_u8, alpha, beta, h=h, w=w)
    w1_t = torch.tensor(w1, dtype=torch.float32, device=probs.device)
    g = (torch.sqrt(w1_t / QUANT_SCALE)
         * torch.rsqrt(rowsum / QUANT_SCALE + _EPS_NORM)).view(c, n, 1)
    ns = _spatial_norm(taps, h, w)
    unary = -torch.log(torch.clamp_min(probs, _EPS_PROB))
    q = torch.softmax(-unary, dim=-1)
    for _ in range(iters):
        msg = g * matvec_i8(k8, (g * q).view(c * n, L), n=n).view(c, n, L)
        msg = msg + w2 * _spatial_message(q, ns, taps, h, w)
        q = torch.softmax(msg - unary, dim=-1)
    return torch.argmax(q, dim=-1).to(torch.uint8)


def _mask_probs(masks_u8: torch.Tensor) -> torch.Tensor:
    """0/1 masks -> the stacked (1 - mask, mask) class planes, last axis."""
    m = masks_u8.float()
    return torch.stack([1.0 - m, m], dim=-1)


def _crf_chunk_from_masks(imgs_u8: torch.Tensor, masks_u8: torch.Tensor,
                          taps: torch.Tensor, w1, w2, alpha, beta, gamma, *, h: int,
                          w: int, iters: int, compute_dtype: str,
                          fused: str) -> torch.Tensor:
    """One chunk through the resolved build ``fused``: (C, N, 3) uint8 frames
    and (C, N, T) 0/1 mask sets -> (C, T, N) uint8 labels, all T against one
    bilateral build. A (C, N) single mask gives (C, N) labels; with ``int8``
    it runs B3 and B4, while many masks take B2 in bf16, as the JAX package
    does: the lane-packed product wants a plain M operand."""
    if masks_u8.dim() == 2:
        if fused == "int8":
            return _chunk_mean_field_i8(imgs_u8, _mask_probs(masks_u8), taps, w1, w2,
                                        alpha, beta, h, w, iters)
        return _crf_chunk_from_masks(imgs_u8, masks_u8[..., None], taps, w1, w2, alpha,
                                     beta, gamma, h=h, w=w, iters=iters,
                                     compute_dtype=compute_dtype, fused=fused)[:, 0]
    probs = _mask_probs(masks_u8)  # (C, N, T, 2)
    c, n, t, _ = probs.shape
    if fused == "vmem":
        from critic_vae_tpu_torch.crf.fused_resident import mean_field_resident

        q = mean_field_resident(imgs_u8, probs.reshape(c, n, 2 * t), taps, w1, w2, alpha,
                                beta, gamma, h=h, w=w, iters=iters).view(c, n, t, 2)
        return (q[..., 1] > q[..., 0]).to(torch.uint8).transpose(1, 2)
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral

    dt = "bfloat16" if fused == "int8" else compute_dtype
    mb = build_bilateral(imgs_u8, w1, alpha, beta, h=h, w=w, out_dtype=dt)
    return _mean_field_iterate_multi(mb, probs, taps, w2, h, w, iters)


def _resolve_build(build: str, h: int, w: int) -> str:
    """Resolve a build to "pallas" | "int8" | "vmem" for h x w frames.

    * ``auto``/``pallas``: kernel B2 (crf/fused_build.build_bilateral);
    * ``int8``: kernels B3 and B4 (single mask; B2 in bf16 for many);
    * ``vmem``: kernel B5 (crf/fused_resident.mean_field_resident).

    ``CRITIC_VAE_TPU_CRF_BUILD`` overrides ``build``, as in the JAX package;
    every value routes to a kernel on a CUDA tensor (the plain versions run
    only for CPU tensors). ``int8`` and ``vmem`` keep the JAX package's TPU
    limits for parity (ROADMAP C): H*W divisible by 128, and for ``vmem``
    H*W <= MAX_RESIDENT_N. The Gram-form ``xla`` build is not ported.

    A known deviation (ROADMAP C.3): at H*W % 128 != 0 the JAX package
    raises for ``pallas`` and runs its float32 ``xla`` build for ``auto``;
    here both take B2, in bf16 on CUDA, so the masks at such sizes (20x20
    crops, say) differ from the JAX default's. It resolves as the JAX
    package does once the ``xla`` build is ported (ROADMAP A.7)."""
    from critic_vae_tpu_torch.crf.fused_resident import MAX_RESIDENT_N

    build = os.environ.get(BUILD_ENV, build)
    if build == "xla":
        raise NotImplementedError(
            "build='xla': the Gram-form build is not ported yet (ROADMAP A.7)"
        )
    if build in ("auto", "pallas"):
        return "pallas"
    if build in ("int8", "vmem"):
        if (h * w) % 128:
            raise ValueError(f"build={build!r} needs H*W divisible by 128, got {h}x{w}")
        if build == "vmem" and h * w > MAX_RESIDENT_N:
            raise ValueError(
                f"build='vmem' needs H*W <= {MAX_RESIDENT_N}, got {h}x{w} — use 'pallas'"
            )
        return build
    raise ValueError(f"unknown build {build!r} (auto|pallas|int8|vmem)")


def _chunk_frames(frame_chunk: int, fused: str, multi: bool, compute_dtype: str,
                  npix: int, lanes: int) -> int:
    """Frames per chunk: at most ``frame_chunk`` (and at least 1) whose N^2
    workspace fits the budget (``CRITIC_VAE_TPU_CRF_MEM`` bytes, default 6
    GiB). Per frame that is the int8 K (``int8``, one mask), M in bf16
    (``int8`` with many masks) or in ``compute_dtype``, or for ``vmem``
    kernel B5's workspace (fused_resident.workspace_bytes)."""
    if fused == "vmem":
        from critic_vae_tpu_torch.crf.fused_resident import workspace_bytes

        frame_bytes = workspace_bytes(1, npix, lanes)
    elif fused == "int8" and not multi:
        frame_bytes = npix * npix
    elif fused == "int8" or compute_dtype == "bfloat16":
        frame_bytes = 2 * npix * npix
    else:
        frame_bytes = 4 * npix * npix
    budget = int(os.environ.get(MEM_ENV, _MEM_BUDGET))
    return max(1, min(frame_chunk, budget // frame_bytes))


def _run_chunked(flat_imgs: torch.Tensor, flat_masks: torch.Tensor, params, h: int,
                 w: int, frame_chunk: int, compute_dtype: str, *, build: str = "auto",
                 fetch: bool = True):
    """Refine (n, N, 3) frames with (n, N) masks, or (n, N, T) mask sets, in
    fixed-size chunks padded by repeating the last frame. Returns (n, N) or
    (n, T, N) uint8 labels, as numpy with ``fetch`` or as a device tensor
    without."""
    w1, alpha, beta, w2, gamma, iters = params
    fused = _resolve_build(build, h, w)
    multi = flat_masks.dim() == 3
    n, npix = flat_imgs.shape[0], h * w
    if n == 0:
        shape = (0, flat_masks.shape[2], npix) if multi else (0, npix)
        out = torch.empty(shape, dtype=torch.uint8, device=flat_imgs.device)
        return out.cpu().numpy() if fetch else out
    taps = torch.from_numpy(_spatial_taps(float(gamma), h, w)).to(flat_imgs.device)
    lanes = 2 * (flat_masks.shape[2] if multi else 1)
    frame_chunk = _chunk_frames(min(frame_chunk, n), fused, multi, compute_dtype, npix, lanes)
    segs = []
    for i in range(0, n, frame_chunk):
        imgs = flat_imgs[i : i + frame_chunk]
        masks = flat_masks[i : i + frame_chunk]
        valid = imgs.shape[0]
        if valid < frame_chunk:
            pad = frame_chunk - valid
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            masks = torch.cat([masks, masks[-1:].expand(pad, *masks.shape[1:])])
        seg = _crf_chunk_from_masks(imgs.contiguous(), masks, taps, w1, w2, alpha, beta,
                                    gamma, h=h, w=w, iters=int(iters),
                                    compute_dtype=compute_dtype, fused=fused)
        segs.append(seg[:valid])
    out = torch.cat(segs) if len(segs) > 1 else segs[0]
    return out.cpu().numpy() if fetch else out


def _frames_on(frames_u8, device, name: str):
    if device is None:
        if not isinstance(frames_u8, torch.Tensor):
            raise ValueError(f"{name}: numpy inputs need an explicit device")
        device = frames_u8.device
    device = torch.device(device)
    frames = torch.as_tensor(frames_u8, device=device)
    if frames.dtype != torch.uint8:
        raise TypeError(f"{name}: frames must be uint8, got {frames.dtype}")
    return frames, device


@torch.inference_mode()
def refine_masks_device(frames_u8, thr_masks, params: Tuple = REFERENCE_CRF_PARAMS, *,
                        frame_chunk: int = 64, compute_dtype: str = "auto",
                        build: str = "auto", fetch: bool = True, device=None):
    """Refine (n, H, W) threshold masks of (n, H, W, 3) uint8 frames with the
    exact dense CRF; returns (n, H, W) bool, as numpy with ``fetch`` or as a
    tensor on the device without.

    Tensors are used where they lie; numpy inputs need ``device``.
    ``compute_dtype="auto"`` stores B2's M in bf16 on CUDA (the kernel's
    fast path; held to >= 99.9% segmentation agreement with float32) and
    float32 on the CPU; ``int8`` and ``vmem`` fix their own storage. At
    H*W % 128 != 0 ``auto`` and ``pallas`` both run B2, where the JAX
    package runs its ``xla`` build or raises (:func:`_resolve_build`)."""
    frames, device = _frames_on(frames_u8, device, "refine_masks_device")
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


@torch.inference_mode()
def refine_masks_multi_device(frames_u8, thr_masks_multi,
                              params: Tuple = REFERENCE_CRF_PARAMS, *,
                              frame_chunk: int = 64, compute_dtype: str = "auto",
                              build: str = "auto", fetch: bool = True, device=None):
    """Refine T mask sets of the same frames in one pass (the threshold
    sweep): (F, H, W, 3) uint8 frames and (T, F, H, W) 0/1 masks -> (T, F,
    H, W) bool, as numpy with ``fetch`` or on the device without. Each set
    agrees with ``refine_masks_device(frames, thr_masks_multi[t])``; all T
    share one bilateral build and one read of it per iteration.

    Inputs are used where they lie, as in :func:`refine_masks_device`."""
    frames, device = _frames_on(frames_u8, device, "refine_masks_multi_device")
    f, h, w_, _ = frames.shape
    t = thr_masks_multi.shape[0]
    if tuple(thr_masks_multi.shape) != (t, f, h, w_):
        raise ValueError(
            f"thr_masks_multi shape {tuple(thr_masks_multi.shape)} does not match "
            f"(T, {f}, {h}, {w_})"
        )
    # frame-major, so _run_chunked slices and pads along frames
    masks = (torch.as_tensor(thr_masks_multi, device=device).to(torch.uint8)
             .permute(1, 2, 3, 0).reshape(f, h * w_, t))
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if device.type == "cuda" else "float32"
    out = _run_chunked(
        frames.reshape(f, h * w_, 3), masks, params, h, w_, frame_chunk,
        compute_dtype, build=build, fetch=fetch,
    )  # (F, T, N)
    if fetch:
        return out.transpose(1, 0, 2).reshape(t, f, h, w_).astype(bool)
    return out.transpose(0, 1).reshape(t, f, h, w_).bool()
