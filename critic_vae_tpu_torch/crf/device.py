"""Exact dense-CRF mean-field on the device (counterpart of
critic_vae_tpu/crf/device.py).

Per frame of N = H*W pixels the bilateral term is the full N x N matrix M
built by kernel B2 (crf/fused_build.py) or by the Gram form (``xla``); the
spatial term
exp(-(dx^2+dy^2)/2 gamma^2) is exactly separable, so its message is a
truncated separable Gaussian depthwise conv. Messages run over j != i:

    Q <- softmax(-U + M @ Q + w2 * n_s * (K_s @ (n_s * Q)))   x iters
    seg = argmax Q

with U = -log(clamp(prob, 1e-8)) and Q0 = softmax(-U). Frames go in padded
fixed-size chunks; the chunk's M stack is the only N^2 temporary.

Builds (``_resolve_build``): ``pallas`` is B2 as above; ``xla`` builds M
from Gram products in float32 with plain ops (:func:`_normalized_kernel`);
``int8`` stores the unnormalized kernel as int8 (B3) and runs each
iteration's bilateral message as an int8 matvec (B4); ``vmem`` runs the
whole mean field, spatial term folded into one bf16 matrix, in kernel B5
(crf/fused_resident.py). ``auto`` is ``pallas`` on a CUDA tensor when H*W
divides by 128, else ``xla``, as the JAX package resolves it with the TPU
in the card's place. ``refine_masks_multi_device`` refines T mask sets
of the same frames against one matrix, packed as T*L lanes of Q (the
threshold sweep). ``densecrf_device`` refines any (n, H, W, L)
probabilities, returning labels or with ``soft`` the marginals, through
every build; ``crf_param_search`` refines the same masks once for each
combination of a parameter grid and scores each by IoU counted on the card.
Each takes ``mesh=`` (parallel/mesh.py): the chunk is rounded up to a
multiple of the mesh's ranks, each rank refines its rows of every chunk
(the JAX package's ``_meshed_dispatch``: frames are independent, so no
collective but the gather), and the rows are gathered so that every rank
holds the whole result.

The M @ Q message accumulates in float32 whatever M's storage dtype, as the
JAX package's ``preferred_element_type=f32`` does. For a bf16 M on CUDA each
iteration is one launch of kernel ``mean_field_step``
(crf/mean_field_step.py): the product on the tensor cores, the spatial
message in float32 and the softmax in its epilogue. Elsewhere it is the
composition :func:`_mean_field_loop`: for a float32 M ``torch.bmm``; for a
bf16 M on the CPU ``bmm`` of the bf16 values widened to float32 (bf16
products are exact in float32), and on CUDA, where a ragged N leaves the
kernel, ``torch.bmm(M, Q_bf16, torch.float32)``, the ``out_dtype`` overload
that PyTorch documents for float32 output from bf16 operands on CUDA only
(a plain bf16 ``bmm`` would round the messages to bf16).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.ops.mask import iou_counts, ious_from_counts
from critic_vae_tpu_torch.utils.profiling import span

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


def _fma_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] of float32 operands as a float32 FMA chain:
    each product exact in float64, each partial sum rounded to float32 once,
    which is how XLA:CPU accumulates the JAX package's Gram dot and its
    norms (bitwise equal on the CPU). Elementwise, so no TF32 setting of a
    caller can round it on a card."""
    acc = (a[..., 0].double() * b[..., 0].double()).float()
    for k in range(1, a.shape[-1]):
        acc = (acc.double() + a[..., k].double() * b[..., k].double()).float()
    return acc


def _half_sqdist(feats: torch.Tensor) -> torch.Tensor:
    """-1/2 ||f_i - f_j||^2 of (N, d) float32 features by the Gram form,
    clamped to <= 0, as the JAX package's ``_half_sqdist``, whose Gram runs
    at ``Precision.HIGHEST``: with colour norms of ~2e4 the form cancels to
    ~1e-3 of logk even in float32, and a TF32 Gram (~1e-3 relative on its
    operands) would move logk by tens and break the diagonal's
    cancellation."""
    sq = _fma_products(feats, feats)
    gram = _fma_products(feats[:, None, :], feats[None, :, :])
    return torch.clamp_max(gram - 0.5 * (sq[:, None] + sq[None, :]), 0.0)


def _normalized_kernel(pos: torch.Tensor, extra: torch.Tensor | None, weight,
                       dtype: torch.dtype, diag_margin: float = 0.0) -> torch.Tensor:
    """weight * (n n^T) * K over j != i with n = rsqrt(K @ 1 + eps), from
    positional features ``pos`` and optional ``extra`` (the JAX package's
    ``_normalized_kernel``). The diagonal is dropped by the margin predicate
    ``logp < -diag_margin``: distinct pixels differ in position, so their
    positional half-distance is at most -(1 px / scale)^2 / 2, while at i =
    j it is ~0 up to float noise. A bare ``< 0`` is unsafe: XLA:CPU once
    gave logp[i, i] = -2.4e-7, which leaked k_ii = 1 into the row's
    normaliser."""
    logp = _half_sqdist(pos)
    logk = logp if extra is None else logp + _half_sqdist(extra)
    k = torch.where(logp < -diag_margin, torch.exp(logk), 0.0)
    n = torch.rsqrt(torch.sum(k, dim=-1) + _EPS_NORM)
    return (weight * (n[:, None] * n[None, :]) * k).to(dtype)


def build_bilateral_xla(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int, w: int,
                        out_dtype: str = "float32") -> torch.Tensor:
    """The ``xla`` build: (C, N, 3) uint8 frames -> (C, N, N) M in
    ``out_dtype``, each frame by :func:`_normalized_kernel` on the features
    (x, y)/alpha and rgb/beta (densecrf.cpp's order) with the margin
    (1 px / alpha)^2 / 4, as the JAX package's ``_mean_field_frame``. One
    frame at a time, so the float32 temporaries stay a few N^2."""
    c, n, _ = imgs_u8.shape
    xy = _coords(h, w, imgs_u8.device) / float(alpha)
    margin = 0.25 / (float(alpha) * float(alpha))
    out = torch.empty((c, n, n), dtype=getattr(torch, out_dtype), device=imgs_u8.device)
    for i in range(c):
        out[i] = _normalized_kernel(xy, imgs_u8[i].float() / float(beta), w1, out.dtype,
                                    diag_margin=margin)
    return out


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


def _fused_step(mb: torch.Tensor) -> bool:
    """Whether the mean field over ``mb`` runs as kernel ``mean_field_step``:
    a bf16 M on the card whose rows are whole 16-byte chunks (N % 8 == 0, as
    the kernel's copies want; the ``pallas`` build's M, at H*W % 128 == 0,
    always is). CPU tensors and a float32 M run :func:`_mean_field_loop`."""
    return mb.is_cuda and mb.dtype == torch.bfloat16 and mb.shape[-1] % 8 == 0


def _mean_field_loop(mb: torch.Tensor, q: torch.Tensor, unary: torch.Tensor,
                     ns: torch.Tensor, taps: torch.Tensor, w2, h: int, w: int,
                     iters: int) -> torch.Tensor:
    """The mean field as the composition of :func:`_message`,
    :func:`_spatial_message` and the softmax: (C, N, T, L) q and unaries ->
    (C, N, T, L) float32 marginals."""
    c, n, t, L = q.shape
    for _ in range(iters):
        qf = q.reshape(c, n, t * L)
        msg = _message(mb, qf) + w2 * _spatial_message(qf, ns, taps, h, w)
        q = torch.softmax(msg.view(c, n, t, L) - unary, dim=-1)
    return q


def _mean_field_q(mb: torch.Tensor, probs: torch.Tensor, taps: torch.Tensor, w2, h: int,
                  w: int, iters: int) -> torch.Tensor:
    """T independent mean fields over the chunk's bilateral matrices ``mb``
    (C, N, N), packed into the lanes of Q: (C, N, T, L) probabilities ->
    (C, N, T, L) float32 marginals. M is read once an iteration for all T:
    by kernel ``mean_field_step`` where :func:`_fused_step` says so, else by
    :func:`_mean_field_loop`."""
    c, n, t, L = probs.shape
    ns = _spatial_norm(taps, h, w)
    unary = -torch.log(torch.clamp_min(probs, _EPS_PROB))
    q = torch.softmax(-unary, dim=-1)
    with span("crf.mean_field"):
        if not _fused_step(mb):
            return _mean_field_loop(mb, q, unary, ns, taps, w2, h, w, iters)
        from critic_vae_tpu_torch.crf.mean_field_step import mean_field_steps

        out = mean_field_steps(mb, q.reshape(c, n, t * L), unary.reshape(c, n, t * L), ns,
                               taps, w2, h=h, w=w, classes=L, iters=iters)
        return out.view(c, n, t, L)


def _labels(q: torch.Tensor) -> torch.Tensor:
    """Argmax labels of marginals along the last axis, uint8."""
    return torch.argmax(q, dim=-1).to(torch.uint8)


def _chunk_mean_field_i8(imgs_u8: torch.Tensor, probs: torch.Tensor, taps: torch.Tensor,
                         w1, w2, alpha, beta, h: int, w: int, iters: int,
                         soft: bool = False) -> torch.Tensor:
    """The int8 chunk body: kernel B3 stores the unnormalized kernel as
    int8 (scale 127) with the row sums of the stored values, and each
    iteration's bilateral message is kernel B4's int8 matvec with the
    normalizers folded into the vector,

        M @ q = g * (K_i8 @ (g * q)),  g = sqrt(w1/127) rsqrt(rowsum/127 + eps)

    the exactly normalized 8-bit model. (C, N, L) probabilities, any L ->
    (C, N) uint8 labels, or the (C, N, L) marginals with ``soft``."""
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
    return q if soft else _labels(q)


def _chunk_mean_field(imgs_u8: torch.Tensor, probs: torch.Tensor, taps: torch.Tensor, w1,
                      w2, alpha, beta, gamma, *, h: int, w: int, iters: int,
                      compute_dtype: str, soft: bool, fused: str) -> torch.Tensor:
    """The chunk body of one set of probabilities, as the JAX package's
    ``_chunk_mean_field``: (C, N, 3) uint8 frames and (C, N, L) float32
    probabilities -> (C, N) uint8 labels, or the (C, N, L) float32 marginals
    with ``soft``, through the resolved build ``fused``: ``vmem`` (B5) at L
    = 2 and ``pallas`` otherwise, ``int8`` (B3 + B4, any L), ``pallas`` (B2
    in ``compute_dtype``) or ``xla``."""
    if fused == "vmem" and probs.shape[-1] == 2:
        from critic_vae_tpu_torch.crf.fused_resident import mean_field_resident

        q = mean_field_resident(imgs_u8, probs, taps, w1, w2, alpha, beta, gamma, h=h, w=w,
                                iters=iters)
        return q if soft else (q[..., 1] > q[..., 0]).to(torch.uint8)
    if fused == "int8":
        return _chunk_mean_field_i8(imgs_u8, probs, taps, w1, w2, alpha, beta, h, w, iters,
                                    soft)
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral

    # pallas, and vmem at L != 2 (B5's pair softmax does not apply): B2
    build = build_bilateral_xla if fused == "xla" else build_bilateral
    with span("crf.build"):
        mb = build(imgs_u8, w1, alpha, beta, h=h, w=w, out_dtype=compute_dtype)
    q = _mean_field_q(mb, probs[:, :, None], taps, w2, h, w, iters)[:, :, 0]
    return q if soft else _labels(q)


def _mask_probs(masks_u8: torch.Tensor) -> torch.Tensor:
    """0/1 masks -> the stacked (1 - mask, mask) class planes, last axis."""
    m = masks_u8.float()
    return torch.stack([1.0 - m, m], dim=-1)


def _crf_chunk_from_masks(imgs_u8: torch.Tensor, masks_u8: torch.Tensor,
                          taps: torch.Tensor, w1, w2, alpha, beta, gamma, *, h: int,
                          w: int, iters: int, compute_dtype: str,
                          fused: str) -> torch.Tensor:
    """One chunk of masks through the resolved build ``fused``: (C, N, 3)
    uint8 frames and (C, N) 0/1 masks -> (C, N) uint8 labels by
    :func:`_chunk_mean_field` on the (1 - mask, mask) probabilities; or
    (C, N, T) mask sets -> (C, T, N) labels, all T against one bilateral
    build, where ``int8`` takes B2 in bf16, as the JAX package does: the
    lane-packed product wants a plain M operand."""
    if masks_u8.dim() == 2:
        return _chunk_mean_field(imgs_u8, _mask_probs(masks_u8), taps, w1, w2, alpha, beta,
                                 gamma, h=h, w=w, iters=iters, compute_dtype=compute_dtype,
                                 soft=False, fused=fused)
    probs = _mask_probs(masks_u8)  # (C, N, T, 2)
    c, n, t, _ = probs.shape
    if fused == "vmem":
        from critic_vae_tpu_torch.crf.fused_resident import mean_field_resident

        q = mean_field_resident(imgs_u8, probs.reshape(c, n, 2 * t), taps, w1, w2, alpha,
                                beta, gamma, h=h, w=w, iters=iters).view(c, n, t, 2)
        return (q[..., 1] > q[..., 0]).to(torch.uint8).transpose(1, 2)
    from critic_vae_tpu_torch.crf.fused_build import build_bilateral

    dt = "bfloat16" if fused == "int8" else compute_dtype
    build = build_bilateral_xla if fused == "xla" else build_bilateral
    with span("crf.build"):
        mb = build(imgs_u8, w1, alpha, beta, h=h, w=w, out_dtype=dt)
    return _labels(_mean_field_q(mb, probs, taps, w2, h, w, iters)).transpose(1, 2)


def _resolve_build(build: str, h: int, w: int, device) -> str:
    """Resolve a build to "xla" | "pallas" | "int8" | "vmem" for h x w
    frames on ``device``, as the JAX package's ``_resolve_build`` with CUDA
    in the TPU's place.

    * ``xla``: the Gram-form build in float32 (:func:`build_bilateral_xla`),
      plain ops, any size;
    * ``pallas``: kernel B2 (crf/fused_build.build_bilateral);
    * ``int8``: kernels B3 and B4 (single mask; B2 in bf16 for many);
    * ``vmem``: kernel B5 (crf/fused_resident.mean_field_resident);
    * ``auto``: ``pallas`` on a CUDA device when H*W divides by 128, else
      ``xla`` (the CPU included, as the JAX package's CPU runs ``xla``).

    ``CRITIC_VAE_TPU_CRF_BUILD`` overrides ``build``. ``pallas``, ``int8``
    and ``vmem`` keep the JAX package's TPU limits for parity (ROADMAP C):
    H*W divisible by 128, and for ``vmem`` H*W <= MAX_RESIDENT_N; each
    routes to its kernel on a CUDA tensor (the plain versions run only for
    CPU tensors)."""
    from critic_vae_tpu_torch.crf.fused_resident import MAX_RESIDENT_N

    build = os.environ.get(BUILD_ENV, build)
    if build == "xla":
        return "xla"
    divisible = (h * w) % 128 == 0
    if build in ("pallas", "int8", "vmem"):
        if not divisible:
            raise ValueError(f"build={build!r} needs H*W divisible by 128, got {h}x{w}")
        if build == "vmem" and h * w > MAX_RESIDENT_N:
            raise ValueError(
                f"build='vmem' needs H*W <= {MAX_RESIDENT_N}, got {h}x{w} — use 'pallas'"
            )
        return build
    if build == "auto":
        return "pallas" if divisible and torch.device(device).type == "cuda" else "xla"
    raise ValueError(f"unknown build {build!r} (auto|xla|pallas|int8|vmem)")


def _auto_dtype(fused: str, multi: bool) -> str:
    """``compute_dtype="auto"``, as the JAX package: bf16 M for the kernel
    builds (``int8`` too when many masks share its bf16 B2 matrix),
    float32 for ``xla``."""
    bf16 = ("pallas", "int8", "vmem") if multi else ("pallas", "vmem")
    return "bfloat16" if fused in bf16 else "float32"


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


def _run_chunked(flat_imgs: torch.Tensor, flat_second: torch.Tensor, params, h: int,
                 w: int, frame_chunk: int, compute_dtype: str, *, build: str = "auto",
                 fetch: bool = True, soft: bool = False, mesh=None):
    """Refine (n, N, 3) frames with (n, N) 0/1 masks, (n, N, T) mask sets or
    (n, N, L) float probabilities, in fixed-size chunks padded by repeating
    the last frame. Returns (n, N) or (n, T, N) uint8 labels, or for
    probabilities with ``soft`` the (n, N, L) float32 marginals; as numpy
    with ``fetch`` or as a device tensor without. With a ``mesh`` the chunk
    is rounded up to a multiple of its ranks, each rank runs the chunk body
    on its rows (the JAX package's ``_meshed_dispatch``) and the rows are
    gathered (parallel/mesh.py::fetch)."""
    w1, alpha, beta, w2, gamma, iters = params
    fused = _resolve_build(build, h, w, flat_imgs.device)
    probs = flat_second.is_floating_point()
    multi = not probs and flat_second.dim() == 3
    if probs and fused == "vmem" and flat_second.shape[2] != 2:
        fused = "pallas"  # as the chunk body falls back: B5's pair softmax wants L = 2
    if compute_dtype == "auto":
        compute_dtype = _auto_dtype(fused, multi)
    n, npix = flat_imgs.shape[0], h * w
    if n == 0:
        if probs and soft:
            out = torch.empty((0, npix, flat_second.shape[2]), dtype=torch.float32,
                              device=flat_imgs.device)
        else:
            shape = (0, flat_second.shape[2], npix) if multi else (0, npix)
            out = torch.empty(shape, dtype=torch.uint8, device=flat_imgs.device)
        return out.cpu().numpy() if fetch else out
    taps = torch.from_numpy(_spatial_taps(float(gamma), h, w)).to(flat_imgs.device)
    if probs:
        lanes = flat_second.shape[2]
    else:
        lanes = 2 * (flat_second.shape[2] if multi else 1)
    frame_chunk = _chunk_frames(min(frame_chunk, n), fused, multi, compute_dtype, npix, lanes)
    if mesh is not None:
        from critic_vae_tpu_torch.parallel.mesh import fetch as mesh_fetch, shard_batch

        frame_chunk += (-frame_chunk) % mesh.size
    kw = dict(h=h, w=w, iters=int(iters), compute_dtype=compute_dtype, fused=fused)
    segs = []
    for i in range(0, n, frame_chunk):
        imgs = flat_imgs[i : i + frame_chunk]
        second = flat_second[i : i + frame_chunk]
        valid = imgs.shape[0]
        if valid < frame_chunk:
            pad = frame_chunk - valid
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            second = torch.cat([second, second[-1:].expand(pad, *second.shape[1:])])
        if mesh is not None:
            imgs, second = shard_batch(mesh, imgs), shard_batch(mesh, second)
        args = (imgs.contiguous(), second, taps, w1, w2, alpha, beta, gamma)
        if probs:
            seg = _chunk_mean_field(*args, soft=soft, **kw)
        else:
            seg = _crf_chunk_from_masks(*args, **kw)
        if mesh is not None:
            seg = mesh_fetch(mesh, seg)
        segs.append(seg[:valid])
    out = torch.cat(segs) if len(segs) > 1 else segs[0]
    return out.cpu().numpy() if fetch else out


def _frames_on(frames_u8, device, name: str):
    """``frames_u8`` as a uint8 tensor on ``device``: a tensor where it lies
    when ``device`` is None, numpy on the card (CUDA) when it is None."""
    if device is None:
        if isinstance(frames_u8, torch.Tensor):
            device = frames_u8.device
        else:
            from critic_vae_tpu_torch.device import resolve_device

            device = resolve_device("cuda")
    device = torch.device(device)
    frames = torch.as_tensor(frames_u8, device=device)
    if frames.dtype != torch.uint8:
        raise TypeError(f"{name}: frames must be uint8, got {frames.dtype}")
    return frames, device


@torch.inference_mode()
def densecrf_device(imgs, probs, params: Tuple, *, frame_chunk: int = 64,
                    compute_dtype: str = "float32", soft: bool = False, build: str = "xla",
                    device=None, mesh=None) -> np.ndarray:
    """Batched exact dense CRF on the card, the call shape of
    :func:`critic_vae_tpu_torch.crf.host.densecrf_batch` (the JAX package's
    ``densecrf_device``, its defaults included: the ``xla`` build in
    float32).

    Args:
      imgs: (n, H, W, 3) uint8 frames, or one (H, W, 3) frame.
      probs: (n, H, W, L) per-class probabilities (L >= 1), or (H, W, L).
      params: the 6-tuple (w1, alpha, beta, w2, gamma, iters).
      compute_dtype: the bilateral matrix's dtype, "float32" or "bfloat16"
        (``pallas`` and ``xla``; the unary and softmax are float32).
      soft: return the mean-field marginals Q instead of argmax labels.
      build: "xla", "pallas" (B2), "int8" (B3 + B4, any L), "vmem" (B5 at
        L = 2, ``pallas`` otherwise) or "auto" (:func:`_resolve_build`).
      device: where numpy inputs go (default the card); tensors are used
        where they lie.
      mesh: a data-parallel mesh: each rank refines its rows of each chunk
        (parallel/mesh.py), and every rank returns the whole result.

    Returns (n, H, W) uint8 labels, or the (n, H, W, L) float32 marginals
    with ``soft``, as numpy; the leading axis is dropped for one frame."""
    single = probs.ndim == 3
    if single:
        imgs, probs = imgs[None], probs[None]
    if not isinstance(imgs, torch.Tensor):
        imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    frames, device = _frames_on(imgs, device, "densecrf_device")
    p = torch.as_tensor(probs, device=device).float()
    n, h, w_, L = p.shape
    if tuple(frames.shape) != (n, h, w_, 3):
        raise ValueError(f"imgs shape {tuple(frames.shape)} does not match probs {tuple(p.shape)}")
    out = _run_chunked(frames.reshape(n, h * w_, 3).contiguous(),
                       p.reshape(n, h * w_, L).contiguous(), params, h, w_, frame_chunk,
                       compute_dtype, build=build, soft=soft, mesh=mesh)
    out = out.reshape((n, h, w_, L) if soft else (n, h, w_))
    return out[0] if single else out


@torch.inference_mode()
def crf_param_search(frames_u8, thr_masks, gt, param_grid: dict | None = None, *,
                     frame_chunk: int = 64, compute_dtype: str = "auto",
                     build: str = "auto", device=None, mesh=None):
    """A CRF hyperparameter search on the card (the JAX package's
    ``crf_param_search``): every combination of ``param_grid`` (dict of
    lists over w1/alpha/beta/w2/gamma/iters; a missing key takes the
    reference's value) refines the ORIGINAL (n, H, W) threshold masks of the
    (n, H, W, 3) uint8 frames by :func:`refine_masks_device`, and is scored
    by its whole-stack IoU against ``gt``, counted on the card. The frames,
    masks and ``gt`` go to the card once (numpy inputs to ``device``,
    default the card; tensors stay where they lie). With a ``mesh`` the
    corpus is padded to a multiple of its ranks by repeating the last frame,
    every combination refines over the mesh, and each refinement is trimmed
    back before it is scored, as in the JAX package.

    Returns (best_masks, results): ``results`` the (iou, params6) of every
    combination in descending IoU (ties in grid order), ``best_masks`` the
    (n, H, W) bool numpy refinement of the first combination with the
    highest IoU."""
    import itertools

    from critic_vae_tpu_torch.crf import DEFAULT_PARAM_GRID

    keys = ("w1", "alpha", "beta", "w2", "gamma", "iters")
    if param_grid:
        bad = set(param_grid) - set(keys)
        if bad:
            raise ValueError(f"unknown CRF grid key(s) {sorted(bad)}; valid: {list(keys)}")
        empty = [k for k, v in param_grid.items() if not v]
        if empty:
            raise ValueError(f"CRF grid key(s) {empty} have no values")
    grid = {**DEFAULT_PARAM_GRID, **(param_grid or {})}
    combos = [dict(zip(grid.keys(), v)) for v in itertools.product(*grid.values())]
    if not isinstance(frames_u8, torch.Tensor):
        frames_u8 = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    frames, device = _frames_on(frames_u8, device, "crf_param_search")
    masks = torch.as_tensor(thr_masks, device=device).to(torch.uint8)
    gt_dev = torch.as_tensor(gt, device=device).bool()
    n_frames = frames.shape[0]
    if mesh is not None and n_frames % mesh.size:
        pad = mesh.size - n_frames % mesh.size
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
        masks = torch.cat([masks, masks[-1:].expand(pad, *masks.shape[1:])])
    results, best = [], None
    for c in combos:
        params = tuple(c[k] for k in keys)
        refined = refine_masks_device(frames, masks, params, frame_chunk=frame_chunk,
                                      compute_dtype=compute_dtype, build=build, fetch=False,
                                      mesh=mesh)[:n_frames]
        score = ious_from_counts(iou_counts(gt_dev, refined), round_digits=None)[0]
        results.append((score, params))
        if best is None or score > best[0]:
            best = (score, refined)
    results.sort(key=lambda r: r[0], reverse=True)
    return best[1].cpu().numpy(), results


@torch.inference_mode()
def refine_masks_device(frames_u8, thr_masks, params: Tuple = REFERENCE_CRF_PARAMS, *,
                        frame_chunk: int = 64, compute_dtype: str = "auto",
                        build: str = "auto", fetch: bool = True, device=None, mesh=None):
    """Refine (n, H, W) threshold masks of (n, H, W, 3) uint8 frames with the
    exact dense CRF; returns (n, H, W) bool, as numpy with ``fetch`` or as a
    tensor on the device without.

    Tensors are used where they lie; numpy inputs go to ``device``, by
    default the card. The
    build resolves as in the JAX package (:func:`_resolve_build`): B2 on
    CUDA at H*W % 128 == 0, the ``xla`` build elsewhere (the CPU, ragged
    sizes). ``compute_dtype="auto"`` stores B2's M in bf16 (the kernel's fast
    path; held to >= 99.9% segmentation agreement with float32) and the
    ``xla`` build's in float32; ``int8`` and ``vmem`` fix their own
    storage. With a ``mesh`` each rank refines its rows of every chunk and
    every rank returns the whole result."""
    frames, device = _frames_on(frames_u8, device, "refine_masks_device")
    n, h, w_, _ = frames.shape
    if tuple(thr_masks.shape) != (n, h, w_):
        raise ValueError(
            f"thr_masks shape {tuple(thr_masks.shape)} does not match frames {tuple(frames.shape)}"
        )
    masks = torch.as_tensor(thr_masks, device=device).to(torch.uint8).reshape(n, h * w_)
    out = _run_chunked(
        frames.reshape(n, h * w_, 3), masks, params, h, w_, frame_chunk,
        compute_dtype, build=build, fetch=fetch, mesh=mesh,
    )
    return out.reshape(n, h, w_).astype(bool) if fetch else out.reshape(n, h, w_).bool()


@torch.inference_mode()
def refine_masks_multi_device(frames_u8, thr_masks_multi,
                              params: Tuple = REFERENCE_CRF_PARAMS, *,
                              frame_chunk: int = 64, compute_dtype: str = "auto",
                              build: str = "auto", fetch: bool = True, device=None,
                              mesh=None):
    """Refine T mask sets of the same frames in one pass (the threshold
    sweep): (F, H, W, 3) uint8 frames and (T, F, H, W) 0/1 masks -> (T, F,
    H, W) bool, as numpy with ``fetch`` or on the device without. Each set
    agrees with ``refine_masks_device(frames, thr_masks_multi[t])``; all T
    share one bilateral build and one read of it per iteration.

    Inputs are used where they lie and ``mesh`` splits the chunks, as in
    :func:`refine_masks_device`."""
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
    out = _run_chunked(
        frames.reshape(f, h * w_, 3), masks, params, h, w_, frame_chunk,
        compute_dtype, build=build, fetch=fetch, mesh=mesh,
    )  # (F, T, N)
    if fetch:
        return out.transpose(1, 0, 2).reshape(t, f, h, w_).astype(bool)
    return out.transpose(0, 1).reshape(t, f, h, w_).bool()
