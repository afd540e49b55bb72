"""Exact dense-CRF mean-field on the device (counterpart of
critic_vae_tpu/crf/device.py).

Per frame of N = H*W pixels the bilateral term is an N x N matrix M; the
spatial term exp(-(dx^2+dy^2)/2 gamma^2) is exactly separable, so its
message is a truncated separable Gaussian depthwise conv. Messages run
over j != i:

    Q <- softmax(-U + M @ Q + w2 * n_s * (K_s @ (n_s * Q)))   x iters
    seg = argmax Q

with U = -log(clamp(prob, 1e-8)) and Q0 = softmax(-U) (crf/terms.py, which
holds the terms every build shares).

Each decision is taken in one place:

* :func:`_resolve_build` names the build: ``xla`` (M from Gram products in
  float32, :func:`build_bilateral_xla`), ``pallas`` (kernel B2,
  crf/fused_build.py), ``int8`` (B3 stores K as int8, B4's int8 matvec is
  the message) or ``vmem`` (B5 runs the whole mean field, the spatial term
  folded into one bf16 matrix, crf/fused_resident.py), as the JAX package;
* :func:`_plan` says what the name means for the second operand (one mask,
  T mask sets or L probabilities) and ``compute_dtype``: what runs, M's
  dtype, a frame's bytes. No other code compares a build's name;
* :func:`_run_chunked` cuts the frames into padded fixed-size chunks, gives
  each chunk (C, N, T, L) probabilities (masks as (1 - m, m)), runs it
  through the one chunk body :func:`_chunk_marginals` and keeps its labels,
  or with ``soft`` its marginals, which the entry points reshape;
* :func:`_mean_field_q` iterates on every bilateral term but B5's: B2's
  pair of the unnormalized K and its normalizers g (M = g g^T K), the
  ``xla`` build's normalized M, or B3 + B4's message. One launch of kernel
  ``mean_field_step`` (crf/mean_field_step.py) an iteration for a bf16 K or
  M on the card with N % 8 == 0 (each after one of kernel
  ``spatial_message``), else the one loop :func:`_mean_field_loop` with the
  message as a function of q (:func:`_message`), whose spatial message on
  the card is kernel ``spatial_message`` too, in float32 (:func:`_spatial`).

:data:`BUILDS` counts the chunks and frames each resolved build refined.

``refine_masks_multi_device`` refines T mask sets of the same frames
against one matrix, packed as T*L lanes of Q (the threshold sweep);
``densecrf_device`` refines any (n, H, W, L) probabilities, returning
labels or with ``soft`` the marginals; ``crf_param_search`` refines the
same masks once for each combination of a parameter grid and scores each by
IoU counted on the card. Each takes ``mesh=`` (parallel/mesh.py): the chunk
is rounded up to a multiple of the mesh's ranks, each rank refines its rows
of every chunk (the JAX package's ``_meshed_dispatch``: frames are
independent, so no collective but the gather), and the rows are gathered
so that every rank holds the whole result.

The M @ Q message accumulates in float32 whatever M's storage dtype, as the
JAX package's ``preferred_element_type=f32`` does: outside the kernel, for
a float32 M ``torch.bmm``; for a bf16 M on the CPU ``bmm`` of the bf16
values widened to float32 (bf16 products are exact in float32), and on
CUDA, where a ragged N leaves the kernel, ``torch.bmm(M, Q_bf16,
torch.float32)``, the ``out_dtype`` overload that PyTorch documents for
float32 output from bf16 operands on CUDA only (a plain bf16 ``bmm`` would
round the messages to bf16). B2's pair takes the same product with K in M's
place and g * Q in Q's, and scales its rows by g.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from critic_vae_tpu_torch.crf import DEFAULT_PARAM_GRID, REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.fused_build import (
    QUANT_SCALE,
    BilateralPair,
    build_bilateral,
    build_kernel_i8,
    matvec_i8,
)
from critic_vae_tpu_torch.crf.fused_resident import (
    MAX_RESIDENT_N,
    mean_field_resident,
    workspace_bytes,
)
from critic_vae_tpu_torch.crf.mean_field_step import (
    mean_field_steps,
    spatial_message,
    spatial_message_takes,
)
from critic_vae_tpu_torch.crf.terms import (
    _EPS_NORM,
    _coords,
    _prologue,
    _spatial_norm,
    _spatial_taps,
)
from critic_vae_tpu_torch.device import resolve_device
from critic_vae_tpu_torch.ops.mask import iou_counts, ious_from_counts
from critic_vae_tpu_torch.parallel.mesh import fetch as mesh_fetch, shard_batch
from critic_vae_tpu_torch.utils.profiling import span

# Per-chunk budget for the N^2 workspaces, in bytes; MEM_ENV overrides it,
# as in the JAX package (its crf/device.py _run_chunked). The JAX package
# sized the default for a 16 GB TPU chip; kept as is until it is measured on
# the 80 GB H100 (ROADMAP G.1). At 64x64 it allows 95 f32, 190 bf16 or 381
# int8 frames, above the default chunk of 64.
_MEM_BUDGET = 6 * 1024**3
MEM_ENV = "CRITIC_VAE_TPU_CRF_MEM"

# the JAX package's build override (its crf/device.py _resolve_build)
BUILD_ENV = "CRITIC_VAE_TPU_CRF_BUILD"

# the chunks and their frames (padding left out) that each build refined
# since the last reset_builds(), by the build :func:`_plan` settled on, so
# many mask sets under ``int8`` count as ``pallas``; under a mesh every rank
# counts each chunk
BUILDS = {build: {"chunks": 0, "frames": 0} for build in ("xla", "pallas", "int8", "vmem")}


def reset_builds() -> None:
    for counts in BUILDS.values():
        counts["chunks"] = counts["frames"] = 0


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


def _sep_conv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise (B, C, H, W) conv with outer(taps, taps): along H, then W."""
    c, k = x.shape[1], taps.shape[0]
    r = k // 2
    x = F.conv2d(x, taps.view(1, 1, k, 1).repeat(c, 1, 1, 1), padding=(r, 0), groups=c)
    return F.conv2d(x, taps.view(1, 1, 1, k).repeat(c, 1, 1, 1), padding=(0, r), groups=c)


def _spatial_message(q: torch.Tensor, ns: torch.Tensor, taps: torch.Tensor, h: int,
                     w: int) -> torch.Tensor:
    """n_s * (K_s @ (n_s * q)) over j != i for (C, N, L) q, as a separable
    conv of the lanes' images less the centre tap."""
    c, n, lanes = q.shape
    y = ns * q
    y_img = y.view(c, h, w, lanes).permute(0, 3, 1, 2)
    sp = _sep_conv(y_img, taps).permute(0, 2, 3, 1).reshape(c, n, lanes) - y
    return ns * sp


def _spatial(q: torch.Tensor, ns: torch.Tensor, taps: torch.Tensor, h: int,
             w: int) -> torch.Tensor:
    """:func:`_spatial_message` of the (C, N, P) q: on the card one launch
    of kernel ``spatial_message`` (float32, where cuDNN's depthwise conv
    would run in TF32) wherever the kernel takes the shape; CPU tensors and
    other shapes take :func:`_spatial_message`."""
    c, _, p = q.shape
    if q.is_cuda and spatial_message_takes(c, p, w, taps.shape[0] // 2):
        y = (ns * q).transpose(1, 2).contiguous()
        return spatial_message(y, ns, taps, h=h, w=w).transpose(1, 2)
    return _spatial_message(q, ns, taps, h, w)


def _matrix_message(mb: torch.Tensor) -> Callable:
    """q -> M @ q with float32 accumulation and output (see the module note)."""
    if mb.dtype == torch.float32:
        return lambda q: torch.bmm(mb, q)
    if mb.is_cuda:
        return lambda q: torch.bmm(mb, q.to(mb.dtype), torch.float32)
    return lambda q: torch.bmm(mb.float(), q.to(mb.dtype).float())


def _pair_message(pair: BilateralPair) -> Callable:
    """q -> M @ q of B2's pair, M = g g^T K: g * (K @ (g * q)), the product
    cast and summed as :func:`_matrix_message` takes it (g * q rounded to
    K's dtype)."""
    kq = _matrix_message(pair.k)
    g = pair.g.unsqueeze(-1)
    return lambda q: g * kq(g * q)


def _message(bilateral) -> Callable:
    """The bilateral term as a function of the (C, N, P) q: B3's message as
    it is, B2's pair by :func:`_pair_message`, a matrix by
    :func:`_matrix_message`."""
    if callable(bilateral):
        return bilateral
    if isinstance(bilateral, BilateralPair):
        return _pair_message(bilateral)
    return _matrix_message(bilateral)


def _i8_message(imgs_u8: torch.Tensor, w1, alpha, beta, *, h: int, w: int,
                out_dtype: str = "int8") -> Callable:
    """The ``int8`` build's bilateral term: kernel B3 stores the
    unnormalized kernel as int8 (scale 127) with the row sums of the stored
    values, and the message is kernel B4's int8 matvec with the normalizers
    folded into the vector,

        M @ q = g * (K_i8 @ (g * q)),  g = sqrt(w1/127) rsqrt(rowsum/127 + eps)

    the exactly normalized 8-bit model. Returns the message as a function of
    (C, N, P) q; ``out_dtype`` is the plan's, int8 being B3's only storage."""
    c, n, _ = imgs_u8.shape
    k8, rowsum = build_kernel_i8(imgs_u8, alpha, beta, h=h, w=w)
    w1_t = torch.full((), w1, dtype=torch.float32, device=imgs_u8.device)
    g = (torch.sqrt(w1_t / QUANT_SCALE)
         * torch.rsqrt(rowsum / QUANT_SCALE + _EPS_NORM)).view(c, n, 1)
    return lambda q: g * matvec_i8(k8, (g * q).view(c * n, -1), n=n).view(c, n, -1)


def _fused_step(bilateral) -> bool:
    """Whether the mean field over a chunk's bilateral term runs as kernel
    ``mean_field_step``: B2's bf16 K (or a bf16 M) on the card whose rows
    are whole 16-byte chunks (N % 8 == 0, as the kernel's copies want; the
    ``pallas`` build's K, at H*W % 128 == 0, always is). CPU tensors, a
    float32 K or M and B3's message (a function) run
    :func:`_mean_field_loop`."""
    if callable(bilateral):
        return False
    m = bilateral.k if isinstance(bilateral, BilateralPair) else bilateral
    return m.is_cuda and m.dtype == torch.bfloat16 and m.shape[-1] % 8 == 0


def _mean_field_loop(message: Callable, q: torch.Tensor, unary: torch.Tensor,
                     ns: torch.Tensor, taps: torch.Tensor, w2, h: int, w: int,
                     iters: int) -> torch.Tensor:
    """The mean field as the composition of ``message`` (a function of the
    (C, N, P) q: :func:`_matrix_message`, :func:`_pair_message` or
    :func:`_i8_message`), the spatial message (:func:`_spatial`) and the
    softmax: (C, N, T, L) q and unaries -> (C, N, T, L) float32 marginals."""
    c, n, t, L = q.shape
    for _ in range(iters):
        qf = q.reshape(c, n, t * L)
        msg = message(qf) + w2 * _spatial(qf, ns, taps, h, w)
        q = torch.softmax(msg.view(c, n, t, L) - unary, dim=-1)
    return q


def _mean_field_q(bilateral, probs: torch.Tensor, taps: torch.Tensor, w2, h: int, w: int,
                  iters: int) -> torch.Tensor:
    """T independent mean fields over a chunk's bilateral term, packed into
    the lanes of Q: (C, N, T, L) probabilities -> (C, N, T, L) float32
    marginals. ``bilateral`` is B2's :class:`BilateralPair` or the ``xla``
    build's (C, N, N) M, read once an iteration for all T, by kernel
    ``mean_field_step`` where :func:`_fused_step` says so (an M as the pair
    (M, 1), which leaves its products and roundings as they were) and else
    by :func:`_mean_field_loop`; or B3's message (:func:`_i8_message`). The
    prologue stays outside ``crf.mean_field``."""
    c, n, t, L = probs.shape
    ns = _spatial_norm(taps, h, w)
    unary, q = _prologue(probs)
    with span("crf.mean_field"):
        if not _fused_step(bilateral):
            return _mean_field_loop(_message(bilateral), q, unary, ns, taps, w2, h, w, iters)
        if not isinstance(bilateral, BilateralPair):
            bilateral = BilateralPair(bilateral, torch.ones((c, n), device=bilateral.device))
        out = mean_field_steps(bilateral, q.reshape(c, n, t * L), unary.reshape(c, n, t * L),
                               ns, taps, w2, h=h, w=w, classes=L, iters=iters)
        return out.view(c, n, t, L)


def _labels(q: torch.Tensor) -> torch.Tensor:
    """Argmax labels of marginals along the last axis, uint8 (the first
    class on a tie, so at L = 2 the label is q_1 > q_0, B5's own rule)."""
    return torch.argmax(q, dim=-1).to(torch.uint8)


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
    and ``vmem`` keep the JAX package's TPU limits for parity (ROADMAP G.1):
    H*W divisible by 128, and for ``vmem`` H*W <= MAX_RESIDENT_N; each
    routes to its kernel on a CUDA tensor (the plain versions run only for
    CPU tensors)."""
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


class _Plan(NamedTuple):
    """What a resolved build runs for one second operand (:func:`_plan`)."""

    build: Callable   # B5's mean_field_resident, or the builder of the bilateral term
    m_dtype: str      # the matrix's storage: "float32", "bfloat16" or "int8" (B3's K)
    frame_bytes: int  # a frame's N^2 workspace, against the chunk budget


def _plan(build: str, second: torch.Tensor, compute_dtype: str) -> _Plan:
    """What the resolved ``build`` means for :func:`_run_chunked`'s second
    operand ``second`` ((n, N) 0/1 masks, (n, N, T) mask sets or (n, N, L)
    float probabilities) and ``compute_dtype``, as the JAX package decides:

    * ``vmem``: B5 on the T*L lanes, but ``pallas`` for probabilities at L
      != 2 (B5's pair softmax wants L = 2); its workspace is
      fused_resident.workspace_bytes;
    * ``int8``: B3 + B4 on one mask set or on probabilities, its K at one
      byte an entry; many mask sets take B2 in bf16 (the lane-packed
      product wants a plain M operand);
    * ``pallas`` (B2: K and its normalizers g) and ``xla`` (M): the matrix
      in ``compute_dtype``, ``auto`` being bf16 for B2 and float32 for
      ``xla``; 2 bytes an entry in bf16, else 4 (g's 4 bytes a pixel are
      left out).
    """
    npix = second.shape[1]
    probs = second.is_floating_point()
    multi = not probs and second.dim() == 3
    lanes = second.shape[2] if probs else 2 * (second.shape[2] if multi else 1)
    if build == "vmem" and probs and lanes != 2:
        build = "pallas"
    if build == "vmem":
        return _Plan(mean_field_resident, "bfloat16", workspace_bytes(1, npix, lanes))
    if build == "int8" and multi:
        build, compute_dtype = "pallas", "bfloat16"
    if build == "int8":
        return _Plan(_i8_message, "int8", npix * npix)
    if compute_dtype == "auto":
        compute_dtype = "float32" if build == "xla" else "bfloat16"
    builder = build_bilateral_xla if build == "xla" else build_bilateral
    entry = 2 if compute_dtype == "bfloat16" else 4
    return _Plan(builder, compute_dtype, entry * npix * npix)


def _build_name(plan: _Plan) -> str:
    """The build that ``plan`` runs, as :data:`BUILDS` counts it."""
    return {mean_field_resident: "vmem", _i8_message: "int8", build_bilateral_xla: "xla",
            build_bilateral: "pallas"}[plan.build]


def _as_probs(second: torch.Tensor) -> torch.Tensor:
    """A chunk's second operand as (C, N, T, L) probabilities: (C, N, L)
    probabilities as T = 1, (C, N) 0/1 masks as the (1 - m, m) planes of T =
    1 and (C, N, T) mask sets as T such pairs."""
    if second.is_floating_point():
        return second[:, :, None]
    m = second.float()
    if m.dim() == 2:
        m = m[:, :, None]
    return torch.stack([1.0 - m, m], dim=-1)


def _chunk_marginals(plan: _Plan, imgs_u8: torch.Tensor, probs: torch.Tensor,
                     taps: torch.Tensor, params, h: int, w: int) -> torch.Tensor:
    """The chunk body of every build: (C, N, 3) uint8 frames and (C, N, T, L)
    float32 probabilities -> (C, N, T, L) float32 marginals through
    ``plan``. B5 runs the whole mean field on the T*L lanes; any other
    build makes the bilateral term inside ``crf.build`` and
    :func:`_mean_field_q` iterates on it."""
    w1, alpha, beta, w2, gamma, iters = params
    c, n, t, L = probs.shape
    if plan.build is mean_field_resident:
        q = mean_field_resident(imgs_u8, probs.reshape(c, n, t * L), taps, w1, w2, alpha,
                                beta, gamma, h=h, w=w, iters=int(iters))
        return q.view(c, n, t, L)
    with span("crf.build"):
        bilateral = plan.build(imgs_u8, w1, alpha, beta, h=h, w=w, out_dtype=plan.m_dtype)
    return _mean_field_q(bilateral, probs, taps, w2, h, w, int(iters))


def _run_chunked(flat_imgs: torch.Tensor, flat_second: torch.Tensor, params, h: int,
                 w: int, frame_chunk: int, compute_dtype: str, *, build: str = "auto",
                 fetch: bool = True, soft: bool = False, mesh=None, taps=None):
    """Refine (n, N, 3) frames with (n, N) 0/1 masks, (n, N, T) mask sets or
    (n, N, L) float probabilities, in fixed-size chunks padded by repeating
    the last frame. Returns the (n, N, T) uint8 labels (T = 1 but for mask
    sets), or with ``soft`` the (n, N, T, L) float32 marginals; as numpy
    with ``fetch`` or as a device tensor without. A chunk holds at most
    ``frame_chunk`` frames (and at least 1) whose workspace fits the budget
    (``CRITIC_VAE_TPU_CRF_MEM`` bytes, default 6 GiB). With a ``mesh`` the
    chunk is rounded up to a multiple of its ranks, each rank runs the chunk
    body on its rows (the JAX package's ``_meshed_dispatch``) and the rows
    are gathered (parallel/mesh.py::fetch). ``taps``: the spatial taps
    (terms.py::_spatial_taps of gamma, h, w) on the frames' device, made
    and copied there when None."""
    plan = _plan(_resolve_build(build, h, w, flat_imgs.device), flat_second, compute_dtype)
    n = flat_imgs.shape[0]
    if n == 0:
        out = _as_probs(flat_second) if soft else _labels(_as_probs(flat_second))
        return out.cpu().numpy() if fetch else out
    if taps is None:
        taps = torch.from_numpy(_spatial_taps(float(params[4]), h, w)).to(flat_imgs.device)
    budget = int(os.environ.get(MEM_ENV, _MEM_BUDGET))
    frame_chunk = max(1, min(frame_chunk, n, budget // plan.frame_bytes))
    if mesh is not None:
        frame_chunk += (-frame_chunk) % mesh.size
    counts = BUILDS[_build_name(plan)]
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
        seg = _chunk_marginals(plan, imgs.contiguous(), _as_probs(second), taps, params, h, w)
        counts["chunks"] += 1
        counts["frames"] += valid
        if not soft:
            seg = _labels(seg)
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
                        build: str = "auto", fetch: bool = True, device=None, mesh=None,
                        taps=None):
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
    every rank returns the whole result. ``taps``, the spatial taps already
    on the device (:func:`_run_chunked`), spare the call its one copy from
    the host."""
    frames, device = _frames_on(frames_u8, device, "refine_masks_device")
    n, h, w_, _ = frames.shape
    if tuple(thr_masks.shape) != (n, h, w_):
        raise ValueError(
            f"thr_masks shape {tuple(thr_masks.shape)} does not match frames {tuple(frames.shape)}"
        )
    masks = torch.as_tensor(thr_masks, device=device).to(torch.uint8).reshape(n, h * w_)
    out = _run_chunked(
        frames.reshape(n, h * w_, 3), masks, params, h, w_, frame_chunk,
        compute_dtype, build=build, fetch=fetch, mesh=mesh, taps=taps,
    )
    return out.reshape(n, h, w_).astype(bool) if fetch else out.reshape(n, h, w_).bool()


@torch.inference_mode()
def refine_masks_multi_device(frames_u8, thr_masks_multi,
                              params: Tuple = REFERENCE_CRF_PARAMS, *,
                              frame_chunk: int = 64, compute_dtype: str = "auto",
                              build: str = "auto", fetch: bool = True, device=None,
                              mesh=None, taps=None):
    """Refine T mask sets of the same frames in one pass (the threshold
    sweep): (F, H, W, 3) uint8 frames and (T, F, H, W) 0/1 masks -> (T, F,
    H, W) bool, as numpy with ``fetch`` or on the device without. Each set
    agrees with ``refine_masks_device(frames, thr_masks_multi[t])``; all T
    share one bilateral build and one read of it per iteration.

    Inputs are used where they lie, and ``mesh`` and ``taps`` are as in
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
        compute_dtype, build=build, fetch=fetch, mesh=mesh, taps=taps,
    )  # (F, N, T)
    if fetch:
        return out.transpose(2, 0, 1).reshape(t, f, h, w_).astype(bool)
    return out.permute(2, 0, 1).reshape(t, f, h, w_).bool()
