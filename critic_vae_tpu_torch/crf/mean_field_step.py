"""Kernel ``mean_field_step``: one iteration of the device CRF's mean field
on a bf16 bilateral kernel in one launch.

The device CRF's one chunk body (``crf/device.py::_chunk_marginals``)
runs its iterations here whenever its plan builds a bf16 bilateral term on
the card with N % 8 == 0 (B2's pair of K and g, or the ``xla`` build's
normalized M in bf16, which runs as the pair (M, 1)), whatever the entry
point or the lanes. Per frame of N = h*w pixels, with q's P = T*L lanes (T
sets of L classes):

    y  = n_s * q
    z  = g * (K @ bf16(g * q)) + w2 * n_s * (sepconv(y) - y) - U
    q' = softmax(z) over each group of L lanes

which is the message of the pair (``crf/device.py::_pair_message``) + w2 *
``_spatial_message(q, ...)``, less the unaries, through the softmax: the
same bf16 K and bf16 g q in the product, the separable conv of the taps
along H and then W with zero outside the frame, in float32 (as the
composition takes it on the card, from kernel ``spatial_message`` too).

The CUDA kernel is ``csrc/mean_field_step.cu``;
:func:`mean_field_step_reference` is the plain version of one launch, lane
group by lane group as the kernel takes them (:func:`lane_groups`). The
spatial message n_s * (sepconv(y) - y) comes from kernel ``spatial_message``
(``csrc/spatial_message.cu``, plain version
:func:`spatial_message_reference`), launched before each step on the y
that the step before wrote; the step adds it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from critic_vae_tpu_torch.crf.fused_build import MAX_LAUNCH_FRAMES, BilateralPair
from critic_vae_tpu_torch.kernels import build as kb

# A softmax group lies in one block's 64 lanes (csrc/mean_field_step.cu).
MAX_CLASSES = 64
# csrc/spatial_message.cu's limit on a row of its column and row sums
_SPATIAL_SMEM_BYTES = 232448


def lane_groups(lanes: int, classes: int) -> List[Tuple[int, int]]:
    """The [l0, l1) lane groups of a launch: at most 64 lanes each, a whole
    number of softmax groups of ``classes`` lanes (2 -> 64, 3 -> 63); each
    reads M once."""
    step = MAX_CLASSES // classes * classes
    return [(l0, min(lanes, l0 + step)) for l0 in range(0, lanes, step)]


def _tap_sum(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_k taps[k] x[i + k - r] along ``dim``, zero outside it, tap by tap
    in float32 (r = len(taps) // 2)."""
    size, r = x.shape[dim], taps.shape[0] // 2
    out = torch.zeros_like(x)
    for k in range(taps.shape[0]):
        d = k - r
        if abs(d) >= size:
            continue
        lo, length = max(0, -d), size - abs(d)
        out.narrow(dim, lo, length).add_(x.narrow(dim, lo + d, length) * taps[k])
    return out


def spatial_message_reference(y: torch.Tensor, ns: torch.Tensor, taps: torch.Tensor, h: int,
                              w: int) -> torch.Tensor:
    """n_s * (sepconv(y) - y) of the (C, P, N) lane-major y = n_s * q: the
    taps along H, then along W, in float32."""
    c, p, n = y.shape
    img = y.reshape(c, p, h, w)
    conv = _tap_sum(_tap_sum(img, taps.float(), 2), taps.float(), 3).reshape(c, p, n)
    return ns.reshape(1, 1, n) * (conv - y)


def spatial_message_takes(frames: int, lanes: int, w: int, radius: int) -> bool:
    """Whether kernel ``spatial_message`` takes ``frames`` frames of
    ``lanes`` lanes, ``w`` pixels wide, with taps of ``radius``: its grid's
    limits, and a row of its column sums (w rounded up to 16, the taps'
    reach in groups of 8, odd) with its row of row sums (w, odd) in a
    block's shared memory, as its C entry checks."""
    cols = (-(-w // 16) * 16 + 8 * ((2 * radius + 8) // 8) - 1) | 1
    return (frames <= MAX_LAUNCH_FRAMES and lanes <= MAX_LAUNCH_FRAMES
            and 4 * (cols + (w | 1)) <= _SPATIAL_SMEM_BYTES)


def spatial_message(y: torch.Tensor, ns: torch.Tensor, taps: torch.Tensor, *, h: int, w: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """n_s * (sepconv(y) - y) of a (C, P, N) float32 lane-major y, N = h*w.

    CUDA tensors launch kernel ``spatial_message`` into ``out`` (a fresh
    (C, P, N) float32 tensor if None) or raise (also where a row of its
    column and row sums, about 2 w + 2 radius float32 words, exceeds a
    block's shared memory); CPU tensors take
    :func:`spatial_message_reference`."""
    c, p, n = y.shape
    if n != h * w or ns.numel() != n:
        raise ValueError(f"spatial_message: y {tuple(y.shape)} or n_s {tuple(ns.shape)} are "
                         f"no {h}x{w} frames")
    if not y.is_cuda:
        return spatial_message_reference(y, ns.reshape(n), taps, h, w)
    if (y.dtype != torch.float32 or not y.is_contiguous() or c > MAX_LAUNCH_FRAMES
            or p > MAX_LAUNCH_FRAMES):
        raise ValueError(f"spatial_message: want a contiguous float32 y of at most "
                         f"{MAX_LAUNCH_FRAMES} frames and lanes, got {y.dtype} {tuple(y.shape)}")
    if out is None:
        out = torch.empty_like(y)
    elif out.shape != y.shape or out.dtype != y.dtype or not out.is_contiguous():
        raise ValueError(f"spatial_message: out {out.dtype} {tuple(out.shape)} is not like y")
    ns = ns.float().reshape(n).contiguous()
    taps = taps.to(y.device, torch.float32).contiguous()
    with torch.cuda.device(y.device):
        status = kb.library().cvt_spatial_message(
            y.data_ptr(), ns.data_ptr(), taps.data_ptr(), taps.shape[0] // 2, c, p, h, w,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kb.check(status, "spatial_message")
    kb.LAUNCHES["spatial_message"] += 1
    return out


def mean_field_step_reference(pair: BilateralPair, q: torch.Tensor, unary: torch.Tensor,
                              ns: torch.Tensor, taps: torch.Tensor, w2, *, h: int, w: int,
                              classes: int) -> torch.Tensor:
    """Plain version of one launch: the pair of the (C, N, N) K and the (C,
    N) g, (C, N, P) float32 q and unaries, the (N, 1) n_s and the taps ->
    the (C, N, P) float32 q of the next iteration."""
    c, n, p = q.shape
    y = (ns.reshape(1, n, 1) * q).transpose(1, 2)
    sp = spatial_message_reference(y, ns, taps, h, w).transpose(1, 2)
    g = pair.g.float().reshape(c, n, 1)
    k, qb = pair.k.float(), (g * q).to(torch.bfloat16).float()
    out = torch.empty_like(q)
    for l0, l1 in lane_groups(p, classes):
        z = g * torch.bmm(k, qb[..., l0:l1]) + w2 * sp[..., l0:l1] - unary[..., l0:l1]
        out[..., l0:l1] = torch.softmax(z.unflatten(-1, (-1, classes)), dim=-1).flatten(-2)
    return out


def _check(pair, q, unary, ns, h, w, classes):
    c, n, p = q.shape
    k, g = pair
    if k.dim() != 3 or tuple(k.shape) != (c, n, n) or n != h * w:
        raise ValueError(f"mean_field_step: want a (C={c}, N={n}, N) K of {h}x{w} frames, got "
                         f"{tuple(k.shape)}")
    if tuple(g.shape) != (c, n):
        raise ValueError(f"mean_field_step: want (C={c}, N={n}) normalizers g, got "
                         f"{tuple(g.shape)}")
    if tuple(unary.shape) != (c, n, p) or ns.numel() != n:
        raise ValueError(f"mean_field_step: unary {tuple(unary.shape)} or n_s "
                         f"{tuple(ns.shape)} does not match q {tuple(q.shape)}")
    if not 0 < classes <= MAX_CLASSES or p % classes:
        raise ValueError(f"mean_field_step: {p} lanes are no whole groups of 1 to "
                         f"{MAX_CLASSES} classes, got {classes}")
    if any(t.device != k.device for t in (g, q, unary, ns)):
        raise ValueError(f"mean_field_step: K on {k.device}, g on {g.device}, q on {q.device}, "
                         f"unary on {unary.device}, n_s on {ns.device}")


def mean_field_steps(pair: BilateralPair, q: torch.Tensor, unary: torch.Tensor,
                     ns: torch.Tensor, taps: torch.Tensor, w2, *, h: int, w: int, classes: int,
                     iters: int) -> torch.Tensor:
    """``iters`` mean-field iterations from q.

    Args:
      pair: the (C, N, N) bilateral kernels K and their (C, N) float32
        normalizers g (B2's :class:`BilateralPair`; a normalized M runs as
        the pair (M, 1)).
      q: (C, N, P) float32, the first iteration's q.
      unary: (C, N, P) float32 unaries.
      ns: the (N, 1) spatial normalizer of ``taps`` (terms.py::_spatial_norm).
      classes: L, the lanes of one softmax group.

    Returns the (C, N, P) float32 marginals. CUDA tensors launch kernel
    ``spatial_message`` and then the step once an iteration (a contiguous
    bf16 K with N % 8 == 0 and C <= 65535), or raise; CPU tensors take the
    plain version."""
    _check(pair, q, unary, ns, h, w, classes)
    if iters < 0:
        raise ValueError(f"mean_field_step: iters={iters} < 0")
    k = pair.k
    if not k.is_cuda:
        for _ in range(iters):
            q = mean_field_step_reference(pair, q, unary, ns, taps, w2, h=h, w=w,
                                          classes=classes)
        return q
    c, n, p = q.shape
    if k.dtype != torch.bfloat16 or not k.is_contiguous():
        raise ValueError(f"mean_field_step: K must be contiguous bf16, got {k.dtype}")
    if n % 8 or c > MAX_LAUNCH_FRAMES:
        raise ValueError(f"mean_field_step: N={n} must divide by 8 and C={c} be at most "
                         f"{MAX_LAUNCH_FRAMES} on CUDA")
    if iters == 0:
        return q
    dev = k.device
    g = pair.g.float().contiguous()
    unary = unary.float().contiguous()
    ns_flat = ns.float().reshape(n).contiguous()
    taps = taps.to(dev, torch.float32).contiguous()
    qb = torch.empty((2, c, p, n), dtype=torch.bfloat16, device=dev)
    y = torch.empty((2, c, p, n), dtype=torch.float32, device=dev)
    out = torch.empty((c, n, p), dtype=torch.float32, device=dev)
    sp = torch.empty((c, p, n), dtype=torch.float32, device=dev)
    qt = q.transpose(1, 2)
    torch.mul(g.reshape(c, 1, n), qt, out=qb[0])  # bf16(g q), as the step writes it
    torch.mul(ns_flat.reshape(1, 1, n), qt, out=y[0])
    lib = kb.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for it in range(iters):
            src, dst = it % 2, 1 - it % 2
            spatial_message(y[src], ns_flat, taps, h=h, w=w, out=sp)
            status = lib.cvt_mean_field_step(
                k.data_ptr(), g.data_ptr(), qb[src].data_ptr(), sp.data_ptr(),
                unary.data_ptr(), ns_flat.data_ptr(), c, n, p, classes, float(w2),
                int(it == iters - 1), qb[dst].data_ptr(), y[dst].data_ptr(), out.data_ptr(),
                stream,
            )
            kb.check(status, "mean_field_step")
            kb.LAUNCHES["mean_field_step"] += 1
    return out
