"""Kernel B5: the resident-matrix dense-CRF mean field (``build="vmem"``).

Counterpart of critic_vae_tpu/crf/fused_resident.py::mean_field_resident.
Per frame of N pixels, with T (neg, pos) class pairs riding as P = 2T lanes
(T = 1 for one mask, T = 13 for the reference's threshold sweep):

    k      = where(logp < 0, exp(logp + logc), 0)          bilateral, f32
    nb_i   = sqrt(w1) * rsqrt(sum_j k[i,j] + 1e-20)
    ks     = where(logs < 0, exp(logs), 0)                 spatial, from xy/gamma
    M      = bf16((nb_i nb_j) f32(bf16(k)) + ((sqrt(w2) ns_i)(sqrt(w2) ns_j)) ks)
    U      = -log(max(p, 1e-8)),  q0 = pair_softmax(-U)
    q     <- pair_softmax(M @ bf16(q) - U)                 iters times

with ``pair_softmax(z)[2t+s] = sigmoid(z[2t+s] - z[2t+1-s])`` (the 2-class
softmax) and ``ns = rsqrt(sep_conv(1) - 1 + 1e-20)`` of the truncated
spatial taps. The spatial term lives inside M, so an iteration is one
product and no separable conv. Labels are ``q_pos > q_neg``.

The CUDA kernel is ``csrc/mean_field_resident.cu``;
:func:`mean_field_resident_reference` is its plain version and
:func:`resident_matrix_reference` the plain version of its M. M is bitwise
symmetric, so the kernel builds it with B2's symmetric-tile build (each
distinct entry once); its iterations run M @ bf16(q) on the tensor cores,
q padded to a multiple of 8 lanes. The JAX kernel
takes its column normalizer from column sums, accumulated in another order
than the row sums; K is symmetric, so both versions here use the row sums
for both (an f32 rounding difference in nb, far inside the tolerances the
tests state).
"""

from __future__ import annotations

import torch

from critic_vae_tpu_torch.crf.fused_build import (
    TILE,
    _check_frames,
    _f32,
    bilateral_k,
    build_scratch,
    row_sum_slots,
)
from critic_vae_tpu_torch.crf.terms import _EPS_NORM, _EPS_PROB, _coords, _spatial_norm
from critic_vae_tpu_torch.kernels import build as kb

# The JAX kernel keeps the whole (N, N) bf16 matrix in the 128 MiB VMEM of a
# TPU v5e core, which holds it up to N = 4096 (64x64). The port's workspace
# lives in device memory and has no such bound; the limit is kept, as the
# JAX package's ``_resolve_build`` enforces it, until the H100 design is
# measured beyond 64x64 (ROADMAP G.1).
MAX_RESIDENT_N = 4096


def _q_lanes(lanes: int) -> int:
    """Lanes of the kernel's bf16 q: ``lanes`` padded to a multiple of 8,
    the n-tile of the tensor-core product (2 -> 8, 26 -> 32)."""
    return -(-lanes // 8) * 8


# per-pixel planes of B5's build: x, y, r, g, b, nb, sqrt(w2) ns, x/gamma, y/gamma
B5_PLANES = 9


def _workspace(frames: int, n: int, lanes: int, device) -> dict:
    """The device buffers :func:`mean_field_resident` allocates besides its
    float32 copy of the probabilities: the build's scratch (per-pixel planes
    and row-sum partials), the bf16 M, the unary, two bf16 q of ``_q_lanes``
    lanes (lane-major, the product's B operand) and the f32 marginals."""
    feat, part = build_scratch(frames, n, B5_PLANES, device)
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "feat": feat,
        "part": part,
        "m": torch.empty((frames, n, n), dtype=bf16, device=device),
        "unary": torch.empty((frames, n, lanes), dtype=f32, device=device),
        "qb": torch.empty((2, frames, _q_lanes(lanes), n), dtype=bf16, device=device),
        "out": torch.empty((frames, n, lanes), dtype=f32, device=device),
    }


def workspace_bytes(frames: int, n: int, lanes: int) -> int:
    """Device bytes :func:`mean_field_resident` allocates for a chunk of
    ``frames``: per frame the bf16 M, the build's 9 per-pixel planes (N
    padded to whole tiles) and row-sum partials (one a 64-column tile), three
    f32 (N, lanes) buffers (probabilities, unary, marginals) and two bf16
    (lanes padded to 8, N) q. At 64x64 that is 34.7 MB a frame plus ~0.12 MB
    a lane pair."""
    slots = row_sum_slots(n)
    return frames * (2 * n * n + 4 * B5_PLANES * slots * TILE + 4 * slots * n
                     + 12 * n * lanes + 4 * n * _q_lanes(lanes))


def pair_softmax(z: torch.Tensor) -> torch.Tensor:
    """sigmoid(z[..., 2t+s] - z[..., 2t+1-s]) over (neg, pos) lane pairs."""
    zp = z.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.sigmoid(z - zp)


def _check(imgs_u8, probs_pairs, h, w):
    _check_frames("mean_field_resident", imgs_u8, h, w)
    c, n, _ = imgs_u8.shape
    if (probs_pairs.dim() != 3 or probs_pairs.shape[:2] != (c, n)
            or probs_pairs.shape[2] % 2 or probs_pairs.shape[2] == 0):
        raise ValueError(
            f"mean_field_resident: want (C={c}, N={n}, 2T) probabilities, got "
            f"{tuple(probs_pairs.shape)}"
        )
    if probs_pairs.device != imgs_u8.device:
        raise ValueError(
            f"mean_field_resident: frames on {imgs_u8.device}, probs on {probs_pairs.device}"
        )


def resident_matrix_reference(imgs_u8, taps, w1, w2, alpha, beta, gamma, *, h: int, w: int,
                              row_block: int = 512):
    """Yield (frame, M) for each of the (C, N, 3) uint8 frames: kernel B5's
    (N, N) matrix, the bilateral and spatial terms, as float32 holding bf16
    values. The buffer is reused from frame to frame."""
    c, n, _ = imgs_u8.shape
    dev = imgs_u8.device
    sw1, sw2 = torch.sqrt(_f32(w1, dev)), torch.sqrt(_f32(w2, dev))
    gs = sw2 * _spatial_norm(taps.to(dev), h, w).reshape(-1)  # (N,)
    pg = _coords(h, w, dev) / _f32(gamma, dev)
    m = torch.empty((n, n), dtype=torch.float32, device=dev)
    for ci, k in bilateral_k(imgs_u8, alpha, beta, h=h, w=w, row_block=row_block):
        nb = sw1 * torch.rsqrt(k.sum(dim=1) + _EPS_NORM)
        for r0 in range(0, n, row_block):
            r1 = min(n, r0 + row_block)
            dg = pg[r0:r1, None, :] - pg[None, :, :]
            logs = -0.5 * (dg[..., 0] * dg[..., 0] + dg[..., 1] * dg[..., 1])
            ks = torch.where(logs < 0.0, torch.exp(logs), 0.0)
            kbf = k[r0:r1].to(torch.bfloat16).float()
            mb = (nb[r0:r1, None] * nb[None, :]) * kbf
            ms = (gs[r0:r1, None] * gs[None, :]) * ks
            m[r0:r1] = (mb + ms).to(torch.bfloat16).float()
        yield ci, m


def mean_field_resident_reference(imgs_u8, probs_pairs, taps, w1, w2, alpha, beta, gamma,
                                  *, h: int, w: int, iters: int,
                                  row_block: int = 512) -> torch.Tensor:
    """Plain PyTorch version of :func:`mean_field_resident`, one frame at a
    time (one (N, N) M in float32 holding bf16 values)."""
    unary = -torch.log(torch.clamp_min(probs_pairs.float(), _EPS_PROB))
    out = torch.empty_like(unary)
    for ci, m in resident_matrix_reference(imgs_u8, taps, w1, w2, alpha, beta, gamma, h=h,
                                           w=w, row_block=row_block):
        q = pair_softmax(-unary[ci])
        for _ in range(iters):
            q = pair_softmax(m @ q.to(torch.bfloat16).float() - unary[ci])
        out[ci] = q
    return out


def mean_field_resident(imgs_u8, probs_pairs, taps, w1, w2, alpha, beta, gamma, *,
                        h: int, w: int, iters: int) -> torch.Tensor:
    """Resident-matrix mean field over a chunk.

    Args:
      imgs_u8: (C, N, 3) uint8 frames.
      probs_pairs: (C, N, 2T) float32, T (neg, pos) class pairs per pixel
        refined against the one matrix.
      taps: (K,) spatial Gaussian taps (for the closed-form normalizer).

    Returns (C, N, 2T) float32 marginals. CUDA tensors launch kernel B5 (N
    must divide by 8) or raise; CPU tensors take the plain version."""
    _check(imgs_u8, probs_pairs, h, w)
    if imgs_u8.device.type == "cpu":
        return mean_field_resident_reference(imgs_u8, probs_pairs, taps, w1, w2, alpha,
                                              beta, gamma, h=h, w=w, iters=iters)
    c, n, _ = imgs_u8.shape
    if n % 8:
        raise ValueError(f"mean_field_resident: N={n} must divide by 8 on CUDA")
    if iters < 0:
        raise ValueError(f"mean_field_resident: iters={iters} < 0")
    dev = imgs_u8.device
    probs = probs_pairs.float().contiguous()
    p = probs.shape[2]
    ns = _spatial_norm(taps.to(dev), h, w).reshape(-1)
    ws = _workspace(c, n, p, dev)
    lib = kb.library()
    with torch.cuda.device(dev):
        status = lib.cvt_mean_field_resident(
            imgs_u8.data_ptr(), probs.data_ptr(), ns.data_ptr(), c, n, w, p, float(w1),
            float(w2), float(alpha), float(beta), float(gamma), int(iters),
            *(ws[k].data_ptr() for k in ("feat", "part", "m", "unary", "qb", "out")),
            torch.cuda.current_stream().cuda_stream,
        )
    kb.check(status, "mean_field_resident")
    kb.LAUNCHES["mean_field_resident"] += 1
    return ws["out"]
