"""The dense CRF's mean field with its bilateral kernel stored as 8 bits
(the port's ``int8`` CRF build, ``CRITIC_VAE_TPU_CRF_BUILD=int8``), in
plain torch float32 with TF32 off: reference/crf.py's mean field with the
bilateral kernel k replaced by its 8-bit value K8/127.

Per frame of N = H·W pixels, with k, Ms, U and Q0 as reference/crf.py
forms them from the same features:

    K8 = round_half_even(127 · k)             (0 on the diagonal; 0 ≤ K8 ≤ 127)
    M  = w1 · diag(n) (K8/127) diag(n),       n = (Σ_j K8[i, j]/127 + 1e-20)^-1/2
    Q  ← softmax(-U + M Q + w2 · Ms Q), ``iters`` times;  label = argmax Q

Departures from reference/crf.py: k is quantised to K8, and M's
normaliser comes from the row sums of the stored values, so that M is the
exactly normalized 8-bit model; nothing else. The port takes the message as
g · (K8 @ bf16(g · Q)) with g = sqrt(w1/127) · n, which is M Q but for the
bf16 rounding of the vector its int8 product takes: that rounding is the
port's arithmetic, not the model's, and is left out here, as reference/crf.py
leaves out the bf16 storage of the ``auto`` build's K. K8 is quantised from
this file's own float32 k, computed as reference/crf.py computes it.
"""

from __future__ import annotations

from typing import Callable

import torch

from bench_torch.reference import crf, exact_float32

QUANT_SCALE = 127.0


def quantised(k: torch.Tensor) -> torch.Tensor:
    """K8/127 of the float32 kernel k in [0, 1): round half to even of
    127 k, as float32 (exact: integers up to 127)."""
    return torch.round(k * QUANT_SCALE) / QUANT_SCALE


@torch.no_grad()
def marginals(frames_u8: torch.Tensor, masks: torch.Tensor, params, block: int = 16,
              quantise: Callable = quantised) -> torch.Tensor:
    """(F, N, 2) float32 marginals Q of (F, H, W, 3) uint8 frames and (F,
    H, W) bool masks; ``params`` (w1, alpha, beta, w2, gamma, iters).
    ``quantise`` maps the dense kernel k to the values M normalizes
    (:func:`quantised`; the identity gives reference/crf.py's model). TF32
    off."""
    with exact_float32():
        return _marginals(frames_u8, masks, params, block, quantise)


def _marginals(frames_u8, masks, params, block, quantise):
    w1, alpha, beta, w2, gamma, iters = params
    f, h, w, _ = frames_u8.shape
    n = h * w
    dev = frames_u8.device
    d2 = crf._sqdist_xy(h, w, dev)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    ms = crf._normalized(torch.where(off, torch.exp(-d2 / (2.0 * float(gamma) ** 2)), 0.0))
    logp = -0.5 * d2 / float(alpha) ** 2
    del d2
    out = torch.empty((f, n, 2), dtype=torch.float32, device=dev)
    for lo in range(0, f, block):
        hi = min(f, lo + block)
        rgb = frames_u8[lo:hi].reshape(hi - lo, n, 3).float() / float(beta)
        drgb = torch.zeros((hi - lo, n, n), dtype=torch.float32, device=dev)
        for c in range(3):
            drgb += (rgb[:, :, None, c] - rgb[:, None, :, c]) ** 2
        k = quantise(torch.where(off, torch.exp(logp - 0.5 * drgb), 0.0))
        del drgb
        m = float(w1) * crf._normalized(k)
        del k
        mask = masks[lo:hi].reshape(hi - lo, n).float()
        probs = torch.stack([1.0 - mask, mask], dim=-1)
        unary = -torch.log(torch.clamp_min(probs, crf.EPS_PROB))
        q = torch.softmax(-unary, dim=-1)
        for _ in range(int(iters)):
            spatial = (ms @ q.permute(1, 0, 2).reshape(n, -1)).view(n, hi - lo, 2).permute(1, 0, 2)
            q = torch.softmax(torch.bmm(m, q) + float(w2) * spatial - unary, dim=-1)
        out[lo:hi] = q
        del m
    return out


def refine(frames_u8: torch.Tensor, masks: torch.Tensor, params, block: int = 16,
           quantise: Callable = quantised) -> torch.Tensor:
    """(F, H, W) bool labels of :func:`marginals` (q_1 > q_0)."""
    f, h, w, _ = frames_u8.shape
    q = marginals(frames_u8, masks, params, block, quantise)
    return (q[..., 1] > q[..., 0]).view(f, h, w)
