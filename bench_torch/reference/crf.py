"""The dense CRF's mean field (Krähenbühl and Koltun, 2011, with the
reference's parameters ``vae_utility.py:25-30``), in plain torch float32,
dense in both kernels.

Per frame of N = H·W pixels, features (x, y)/alpha and rgb/beta:

    K[i, j]  = exp(-|Δxy|²/2 - |Δrgb|²/2)   for i ≠ j, 0 on the diagonal
    M        = w1 · diag(n) K diag(n),        n = (Σ_j K[i, j] + 1e-20)^-1/2
    Ks[i, j] = exp(-|Δxy|²/(2 gamma²))        for i ≠ j, 0 on the diagonal
    Ms       = diag(ns) Ks diag(ns),          ns likewise
    Q0 = softmax(-U),  U = -log(max(p, 1e-8)),  p = (1 - mask, mask)
    Q  ← softmax(-U + M Q + w2 · Ms Q), ``iters`` times;  label = argmax Q

Both kernels are formed as full N × N matrices (the spatial one is shared
by every frame), frames a block at a time so that the matrices fit.
"""

from __future__ import annotations

import torch

EPS_PROB = 1e-8
EPS_NORM = 1e-20


def _sqdist_xy(h: int, w: int, device) -> torch.Tensor:
    """(N, N) squared pixel distances, exact in float32."""
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    return (x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2


def _normalized(k: torch.Tensor) -> torch.Tensor:
    """diag(n) K diag(n) over the last two axes, n = rsqrt(row sums + eps)."""
    n = torch.rsqrt(k.sum(dim=-1) + EPS_NORM)
    return n[..., :, None] * k * n[..., None, :]


def refine(frames_u8: torch.Tensor, masks: torch.Tensor, params, block: int = 16) -> torch.Tensor:
    """(F, H, W) bool labels of (F, H, W, 3) uint8 frames and (F, H, W)
    bool masks; ``params`` (w1, alpha, beta, w2, gamma, iters)."""
    w1, alpha, beta, w2, gamma, iters = params
    f, h, w, _ = frames_u8.shape
    n = h * w
    dev = frames_u8.device
    d2 = _sqdist_xy(h, w, dev)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    ms = _normalized(torch.where(off, torch.exp(-d2 / (2.0 * float(gamma) ** 2)), 0.0))
    logp = -0.5 * d2 / float(alpha) ** 2
    del d2
    out = torch.empty((f, n), dtype=torch.bool, device=dev)
    for lo in range(0, f, block):
        hi = min(f, lo + block)
        rgb = frames_u8[lo:hi].reshape(hi - lo, n, 3).float() / float(beta)
        drgb = torch.zeros((hi - lo, n, n), dtype=torch.float32, device=dev)
        for c in range(3):
            drgb += (rgb[:, :, None, c] - rgb[:, None, :, c]) ** 2
        m = float(w1) * _normalized(torch.where(off, torch.exp(logp - 0.5 * drgb), 0.0))
        del drgb
        mask = masks[lo:hi].reshape(hi - lo, n).float()
        probs = torch.stack([1.0 - mask, mask], dim=-1)
        unary = -torch.log(torch.clamp_min(probs, EPS_PROB))
        q = torch.softmax(-unary, dim=-1)
        for _ in range(int(iters)):
            spatial = (ms @ q.permute(1, 0, 2).reshape(n, -1)).view(n, hi - lo, 2).permute(1, 0, 2)
            q = torch.softmax(torch.bmm(m, q) + float(w2) * spatial - unary, dim=-1)
        out[lo:hi] = q[..., 1] > q[..., 0]
        del m
    return out.view(f, h, w)
