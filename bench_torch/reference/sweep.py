"""The reference's threshold sweep (Critic-VAE ``vae.py -video -thresh``,
``vae.py:121-123``): an episode masked at each threshold, scored with and
without the dense CRF, in plain torch float32 with TF32 off.

The maps are reference/video.py's (``episode`` without the CRF). For each
threshold t the masks are ``diff_u8 > t`` and their whole-stack (tp, fn,
fp) against the ground truth are counted. For the CRF each block of frames
builds its dense bilateral matrix M once (reference/crf.py's helpers), and
each threshold then runs its own two-label mean field on that M, one
threshold after another, and its labels are counted the same way.

Departures from the reference's sweep: it re-runs the whole pipeline for
every threshold, where this computes the maps once (the same maps); it
refines each frame's masks with SimpleCRF's ``denseCRF.densecrf``, a
permutohedral-lattice approximation of this mean field
(``vae_utility.py:22-54``), where this forms both kernels densely as the
port's device CRF does (reference/crf.py); and it prints IoUs to 3 digits,
where this returns the counts they divide.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from bench_torch.reference import crf, exact_float32, video


def _counts(gt: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(tp, fn, fp) int64 of bool ``masks`` (F, H, W) against ``gt``."""
    tp = torch.sum(gt & masks)
    return torch.stack([tp, torch.sum(gt & ~masks), torch.sum(~gt & masks)])


@torch.no_grad()
def refined_counts(frames_u8: torch.Tensor, gt: torch.Tensor, thr_masks: torch.Tensor,
                   params, block: int = 16) -> torch.Tensor:
    """(T, 3) counts of each threshold's CRF labels: (F, H, W, 3) uint8
    frames, (F, H, W) bool ``gt``, (T, F, H, W) bool ``thr_masks``;
    ``params`` (w1, alpha, beta, w2, gamma, iters)."""
    w1, alpha, beta, w2, gamma, iters = params
    t_count = thr_masks.shape[0]
    f, h, w, _ = frames_u8.shape
    n = h * w
    dev = frames_u8.device
    d2 = crf._sqdist_xy(h, w, dev)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    ms = crf._normalized(torch.where(off, torch.exp(-d2 / (2.0 * float(gamma) ** 2)), 0.0))
    logp = -0.5 * d2 / float(alpha) ** 2
    del d2
    counts = torch.zeros((t_count, 3), dtype=torch.int64, device=dev)
    for lo in range(0, f, block):
        hi = min(f, lo + block)
        rgb = frames_u8[lo:hi].reshape(hi - lo, n, 3).float() / float(beta)
        drgb = torch.zeros((hi - lo, n, n), dtype=torch.float32, device=dev)
        for c in range(3):
            drgb += (rgb[:, :, None, c] - rgb[:, None, :, c]) ** 2
        m = float(w1) * crf._normalized(torch.where(off, torch.exp(logp - 0.5 * drgb), 0.0))
        del drgb
        for t in range(t_count):
            mask = thr_masks[t, lo:hi].reshape(hi - lo, n).float()
            probs = torch.stack([1.0 - mask, mask], dim=-1)
            unary = -torch.log(torch.clamp_min(probs, crf.EPS_PROB))
            q = torch.softmax(-unary, dim=-1)
            for _ in range(int(iters)):
                spatial = ((ms @ q.permute(1, 0, 2).reshape(n, -1))
                           .view(n, hi - lo, 2).permute(1, 0, 2))
                q = torch.softmax(torch.bmm(m, q) + float(w2) * spatial - unary, dim=-1)
            labels = (q[..., 1] > q[..., 0]).view(hi - lo, h, w)
            counts[t] += _counts(gt[lo:hi], labels)
        del m
    return counts


@torch.no_grad()
def episode(critic_p: Dict, vae_p: Dict, frames_u8: torch.Tensor, gt: torch.Tensor,
            thresholds: Sequence[int], crf_params=None, crf_block: int = 16) -> Dict:
    """The sweep of (L, H, W, 3) uint8 frames with (L, H, W) bool ground
    truth on the device: ``thr_counts`` (T, 3) int64 (tp, fn, fp) of each
    threshold's masks, and with ``crf_params`` ``crf_counts`` (T, 3) of its
    CRF labels."""
    with exact_float32():
        diff_u8 = video.episode(critic_p, vae_p, frames_u8, 0, None)["diff_u8"]
        thr = torch.stack([diff_u8.to(torch.int32) > int(t) for t in thresholds])
        out = {"thr_counts": torch.stack([_counts(gt, m) for m in thr])}
        if crf_params is not None:
            out["crf_counts"] = refined_counts(frames_u8, gt, thr, crf_params, block=crf_block)
    return out
