"""The reference's VAE training step (Critic-VAE ``vae.py:33-66``,
``vae_nets.py:14-19,53-62,150-247``) in plain torch float32 with TF32 off.

One step on a uint8 batch: x = batch / 255; the frozen critic's score;
the train-mode encode (BatchNorm on the batch's statistics, the running
ones moved by momentum 0.1 with the unbiased variance); z = mu + eps ·
exp(logvar / 2); the decode at the score; the loss 1 − MS-SSIM(recon, x)
+ kld_weight · KLD; the gradient by autograd; and Adam (eps outside the
square root, bias-corrected). The MS-SSIM is the published module with its
two quirks: the window's exponent has no minus sign, and the last scale's
SSIM multiplies each of the four contrast terms. Each scale's SSIM and
contrast are floored at 1e-4 before the fractional powers with the
identity's gradient (the port's guard against the NaN that the published
objective gives there; it changes no finite value).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference import exact_float32, nets

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
BUFFERS = ("running_mean", "running_var")


def _window(faithful: bool) -> torch.Tensor:
    x = np.arange(11, dtype=np.float64) - 5
    k = np.exp((1.0 if faithful else -1.0) * x ** 2 / (2.0 * 1.5 ** 2))
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def _blur(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    c = img.shape[1]
    y = F.conv2d(img, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(5, 0), groups=c)
    return F.conv2d(y, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, 5), groups=c)


def msssim_loss(img1: torch.Tensor, img2: torch.Tensor, faithful: bool = True) -> torch.Tensor:
    """1 − MS-SSIM over 5 scales, each scale's SSIM and contrast the mean
    over the whole batch."""
    k = _window(faithful).to(img1.device)
    ssims, css = [], []
    for _ in WEIGHTS:
        mu1, mu2 = _blur(img1, k), _blur(img2, k)
        s1 = _blur(img1 * img1, k) - mu1 * mu1
        s2 = _blur(img2 * img2, k) - mu2 * mu2
        s12 = _blur(img1 * img2, k) - mu1 * mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        v1, v2 = 2.0 * s12 + c2, s1 + s2 + c2
        css.append(torch.mean(v1 / v2))
        ssims.append(torch.mean((2.0 * mu1 * mu2 + c1) * v1 / ((mu1 * mu1 + mu2 * mu2 + c1) * v2)))
        img1, img2 = F.avg_pool2d(img1, 2), F.avg_pool2d(img2, 2)
    w = torch.tensor(WEIGHTS, device=img1.device)

    def floor(v):
        return v + (torch.clamp_min(v, 1e-4) - v).detach()

    pow1 = floor(torch.stack(css)) ** w
    pow2 = floor(torch.stack(ssims)) ** w
    if faithful:
        return 1.0 - torch.prod(pow1[:-1] * pow2[-1])
    return 1.0 - torch.prod(pow1[:-1]) * pow2[-1]


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFERS)


def steps(cfg: Dict, critic_p: Dict, state: Dict[str, torch.Tensor], batches: List[torch.Tensor],
          eps: List[torch.Tensor]) -> Dict:
    """Run len(batches) steps from ``state`` (the VAE's parameters and
    running statistics by name). Returns the per-step losses
    (``total_loss``, ``recon_loss``, ``kld`` lists of floats), the first
    step's gradient by name, and the state after the last step."""
    adam = cfg["adam"]
    lr, b1, b2, e = cfg["learning_rate"], adam["beta1"], adam["beta2"], adam["eps"]
    p = {k: v.detach().clone() for k, v in state.items()}
    names = [k for k in p if not is_buffer(k)]
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses = {"total_loss": [], "recon_loss": [], "kld": []}
    grad1 = None
    with exact_float32():
        for t, (batch, noise) in enumerate(zip(batches, eps), start=1):
            x = batch.float().permute(0, 3, 1, 2) / 255.0
            with torch.no_grad():
                score = nets.critic(critic_p, x)
            leaves = {k: p[k].clone().requires_grad_(True) for k in names}
            q = {**p, **leaves}
            mu, logvar, stats = nets.encoder(q, x, train=True, eps=cfg["bn_eps"],
                                             momentum=cfg["bn_momentum"])
            z = mu + noise * torch.exp(0.5 * logvar)
            recon = nets.decoder(q, z, score)
            recon_loss = msssim_loss(recon, x, cfg["faithful_msssim"])
            kld = cfg["kld_weight"] * torch.mean(
                -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=1))
            total = recon_loss + kld
            grads = torch.autograd.grad(total, [leaves[k] for k in names])
            if not all(torch.isfinite(g).all() for g in grads):
                raise FloatingPointError(f"reference step {t}: a gradient is not finite")
            for key, val in (("total_loss", total), ("recon_loss", recon_loss), ("kld", kld)):
                losses[key].append(float(val.detach()))
            with torch.no_grad():
                if grad1 is None:
                    grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v[k] / (1 - b2 ** t)
                    p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + e)
                for i, (mean, var) in enumerate(stats):
                    p[f"encoder.bns.{i}.running_mean"] = mean.detach()
                    p[f"encoder.bns.{i}.running_var"] = var.detach()
    return {"losses": losses, "grad1": grad1, "state": p}
