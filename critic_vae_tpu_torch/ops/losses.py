"""VAE training losses (counterpart of critic_vae_tpu/ops/losses.py;
reference: vae_nets.py:53-62)."""

from __future__ import annotations

from typing import Dict

import torch

from critic_vae_tpu_torch.ops.msssim import msssim_loss
from critic_vae_tpu_torch.parallel.mesh import global_mean

KLD_WEIGHT = 1e-3  # vae_parameters.py:17


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor, mesh=None) -> torch.Tensor:
    """KL(q(z|x) ‖ N(0, I)) summed over the latent, mean over the batch
    (reference: vae_nets.py:57); with a grouped ``mesh``, over the global
    batch (parallel/mesh.py::global_mean)."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar), dim=1)
    return global_mean(mesh, torch.mean(per_sample))


def vae_loss(x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor, recon: torch.Tensor, *,
             kld_weight: float = KLD_WEIGHT, faithful: bool = True,
             mesh=None) -> Dict[str, torch.Tensor]:
    """MS-SSIM(recon, x) + kld_weight · KLD over NCHW images: scalars
    ``total_loss``, ``recon_loss`` and ``kld`` (already times
    ``kld_weight``). ``mesh``: the inputs are this rank's share of the
    global batch, and the losses are the global batch's, on every rank."""
    recon_loss = msssim_loss(recon, x, faithful=faithful, mesh=mesh)
    kld = kld_loss(mu, logvar, mesh) * kld_weight
    return {"total_loss": recon_loss + kld, "recon_loss": recon_loss, "kld": kld}
