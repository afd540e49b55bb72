"""The reference's mask pipeline over one episode (Critic-VAE
``eval_textured_frames``), in plain torch float32 with TF32 off: the
critic's score; the encode's mu decoded at the score and at 0; the Rec.601
grey of |tanh decode at 0 − tanh decode at the score| and its per-frame
max; the diff maps normalised by the episode's mean of those maxima and
quantised as ``(d * 255).astype(uint8)`` after the clamp; the masks above
the threshold; and the dense CRF of reference/crf.py."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_torch.reference import crf, exact_float32, nets

REC601 = (0.2989, 0.5870, 0.1140)


@torch.no_grad()
def episode(critic_p: Dict, vae_p: Dict, frames_u8: torch.Tensor, threshold: int,
            crf_params: Optional[tuple], block: int = 512, crf_block: int = 16) -> Dict:
    """Preds (L,), uint8 maps (L, H, W), threshold masks and (with
    ``crf_params``) CRF masks (L, H, W) of (L, H, W, 3) uint8 frames on
    the device, computed ``block`` frames at a time."""
    with exact_float32():
        preds, greys = [], []
        for lo in range(0, frames_u8.shape[0], block):
            x = frames_u8[lo:lo + block].float().permute(0, 3, 1, 2) / 255.0
            p = nets.critic(critic_p, x)
            mu, _ = nets.encoder(vae_p, x)
            one = nets.decoder(vae_p, mu, p)
            zero = nets.decoder(vae_p, mu, torch.zeros_like(p))
            d = torch.abs(zero - one)
            greys.append(d[:, 0] * REC601[0] + d[:, 1] * REC601[1] + d[:, 2] * REC601[2])
            preds.append(p)
        grey = torch.cat(greys)
        mean_max = grey.amax(dim=(1, 2)).mean()
        if mean_max > 0:
            d = torch.minimum(grey, mean_max) * (1.0 / mean_max)
        else:
            d = torch.zeros_like(grey)
        diff_u8 = torch.trunc(d * 255.0).to(torch.uint8)
        thr = diff_u8.to(torch.int32) > int(threshold)
        out = {"preds": torch.cat(preds), "diff_u8": diff_u8, "thr_masks": thr}
        if crf_params is not None:
            out["crf_masks"] = crf.refine(frames_u8, thr, crf_params, block=crf_block)
    return out
