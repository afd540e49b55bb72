"""Nearest ×2 upsample + 5×5 SAME conv by phase decomposition, NCHW/OIHW
(counterpart of critic_vae_tpu/ops/upconv.py).

Nearest upsampling repeats each pixel 2×2, so a 5×5 conv over the upsampled
image is, for each output phase (a, b) ∈ {0, 1}², a 3×3 conv over the small
image padded by 1, whose taps are sums of the original ones: along a row,
(w0+w1, w2+w3, w4) for phase 0 and (w0, w1+w2, w3+w4) for phase 1, the same
along a column. 9 MACs an output instead of 25, and the upsampled tensor is
never formed.

Here the four phases are one 3×3 conv with 4·C_out output channels, output
channel ``4c + 2a + b`` holding phase (a, b) of channel c, which is the
order ``F.pixel_shuffle(·, 2)`` interleaves. It is a plain conv (cuDNN on a
card), as the JAX package's four phase convs are XLA convs.

Rounding follows the JAX package. Its ``_phase_kernels`` is a three-operand
einsum on weights already in the activation dtype, which XLA runs as two
contractions, rows (dy) first, each rounded to that dtype: in bfloat16 a
tap is ``round(round(w[dy1, dx] + w[dy2, dx]) + ...)``. The bias is added
after the interleave, in x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# per phase, the original taps summed into each of the three phase taps
_TAPS = (((0, 1), (2, 3), (4,)), ((0,), (1, 2), (3, 4)))


def _collapse(w: torch.Tensor, dim: int, phase: int) -> torch.Tensor:
    """Sum ``w``'s 5 taps along ``dim`` into the 3 of ``phase``, each sum of
    two in w's dtype (one rounding, as XLA's 0/1 contraction)."""
    parts = []
    for group in _TAPS[phase]:
        s = w.select(dim, group[0])
        for d in group[1:]:
            s = s + w.select(dim, d)
        parts.append(s)
    return torch.stack(parts, dim=dim)


def phase_kernels(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 5, 5) → (2, 2, C_out, C_in, 3, 3) phase kernels, in w's
    dtype: rows collapsed (and rounded) first, then columns."""
    rows = [_collapse(w, 2, a) for a in (0, 1)]
    return torch.stack([torch.stack([_collapse(r, 3, b) for b in (0, 1)]) for r in rows])


def phase_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C_out, C_in, 5, 5) → the (4·C_out, C_in, 3, 3) weight of the one 3×3
    conv, phase kernels of w cast to ``dtype``, output channel 4c + 2a + b
    holding phase (a, b) of channel c."""
    cout, cin = w.shape[:2]
    return phase_kernels(w.to(dtype)).permute(2, 0, 1, 3, 4, 5).reshape(4 * cout, cin, 3, 3)


def upsample2_conv5(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    w4: torch.Tensor | None = None) -> torch.Tensor:
    """``conv5_same(nearest_upsample2(x), w) + b`` without the upsample: x
    (B, C_in, H, W), w (C_out, C_in, 5, 5), b (C_out,) → (B, C_out, 2H, 2W)
    in x's dtype. ``w4``: ``phase_weight(w, x.dtype)``, for a caller that
    keeps it across calls (the frozen decoder does); else built here."""
    if w4 is None:
        w4 = phase_weight(w, x.dtype)
    y = F.pixel_shuffle(F.conv2d(x, w4, padding=1), 2)
    return y + b.to(x.dtype)[:, None, None]
