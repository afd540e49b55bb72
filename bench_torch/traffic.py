"""The one traffic generator: seeded MineRL-like frames made on the device.

The scene is the port's ``data/synthetic.py::generate_frames`` (copied
from there, itself a copy of the JAX package's): a sky over grass split at
a jittered horizon, per-pixel noise of ±10 levels, and in a share of the
frames one or two brown trunks, each with a leaf canopy above it that is
not ground truth (a later trunk's canopy may cover an earlier trunk, whose
ground truth stays). That generator draws frame by frame on the host; this
one draws every frame's parameters at once from a ``torch.Generator`` on
the device and paints all frames together, so 50,000 frames take well under
a second. The draws differ from the host generator's, the distribution of
scenes is the same.

A traffic file (``traffic/<name>.json``) holds the parameters:
``frame_size``, ``trunk_fraction`` and either an episode pool
(``episode_frames``, ``pool_episodes``, ``run_crf``, and optionally the
port's environment ``env`` and further ``episode_options`` of
``eval_episode``) or a training set (``dataset_frames``, ``batch_size``,
``ranks``, ``shard_dataset``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

SKY = (120, 167, 255)
GRASS = (96, 140, 56)
TRUNK = (103, 82, 49)
LEAVES = (45, 90, 30)
RENDER_BLOCK = 8192  # frames painted at once: bounds the int16 temporaries


def _ints(gen, low: int, high, n: int, device) -> torch.Tensor:
    """n integers uniform in [low, high), ``high`` a scalar or (n,) tensor."""
    if isinstance(high, int):
        return torch.randint(low, high, (n,), generator=gen, device=device)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    high = torch.as_tensor(high, device=device, dtype=torch.float64)
    return (low + torch.floor(u * (high - low))).long()


def frames(n: int, seed: int, traffic: Dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames uint8 (n, S, S, 3), ground truth bool (n, S, S)) on
    ``device``, drawn from ``seed``."""
    size = int(traffic["frame_size"])
    share = float(traffic["trunk_fraction"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    horizon = torch.clamp(size // 2 + _ints(gen, -6, 7, n, device), min=3)
    has = torch.rand(n, generator=gen, device=device) < share
    n_trunks = _ints(gen, 1, 3, n, device)
    trunks = []
    for t in range(2):
        cx = _ints(gen, 6, size - 6, n, device)
        half_w = _ints(gen, 2, 5, n, device)
        top = _ints(gen, 2, horizon, n, device)
        tint = _ints(gen, -8, 9, 3 * n, device).view(n, 3)
        trunks.append((has & (n_trunks > t), cx, half_w, top, tint))
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    gt = torch.zeros((n, size, size), dtype=torch.bool, device=device)
    rows = torch.arange(size, device=device)
    for lo in range(0, n, RENDER_BLOCK):
        hi = min(n, lo + RENDER_BLOCK)
        b = hi - lo
        hz = horizon[lo:hi, None, None]
        r = rows[None, :, None]
        c = rows[None, None, :]
        sky = (r < hz).expand(b, size, size)
        img = torch.where(sky[..., None], torch.tensor(SKY, device=device, dtype=torch.int16),
                          torch.tensor(GRASS, device=device, dtype=torch.int16))
        img = (img + torch.randint(-10, 11, (b, size, size, 3), generator=gen, device=device,
                                   dtype=torch.int16)).clamp(0, 255)
        g = gt[lo:hi]
        for active, cx, half_w, top, tint in trunks:
            act = active[lo:hi, None, None]
            x0 = (cx[lo:hi] - half_w[lo:hi]).clamp(min=0)[:, None, None]
            x1 = (cx[lo:hi] + half_w[lo:hi]).clamp(max=size)[:, None, None]
            tp = top[lo:hi, None, None]
            cols = (c >= x0) & (c < x1)
            body = act & (r >= tp) & cols
            colour = (torch.tensor(TRUNK, device=device, dtype=torch.int16)
                      + tint[lo:hi].to(torch.int16))[:, None, None, :]
            img = torch.where(body[..., None], colour, img)
            g |= body
            ly0 = (tp - 10).clamp(min=0)
            lx0, lx1 = (x0 - 6).clamp(min=0), (x1 + 6).clamp(max=size)
            canopy = (act & (r >= ly0) & (r < tp) & (c >= lx0) & (c < lx1)
                      & (torch.rand((b, size, size), generator=gen, device=device) < 0.7))
            img = torch.where(canopy[..., None],
                              torch.tensor(LEAVES, device=device, dtype=torch.int16), img)
        out[lo:hi] = img.clamp(0, 255).to(torch.uint8)
    return out, gt


def episodes(seed: int, traffic: Dict, device) -> List[Tuple]:
    """The pool of ``pool_episodes`` episodes of ``episode_frames`` frames,
    each (frames uint8 (L, S, S, 3), ground truth bool (L, S, S)) as numpy
    arrays on the host, where the video pipeline takes them."""
    pool, length = int(traffic["pool_episodes"]), int(traffic["episode_frames"])
    f, g = frames(pool * length, seed, traffic, device)
    f, g = f.cpu().numpy(), g.cpu().numpy()
    return [(f[i * length:(i + 1) * length], g[i * length:(i + 1) * length])
            for i in range(pool)]


def dataset(seed: int, traffic: Dict, device) -> torch.Tensor:
    """The ``dataset_frames`` uint8 training frames on ``device``."""
    return frames(int(traffic["dataset_frames"]), seed, traffic, device)[0]
