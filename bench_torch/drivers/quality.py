"""The ``--quality`` cells: ``pipelines/video.py::eval_episode`` with the
critic's LayerCAM over six test-time views as the mask source, over a pool
of seeded episodes back to back, as ``video --quality --no-crf --no-gif``
masks an episode.

The run is drivers/video.py's, taken whole (set-up, warm-up, window, traced
slice, sample): this module loads its own instance of that driver and gives
it two functions of its own, the episode's arguments (the configuration's
saliency options) and the check. Its warm-up masks the first episode twice,
where drivers/video.py masks it once: ops/saliency.py captures a chunk
shape's CUDA graphs at its second call, and an episode's tail is a shape of
its own, so one episode would leave the tail's capture to the window. The check compares the
sampled episodes with reference/saliency.py, the plain LayerCAM and views,
on drivers/video.py's numbers:

* ``preds_max_gap``: the largest |score − reference score|;
* ``maps_off_by_2_share``: the share of uint8 map pixels more than one
  level from the reference's;
* ``maps_mean_shift``: |the mean level of the maps − the reference's|, in
  levels;
* ``thr_mask_mismatch``: the share of threshold-mask pixels that differ
  from the reference's.

``readings`` (calibrate.py) runs ``program``, ``control`` (the saliency
stage with TF32 allowed, the nearest precision below its float32) or one
of two faults planted in the port for the run: ``no_mirror`` (the mirror
views left out of the minimum) and ``finite_border`` (the columns a view's
roll wrapped round left finite).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from bench_torch import core

MODES = ("program", "control", "no_mirror", "finite_border")
SALIENCY_KEYS = ("method", "cam_block", "cam_upsample", "tta_flip", "tta_shift")

_video = core.driver("video")


def _episode_kwargs(cell: core.Cell, device, mode: str) -> Dict:
    """``eval_episode``'s arguments: the configuration's chain."""
    cfg = cell.config
    return dict(device=device, threshold=int(cfg["threshold"]),
                crf_params=tuple(cfg["crf_params"]), run_crf=bool(cell.traffic["run_crf"]),
                batch_size=int(cfg["chunk"]), compute_dtype=cfg["compute_dtype"],
                mask_source=cfg["mask_source"],
                saliency_opts={k: cfg[k] for k in SALIENCY_KEYS})


def _check(cell: core.Cell, critic_sd, vae_sd, pool, sample, device) -> Dict[str, float]:
    """The reference over the sampled episodes, and the worst numbers."""
    from bench_torch.reference import saliency as ref

    cfg = cell.config
    worst: Dict[str, float] = {}
    for index, res in sample:
        frames = torch.from_numpy(pool[index % len(pool)][0]).to(device)
        want = ref.episode(critic_sd, frames, cfg["threshold"], block=int(cfg["cam_block"]),
                           flip=bool(cfg["tta_flip"]), shift=int(cfg["tta_shift"]),
                           chunk=int(cfg["chunk"]))
        want = {k: v.cpu().numpy() for k, v in want.items()}
        maps = res.diff_u8.astype(np.int16) - want["diff_u8"].astype(np.int16)
        got = {"preds_max_gap": float(np.max(np.abs(res.preds - want["preds"]))),
               "maps_off_by_2_share": float(np.mean(np.abs(maps) > 1)),
               "maps_mean_shift": float(abs(np.mean(maps, dtype=np.float64))),
               "thr_mask_mismatch": float(np.mean(res.thr_masks != want["thr_masks"]))}
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
        del want, frames
    return worst


_video._episode_kwargs = _episode_kwargs
_video._check = _check


@contextlib.contextmanager
def _warm_up_twice():
    """``eval_episode``'s first call, drivers/video.py's warm-up episode,
    made twice, so that every chunk shape of the window has been called
    twice before it opens."""
    from critic_vae_tpu_torch.pipelines import video as pv

    once = pv.eval_episode

    def twice(*args, **kwargs):
        pv.eval_episode = once
        once(*args, **kwargs)
        return once(*args, **kwargs)

    pv.eval_episode = twice
    try:
        yield
    finally:
        pv.eval_episode = once


def run(cell: core.Cell, ctx, mode: str = "program") -> core.Outcome:
    """One run of a quality cell (``ctx``: run.py's RunContext)."""
    with _warm_up_twice():
        return _video.run(cell, ctx, mode)


@contextlib.contextmanager
def _tf32():
    """TF32 allowed in cuDNN's convs and in matmuls for the body."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


class _FiniteBorder:
    """``torch`` as ops/saliency.py sees it under ``finite_border``: its
    ``where`` keeps the map where the border would put +inf."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def where(cond, a, b):
        if isinstance(a, float) and math.isinf(a):
            return b
        return torch.where(cond, a, b)


@contextlib.contextmanager
def _planted(mode: str):
    """The port as ``mode`` runs it, restored on exit."""
    from critic_vae_tpu_torch.ops import saliency

    if mode == "program":
        yield
        return
    if mode == "control":
        name, value = "no_tf32", _tf32
    elif mode == "no_mirror":
        orig = saliency.critic_saliency
        name, value = "critic_saliency", lambda *a, **kw: orig(*a, **{**kw, "tta_flip": False})
    elif mode == "finite_border":
        name, value = "torch", _FiniteBorder()
    else:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    old = getattr(saliency, name)
    setattr(saliency, name, value)
    try:
        yield
    finally:
        setattr(saliency, name, old)


def readings(cell: core.Cell, ctx, mode: str) -> Dict[str, float]:
    """The check's numbers for calibrate.py: set-up, then as many episodes
    as a run samples, masked as a run masks them with no timed window, and
    the comparison; ``mode`` one of :data:`MODES`."""
    ctx.units = int(cell.workload["sample_episodes"])
    with _planted(mode):
        return run(cell, ctx).numbers
