"""The video cells: ``pipelines/video.py::eval_episode`` over a pool of
seeded episodes, back to back, as ``video --no-gif`` masks an episode
(closed loop: one episode after another, as a researcher masks a
recording).

Set-up makes the weights and the pool from the seed and masks one episode
(every shape the window uses). The window masks episodes until
``--seconds`` have passed; ``video_frames_per_s`` is the frames of every
episode finished over the time from the window's start to the last
finish. A seeded reservoir keeps a sample of the finished episodes; once
the window has closed and the port's models are freed, the plain
reference (reference/video.py) masks the same frames and the numbers of
the check are the worst over the sample:

* ``preds_max_gap``: the largest |score − reference score|;
* ``maps_off_by_2_share``: the share of uint8 map pixels more than one
  level from the reference's;
* ``maps_mean_shift``: |the mean level of the maps − the reference's|, in
  levels (the normalisation's error moves every level one way; rounding
  noise averages out);
* ``thr_mask_mismatch``, ``crf_mask_mismatch``: the shares of mask pixels
  that differ from the reference's.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import time
from typing import Dict

import numpy as np
import torch

from bench_torch import core, traffic, tracing, weights


def _models(cfg: Dict, tr: Dict, seed: int, device):
    from critic_vae_tpu_torch.models.critic import Critic
    from critic_vae_tpu_torch.models.vae import VAE

    critic_sd, vae_sd = weights.make(cfg, seed, device)
    calib, _ = traffic.frames(int(cfg["calibration_frames"]), seed, tr, device)
    weights.calibrate(cfg, critic_sd, vae_sd, calib)
    critic = Critic(tuple(cfg["critic_dims"]), cfg["critic_bottleneck"], cfg["channels"])
    vae = VAE(tuple(cfg["encoder_dims"]), cfg["channels"], cfg["latent_dim"], cfg["bottleneck"])
    for module, sd in ((critic, critic_sd), (vae, vae_sd)):
        weights.load_into(module, sd)
    critic = critic.to(device).eval().requires_grad_(False)
    vae = vae.to(device).eval().requires_grad_(False)
    return critic, vae, critic_sd, vae_sd


@contextlib.contextmanager
def _environment(env: Dict[str, str]):
    """The port's environment variables for the run: the traffic's ``env``
    (such as ``CRITIC_VAE_TPU_CRF_BUILD``, the CRF build), and for the
    control the workload's ``control_env`` (the int8 build)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _check(cell: core.Cell, critic_sd, vae_sd, pool, sample, device) -> Dict[str, float]:
    """The reference over the sampled episodes, and the worst numbers."""
    from bench_torch.reference import video as ref

    cfg, run_crf = cell.config, bool(cell.traffic["run_crf"])
    worst: Dict[str, float] = {}
    for index, res in sample:
        frames = torch.from_numpy(pool[index % len(pool)][0]).to(device)
        want = ref.episode(critic_sd, vae_sd, frames, cfg["threshold"],
                           tuple(cfg["crf_params"]) if run_crf else None,
                           crf_block=int(cell.workload.get("reference_crf_block", 16)))
        maps = res.diff_u8.astype(np.int16) - want["diff_u8"].cpu().numpy().astype(np.int16)
        got = {"preds_max_gap": float(np.max(np.abs(res.preds - want["preds"].cpu().numpy()))),
               "maps_off_by_2_share": float(np.mean(np.abs(maps) > 1)),
               "maps_mean_shift": float(abs(np.mean(maps, dtype=np.float64))),
               "thr_mask_mismatch": float(np.mean(res.thr_masks != want["thr_masks"].cpu().numpy()))}
        if run_crf:
            got["crf_mask_mismatch"] = float(np.mean(res.crf_masks
                                                     != want["crf_masks"].cpu().numpy()))
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
        del want, frames
    return worst


def _episode_kwargs(cell: core.Cell, device, mode: str) -> Dict:
    """``eval_episode``'s arguments: the configuration's, the traffic's
    ``episode_options`` (such as a saliency mask source), and the control's
    bf16 nets."""
    cfg = cell.config
    return dict(device=device, threshold=int(cfg["threshold"]),
                crf_params=tuple(cfg["crf_params"]), run_crf=bool(cell.traffic["run_crf"]),
                batch_size=int(cfg["chunk"]),
                compute_dtype="bfloat16" if mode == "control" else cfg["compute_dtype"],
                crf_backend=cell.workload.get("crf_backend", cfg["crf_backend"]),
                **cell.traffic.get("episode_options", {}))


def run(cell: core.Cell, ctx, mode: str = "program") -> core.Outcome:
    """One run of a video cell (``ctx``: run.py's RunContext). ``mode``
    "control" runs the port's lower-precision paths (calibrate.py)."""
    from critic_vae_tpu_torch.pipelines import video as pv

    device = ctx.device
    tr, wl = cell.traffic, cell.workload
    env = {**tr.get("env", {}), **(wl.get("control_env", {}) if mode == "control" else {})}
    with _environment(env):
        critic, vae, critic_sd, vae_sd = _models(cell.config, tr, ctx.seed, device)
        pool = traffic.episodes(ctx.seed, tr, device)
        kw = _episode_kwargs(cell, device, mode)
        frames_per_episode = int(tr["episode_frames"])
        pv.eval_episode(vae, critic, *pool[0], **kw)  # every shape of the window
        ctx.sync()
        sample = Reservoir(int(wl["sample_episodes"]), ctx.seed)
        outcome = core.Outcome(end_to_end={}, numbers={}, attempted=0, failed=0,
                               memory_peak_bytes=0)
        ctx.window_started()
        if ctx.trace:
            n = int(wl["trace_episodes"])
            with tracing.capture(f"video-{ctx.rank}") as box:
                for k in range(n):
                    sample.offer((k, pv.eval_episode(vae, critic, *pool[k % len(pool)], **kw)))
            outcome.traced = core.Traced(box["trace"], box["window_s"], n,
                                         n * frames_per_episode, cell)
            outcome.busy_s = box["trace"].busy_s()
            outcome.breakdown = box["trace"].breakdown()
            done = n
        elif ctx.units:
            for done in range(ctx.units):
                sample.offer((done, pv.eval_episode(vae, critic, *pool[done % len(pool)], **kw)))
            done = ctx.units
        else:
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            done, last = 0, t0
            while time.perf_counter() < deadline:
                sample.offer((done, pv.eval_episode(vae, critic, *pool[done % len(pool)], **kw)))
                done += 1
                last = time.perf_counter()
            outcome.end_to_end["video_frames_per_s"] = done * frames_per_episode / (last - t0)
        outcome.attempted = done
        outcome.memory_peak_bytes = ctx.memory_peak()
        shares = [(float(r.thr_masks.mean()),
                   float(r.crf_masks.mean()) if r.crf_masks is not None else None)
                  for _, r in sample.items]
        core.log(f"episodes finished: {done} of {frames_per_episode} frames; sampled "
                 f"{[i for i, _ in sample.items]}; mask pixels set (thr, crf): {shares}")
        del critic, vae
        gc.collect()
        ctx.free()
    outcome.numbers = _check(cell, critic_sd, vae_sd, pool, sample.items, device)
    return outcome


def readings(cell: core.Cell, ctx, mode: str) -> Dict[str, float]:
    """The check's numbers for calibrate.py: set-up, then as many episodes
    as a run samples, masked as a run masks them with no timed window, and
    the comparison; ``mode`` "program", "control" or a fault of
    bench_torch/faults.py."""
    from bench_torch import faults

    ctx.units = int(cell.workload["sample_episodes"])
    planted = faults.video(mode) if mode in faults.VIDEO else contextlib.nullcontext()
    with planted:
        return run(cell, ctx, "control" if mode == "control" else "program").numbers
