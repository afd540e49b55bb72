"""The int8 CRF cell: ``pipelines/video.py::eval_episode`` over a pool of
seeded episodes, back to back, as ``CRITIC_VAE_TPU_CRF_BUILD=int8 video
--no-gif`` masks an episode, the device CRF's bilateral kernel stored as 8
bits (kernels B3 and B4).

The run is drivers/video.py's, with the port's CRF build set from the
configuration's ``crf_build`` for the whole run: set-up makes the weights
and the pool from the seed and masks one episode (every shape the window
uses); the window masks episodes until ``--seconds`` have passed;
``video_frames_per_s`` is the frames of every episode finished over the
time from the window's start to the last finish; ``--trace 1`` traces
``trace_episodes`` episodes instead. It takes that module's ``_models``,
``_environment``, ``Reservoir`` and ``_episode_kwargs`` from its own
instance of the module and changes none of them. A seeded reservoir keeps
a sample of the finished episodes; once the window has closed and the
port's models are freed, the plain references mask the same frames, and
the numbers of the check are the worst over the sample:

* ``preds_max_gap``, ``maps_off_by_2_share``, ``maps_mean_shift``,
  ``thr_mask_mismatch``: the nets' numbers, as drivers/video.py takes them
  against reference/video.py;
* ``crf_mask_mismatch``: the share of the CRF's mask pixels that differ
  from those of reference/crf_int8.py (the 8-bit model's dense mean field)
  on the reference's threshold masks, end to end;
* ``crf_own_masks_mismatch``: the same share, the 8-bit reference run on
  the port's own threshold masks: the CRF's difference alone, without the
  nets' masks' own;
* ``wrong_build_chunks``: the device CRF's chunks in the window that did
  not run the ``int8`` build: those ``crf/device.py::BUILDS`` counts under
  another build, and those it does not count at all (an episode's chunks of
  ``crf_frames_per_launch`` frames, a CRF that ran elsewhere). An
  environment that did not reach the port shows here.

``readings`` (calibrate.py) runs one of :data:`MODES`: ``program``;
``control``, the nets in bf16; ``half_mean`` of bench_torch/faults.py; and
faults planted here in the port: ``iters_short`` (the mean field one
iteration short), ``diagonal_in_rowsum`` (the 8-bit normalizers from row
sums that count the diagonal's 127, which the product leaves out) and
``k8_frames_rolled`` (each frame's message taken with the next frame's K8
and row sums in its chunk).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from bench_torch import core, faults, traffic, tracing

MODES = ("program", "control", "half_mean", "iters_short", "diagonal_in_rowsum",
         "k8_frames_rolled")

_video = core.driver("video")


def _mismatch(got: np.ndarray, want: torch.Tensor) -> float:
    return float(np.mean(got != want.cpu().numpy()))


def _check(cell: core.Cell, critic_sd, vae_sd, pool, sample, device) -> Dict[str, float]:
    """The references over the sampled episodes, and the worst numbers."""
    from bench_torch.reference import crf_int8
    from bench_torch.reference import video as ref

    cfg = cell.config
    params, block = tuple(cfg["crf_params"]), int(cell.workload.get("reference_crf_block", 16))
    worst: Dict[str, float] = {}
    for index, res in sample:
        frames = torch.from_numpy(pool[index % len(pool)][0]).to(device)
        want = ref.episode(critic_sd, vae_sd, frames, cfg["threshold"], None)
        maps = res.diff_u8.astype(np.int16) - want["diff_u8"].cpu().numpy().astype(np.int16)
        own = torch.from_numpy(res.thr_masks).to(device)
        got = {"preds_max_gap": float(np.max(np.abs(res.preds - want["preds"].cpu().numpy()))),
               "maps_off_by_2_share": float(np.mean(np.abs(maps) > 1)),
               "maps_mean_shift": float(abs(np.mean(maps, dtype=np.float64))),
               "thr_mask_mismatch": _mismatch(res.thr_masks, want["thr_masks"]),
               "crf_mask_mismatch": _mismatch(
                   res.crf_masks, crf_int8.refine(frames, want["thr_masks"], params, block)),
               "crf_own_masks_mismatch": _mismatch(
                   res.crf_masks, crf_int8.refine(frames, own, params, block))}
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
        del want, frames, own
    return worst


def _wrong_chunks(builds: Dict[str, Dict[str, int]], episodes: int, cell: core.Cell) -> float:
    """The window's chunks that the device CRF did not refine as the
    configuration's build: counted under another, or not counted at all."""
    frames = int(cell.traffic["episode_frames"])
    want = episodes * math.ceil(frames / min(frames, int(cell.config["crf_frames_per_launch"])))
    build = cell.config["crf_build"]
    other = sum(c["chunks"] for b, c in builds.items() if b != build)
    return float(other + max(0, want - builds[build]["chunks"]))


def run(cell: core.Cell, ctx, mode: str = "program") -> core.Outcome:
    """One run of the int8 CRF cell (``ctx``: run.py's RunContext). ``mode``
    "control" runs the nets in bf16 (calibrate.py)."""
    from critic_vae_tpu_torch.crf import device as crf_device
    from critic_vae_tpu_torch.pipelines import video as pv

    if not hasattr(crf_device, "BUILDS"):
        raise SystemExit("crf/device.py counts no CRF builds (BUILDS): this program cannot "
                         "show that its chunks ran the configuration's build")
    device = ctx.device
    tr, wl = cell.traffic, cell.workload
    env = {**tr.get("env", {}), crf_device.BUILD_ENV: cell.config["crf_build"]}
    with _video._environment(env):
        critic, vae, critic_sd, vae_sd = _video._models(cell.config, tr, ctx.seed, device)
        pool = traffic.episodes(ctx.seed, tr, device)
        kw = _video._episode_kwargs(cell, device, mode)
        frames_per_episode = int(tr["episode_frames"])

        def mask(k: int):
            return pv.eval_episode(vae, critic, *pool[k % len(pool)], **kw)

        mask(0)  # every shape of the window
        ctx.sync()
        sample = _video.Reservoir(int(wl["sample_episodes"]), ctx.seed)
        outcome = core.Outcome(end_to_end={}, numbers={}, attempted=0, failed=0,
                               memory_peak_bytes=0)
        ctx.window_started()
        crf_device.reset_builds()
        if ctx.trace:
            n = int(wl["trace_episodes"])
            with tracing.capture(f"video-int8-{ctx.rank}") as box:
                for k in range(n):
                    sample.offer((k, mask(k)))
            outcome.traced = core.Traced(box["trace"], box["window_s"], n,
                                         n * frames_per_episode, cell)
            outcome.busy_s = box["trace"].busy_s()
            outcome.breakdown = box["trace"].breakdown()
            done = n
        elif ctx.units:
            for done in range(ctx.units):
                sample.offer((done, mask(done)))
            done = ctx.units
        else:
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            done, last = 0, t0
            while time.perf_counter() < deadline:
                sample.offer((done, mask(done)))
                done += 1
                last = time.perf_counter()
            outcome.end_to_end["video_frames_per_s"] = done * frames_per_episode / (last - t0)
        builds = {b: dict(c) for b, c in crf_device.BUILDS.items()}
        outcome.attempted = done
        outcome.memory_peak_bytes = ctx.memory_peak()
        shares = [(float(r.thr_masks.mean()), float(r.crf_masks.mean()))
                  for _, r in sample.items]
        core.log(f"episodes finished: {done} of {frames_per_episode} frames; CRF chunks by "
                 f"build {builds}; sampled {[i for i, _ in sample.items]}; mask pixels set "
                 f"(thr, crf): {shares}")
        del critic, vae
        gc.collect()
        ctx.free()
    outcome.numbers = _check(cell, critic_sd, vae_sd, pool, sample.items, device)
    outcome.numbers["wrong_build_chunks"] = _wrong_chunks(builds, done, cell)
    return outcome


@contextlib.contextmanager
def _planted(mode: str):
    """The port as ``mode`` runs it, restored on exit (the control runs
    through :func:`run`'s ``mode``)."""
    from critic_vae_tpu_torch.crf import device as crf_device

    if mode in ("program", "control"):
        yield
        return
    if mode == "half_mean":
        with faults.video(mode):
            yield
        return
    if mode == "iters_short":
        name, orig = "refine_masks_device", crf_device.refine_masks_device

        def patched(frames, masks, params, **kw):
            return orig(frames, masks, (*params[:5], int(params[5]) - 1), **kw)
    elif mode in ("diagonal_in_rowsum", "k8_frames_rolled"):
        name, orig = "build_kernel_i8", crf_device.build_kernel_i8

        def patched(imgs_u8, alpha, beta, *, h: int, w: int):
            k8, rowsum = orig(imgs_u8, alpha, beta, h=h, w=w)
            if mode == "diagonal_in_rowsum":
                return k8, rowsum + 127.0
            c, n = imgs_u8.shape[:2]
            return (k8.view(c, n, n).roll(-1, 0).reshape(c * n, n).contiguous(),
                    rowsum.view(c, n).roll(-1, 0).reshape(c * n, 1))
    else:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    setattr(crf_device, name, patched)
    try:
        yield
    finally:
        setattr(crf_device, name, orig)


def readings(cell: core.Cell, ctx, mode: str) -> Dict[str, float]:
    """The check's numbers for calibrate.py: set-up, then as many episodes
    as a run samples, masked as a run masks them with no timed window, and
    the comparison; ``mode`` one of :data:`MODES`."""
    ctx.units = int(cell.workload["sample_episodes"])
    with _planted(mode):
        return run(cell, ctx, "control" if mode == "control" else "program").numbers
