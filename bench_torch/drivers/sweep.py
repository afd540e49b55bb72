"""The threshold-sweep cell: ``pipelines/video.py::threshold_sweep`` over a
pool of seeded episodes with ground truth, back to back, as ``video
--sweep`` sweeps a recording (closed loop: one episode after another, as a
researcher sweeps a recording to choose its threshold).

The run is drivers/video.py's, with the sweep in the episode's place:
set-up makes the weights and the pool from the seed and sweeps one episode
(every shape the window uses); the window sweeps episodes until
``--seconds`` have passed; ``video_frames_per_s`` is the frames of every
episode finished over the time from the window's start to the last finish;
``--trace 1`` traces ``trace_episodes`` episodes instead. It takes that
module's ``_models``, ``_environment`` and ``Reservoir`` from its own
instance of the module and changes none of them. A seeded reservoir keeps a
sample of the finished episodes; once the window has closed and the port's
models are freed, the plain reference (reference/sweep.py) sweeps the same
frames, and the numbers of the check, each the worst over the sample and
the thresholds, come from the unrounded counts:

* ``thr_iou_gap``, ``crf_iou_gap``: |IoU − the reference's IoU|, without
  and with the CRF, reported and held to no limit: no control or fault
  reads either 3× above the sound runs on every seed;
* ``thr_count_mismatch``, ``crf_count_mismatch``: (|Δtp| + |Δfn| + |Δfp|)
  over the reference's tp + fn + fp;
* ``result_faults``: the worst episode's results that users would misread:
  thresholds missing, extra or out of the configuration's order, and each
  printed IoU (``thr_iou``, ``crf_iou``) that is not its own counts' IoU
  rounded to 3 digits or lies more than a rounding step from the
  reference's rounded IoU.

``readings`` (calibrate.py) runs one of :data:`MODES`: ``program``;
``control``, the nets in bf16 (the int8 CRF build of the video cells'
control changes nothing here: many mask sets take B2 in bf16 whatever the
build); ``half_mean`` of bench_torch/faults.py (the sweep reaches it through
``episode_device_stage``); and two faults planted here in the port:
``lanes_shifted`` (mask set t refined in the lanes of set t + 1: the
thresholds' axis rolled before ``refine_masks_multi_device``) and
``iters_short`` (the mean field run one iteration short).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import torch

from bench_torch import core, faults, traffic, tracing

MODES = ("program", "control", "half_mean", "lanes_shifted", "iters_short")

_video = core.driver("video")


def _sweep_kwargs(cell: core.Cell, device, mode: str) -> Dict:
    """``threshold_sweep``'s keyword arguments: the configuration's, and
    the control's bf16 nets."""
    cfg = cell.config
    return dict(device=device, crf_params=tuple(cfg["crf_params"]),
                run_crf=bool(cell.traffic["run_crf"]), batch_size=int(cfg["chunk"]),
                compute_dtype="bfloat16" if mode == "control" else cfg["compute_dtype"],
                crf_backend=cell.workload.get("crf_backend", cfg["crf_backend"]))


def _iou(counts) -> float:
    tp, fn, fp = (int(c) for c in counts)
    union = tp + fn + fp
    return 1.0 if union == 0 else tp / union


def _mismatch(got, want) -> float:
    """(|Δtp| + |Δfn| + |Δfp|) over the reference's tp + fn + fp (0 where
    both unions are empty)."""
    diff = sum(abs(int(g) - int(w)) for g, w in zip(got, want))
    union = sum(int(w) for w in want)
    return diff / union if union else float(diff)


def _compare(results, want: Dict[str, list], thresholds, kinds) -> Dict[str, float]:
    """One episode's numbers: its sweep's ``results`` against the
    reference's counts ``want`` (kind -> (T, 3) lists, T the configuration's
    ``thresholds``), the worst over the thresholds, for each of ``kinds``
    ("thr", "crf"); ``result_faults`` counts the results at fault."""
    worst: Dict[str, float] = {"result_faults": abs(len(results) - len(thresholds))}
    worst["result_faults"] += sum(int(r["threshold"]) != int(t)
                                  for r, t in zip(results, thresholds))
    for kind in kinds:
        for r, w in zip(results, want[f"{kind}_counts"]):
            got, printed = r[f"{kind}_counts"], r[f"{kind}_iou"]
            for name, value in ((f"{kind}_iou_gap", abs(_iou(got) - _iou(w))),
                                (f"{kind}_count_mismatch", _mismatch(got, w))):
                worst[name] = max(worst.get(name, value), value)
            # rounded IoUs lie on a grid of 1e-3: more than a step apart is 2e-3 or more
            worst["result_faults"] += (printed != round(_iou(got), 3)
                                       or abs(printed - round(_iou(w), 3)) > 1.5e-3)
    return worst


def _check(cell: core.Cell, critic_sd, vae_sd, pool, sample, device) -> Dict[str, float]:
    """The reference over the sampled episodes, and the worst numbers."""
    from bench_torch.reference import sweep as ref

    cfg, run_crf = cell.config, bool(cell.traffic["run_crf"])
    worst: Dict[str, float] = {}
    for index, results in sample:
        frames, gt = (torch.from_numpy(a).to(device) for a in pool[index % len(pool)])
        want = ref.episode(critic_sd, vae_sd, frames, gt, cfg["thresholds"],
                           tuple(cfg["crf_params"]) if run_crf else None,
                           crf_block=int(cell.workload.get("reference_crf_block", 16)))
        got = _compare(results, {k: v.cpu().tolist() for k, v in want.items()},
                       cfg["thresholds"], ("thr", "crf") if run_crf else ("thr",))
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
        del want, frames, gt
    return worst


def run(cell: core.Cell, ctx, mode: str = "program") -> core.Outcome:
    """One run of the sweep cell (``ctx``: run.py's RunContext). ``mode``
    "control" runs the nets in bf16 (calibrate.py)."""
    from critic_vae_tpu_torch.pipelines import video as pv

    device = ctx.device
    tr, wl = cell.traffic, cell.workload
    thresholds = tuple(int(t) for t in cell.config["thresholds"])
    with _video._environment(tr.get("env", {})):
        critic, vae, critic_sd, vae_sd = _video._models(cell.config, tr, ctx.seed, device)
        pool = traffic.episodes(ctx.seed, tr, device)
        kw = _sweep_kwargs(cell, device, mode)
        frames_per_episode = int(tr["episode_frames"])

        def sweep(k: int):
            return pv.threshold_sweep(vae, critic, *pool[k % len(pool)], thresholds, **kw)

        if "thr_counts" not in sweep(0)[0]:  # the warm-up: every shape of the window
            raise SystemExit("threshold_sweep returns no unrounded counts: this program "
                             "cannot be checked against reference/sweep.py")
        ctx.sync()
        sample = _video.Reservoir(int(wl["sample_episodes"]), ctx.seed)
        outcome = core.Outcome(end_to_end={}, numbers={}, attempted=0, failed=0,
                               memory_peak_bytes=0)
        ctx.window_started()
        if ctx.trace:
            n = int(wl["trace_episodes"])
            with tracing.capture(f"sweep-{ctx.rank}") as box:
                for k in range(n):
                    sample.offer((k, sweep(k)))
            outcome.traced = core.Traced(box["trace"], box["window_s"], n,
                                         n * frames_per_episode, cell)
            outcome.busy_s = box["trace"].busy_s()
            outcome.breakdown = box["trace"].breakdown()
            done = n
        elif ctx.units:
            for done in range(ctx.units):
                sample.offer((done, sweep(done)))
            done = ctx.units
        else:
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            done, last = 0, t0
            while time.perf_counter() < deadline:
                sample.offer((done, sweep(done)))
                done += 1
                last = time.perf_counter()
            outcome.end_to_end["video_frames_per_s"] = done * frames_per_episode / (last - t0)
        outcome.attempted = done
        outcome.memory_peak_bytes = ctx.memory_peak()
        ious = [[(r["threshold"], r["thr_iou"], r["crf_iou"]) for r in res]
                for _, res in sample.items]
        core.log(f"episodes swept: {done} of {frames_per_episode} frames; sampled "
                 f"{[i for i, _ in sample.items]}; (threshold, thr IoU, crf IoU): {ious}")
        del critic, vae
        gc.collect()
        ctx.free()
    outcome.numbers = _check(cell, critic_sd, vae_sd, pool, sample.items, device)
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
    orig = crf_device.refine_masks_multi_device
    if mode == "lanes_shifted":
        def refine(frames, masks, params, **kw):
            return orig(frames, torch.roll(masks, 1, dims=0), params, **kw)
    elif mode == "iters_short":
        def refine(frames, masks, params, **kw):
            return orig(frames, masks, (*params[:5], int(params[5]) - 1), **kw)
    else:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    crf_device.refine_masks_multi_device = refine
    try:
        yield
    finally:
        crf_device.refine_masks_multi_device = orig


def readings(cell: core.Cell, ctx, mode: str) -> Dict[str, float]:
    """The check's numbers for calibrate.py: set-up, then as many episodes
    as a run samples, swept as a run sweeps them with no timed window, and
    the comparison; ``mode`` one of :data:`MODES`."""
    ctx.units = int(cell.workload["sample_episodes"])
    with _planted(mode):
        return run(cell, ctx, "control" if mode == "control" else "program").numbers
