"""Faults planted under the timed path, to show that the check that decides
``correct`` catches them (bench_torch/tests) and to read their numbers on
the card (calibrate.py). Each is a context manager that patches the port
where the drivers reach it, and restores it on exit.

* ``half_mean``: video: the episode's mean-max normalisation takes the
  mean over the first half of the frames only (half of the batch left out,
  the mean taken over the rest).
* ``answer_altered``: video: frame 0's critic score is moved by 0.05 where
  the device stage produces it; training: the step's total loss is scaled
  by 1.001 where it is produced.
* ``half_batch``: training: the loss (and so the gradient) is the mean
  over the first half of the batch's rows.
* ``state_unchanged``: training: every step leaves the parameters,
  BatchNorm's statistics and Adam's state as they were.
* ``no_exchange``: training over ranks: the gradients are not summed over
  ranks (the exchange between cards left out).
"""

from __future__ import annotations

import contextlib

import torch

VIDEO = ("half_mean", "answer_altered")
TRAIN = ("half_batch", "state_unchanged", "answer_altered")
TRAIN_RANKS = TRAIN + ("no_exchange",)


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def video(fault: str):
    from critic_vae_tpu_torch.pipelines import video as pv

    orig = pv.episode_device_stage

    def stage(*args, **kwargs):
        preds, maxes, diffs, valids, recons = orig(*args, **kwargs)
        if fault == "half_mean":
            maxes = maxes[: max(1, maxes.shape[0] // 2)]
        elif fault == "answer_altered":
            preds = preds.clone()
            preds[0] += 0.05
        else:
            raise ValueError(f"unknown video fault {fault!r}")
        return preds, maxes, diffs, valids, recons

    return _patched(pv, "episode_device_stage", stage)


def train(fault: str):
    from critic_vae_tpu_torch.train import step as ts

    if fault == "no_exchange":
        return _patched(ts, "sum_gradients", lambda mesh, grads: grads)
    if fault in ("half_batch", "answer_altered"):
        orig_loss = ts.vae_loss

        def loss(x, mu, logvar, recon, **kw):
            if fault == "half_batch":
                h = x.shape[0] // 2
                return orig_loss(x[:h], mu[:h], logvar[:h], recon[:h], **kw)
            out = orig_loss(x, mu, logvar, recon, **kw)
            return {**out, "total_loss": out["total_loss"] * 1.001}

        return _patched(ts, "vae_loss", loss)
    if fault == "state_unchanged":
        orig_make = ts.make_multi_step

        def make(*args, **kwargs):
            multi = orig_make(*args, **kwargs)

            def frozen(state, *a, **kw):
                vae = state.vae
                keep = [t.detach().clone() for t in
                        list(vae.parameters()) + list(vae.buffers()) + state.mu + state.nu
                        + state.counts]
                out = multi(state, *a, **kw)
                with torch.no_grad():
                    for t, k in zip(list(vae.parameters()) + list(vae.buffers()) + state.mu
                                    + state.nu + state.counts, keep):
                        t.copy_(k)
                return out

            return frozen

        return _patched(ts, "make_multi_step", make)
    raise ValueError(f"unknown training fault {fault!r}")
