"""ROADMAP C.11's first check: what ``train --mask-distill`` trains, read by
the serving path. Both packages take 3 steps of the training step with the
distillation term (weight 0.5, lr 5e-5) from the same narrow VAE (dims (4,
8, 8, 16)), on the same batches, pseudo-label masks (the port's LayerCAM
masks, without the CRF) and reparametrize draws (JAX's, given to the port);
then each trained VAE serves 16 other frames through its package's
``eval_episode`` (diff source, float32, no CRF). Bars: the ROADMAP's
serving bars between the two: threshold masks >= 99.8% identical, maps >=
99.9% within one level, thr_iou equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.pipelines.video import eval_episode as jax_eval_episode
from critic_vae_tpu.train import step as jstep
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines.distill import build_pseudo_masks
from critic_vae_tpu_torch.pipelines.video import eval_episode
from critic_vae_tpu_torch.train import step as tstep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
LR = 5e-5
MD = 0.5
STEPS, BATCH = 3, 4


def _tx():
    return optax.apply_if_finite(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
                                 max_consecutive_errors=100)


def _jax_eps(key, steps, batch):
    """The draws JAX's step takes from its state's key, in its order."""
    out = []
    for _ in range(steps):
        key, sample_key = jax.random.split(key)
        out.append(np.array(jax.random.normal(sample_key, (batch, 32), jnp.float32)))
    return out


def test_mask_distilled_vaes_serve_the_same_masks():
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    critic = weights.critic_from_params(critic_np)
    params, bn_state = weights.numpy_vae_params(3, **NARROW)
    frames, _ = generate_frames(STEPS * BATCH, seed=1)
    masks = build_pseudo_masks(critic, frames, run_crf=False, device="cpu")
    batches = [(frames[i * BATCH:(i + 1) * BATCH], masks[i * BATCH:(i + 1) * BATCH])
               for i in range(STEPS)]

    key = jax.random.key(9)
    p = jax.tree.map(jnp.asarray, params)
    jstate = jstep.TrainState(p, jax.tree.map(jnp.asarray, bn_state), _tx().init(p), key,
                              jnp.zeros((), jnp.int32))
    jfn = jstep.make_train_step(jax_load_critic(CRITIC_NPZ), _tx(), compute_dtype=jnp.float32,
                                donate=False, mask_distill=MD)
    for x, m in batches:
        jstate, _ = jfn(jstate, jnp.asarray(x), jnp.asarray(m))

    state = tstep.init_train_state(params, bn_state, device="cpu")
    step = tstep.make_train_step(critic, learning_rate=LR, mask_distill=MD)
    for (x, m), eps in zip(batches, _jax_eps(key, STEPS, BATCH)):
        step(state, torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(m))
    trained = weights.vae_from_params(*weights.vae_to_params(state.vae))
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree.leaves(jstate.params), jax.tree.leaves(p)))
    assert moved > 0.5 * LR  # the steps trained

    serve, gt = generate_frames(16, seed=21)
    want = jax_eval_episode(jax.tree.map(np.asarray, jstate.params),
                            jax.tree.map(np.asarray, jstate.bn_state), critic_np, serve, gt,
                            run_crf=False, with_recons=False, compute_dtype="float32")
    got = eval_episode(trained, critic, serve, gt, device=torch.device("cpu"), run_crf=False)
    assert np.abs(got.preds - want.preds).max() <= 1e-5
    assert np.mean(np.abs(got.diff_u8.astype(int) - want.diff_u8.astype(int)) <= 1) >= 0.999
    assert np.mean(got.thr_masks == want.thr_masks) >= 0.998
    assert got.thr_iou == want.thr_iou
