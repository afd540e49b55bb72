"""The port's host CRF (critic_vae_tpu_torch/crf/host.py) against the JAX
package's: the same C++ source, bit-identical labels, and the pipelines'
host paths."""

from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu import crf as jax_crf
from critic_vae_tpu.pipelines.video import eval_episode as jax_eval_episode
from critic_vae_tpu.pipelines.video import threshold_sweep as jax_threshold_sweep
from critic_vae_tpu_torch import crf
from critic_vae_tpu_torch.crf import host
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.pipelines.video import eval_episode, threshold_sweep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
CPU = torch.device("cpu")


def test_source_is_the_jax_packages_byte_for_byte():
    assert host.SRC.read_bytes() == (ROOT / "critic_vae_tpu" / "crf" / "densecrf.cpp").read_bytes()
    rel = host.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in (ROOT / ".gitignore").read_text().splitlines()
    assert crf.refine_masks is host.refine_masks and crf.densecrf is host.densecrf


@pytest.mark.parametrize("params", [crf.REFERENCE_CRF_PARAMS, (132.0, 32.0, 3.1, 8.0, 1.8, 10)])
def test_labels_bit_identical_to_jax(params):
    frames, gt = generate_frames(6, size=32, seed=2)
    noisy = gt ^ (np.random.default_rng(3).random(gt.shape) < 0.1)
    got = host.refine_masks(frames, noisy, params)
    np.testing.assert_array_equal(got, jax_crf.refine_masks(frames, noisy, params))
    assert got.dtype == bool and np.mean(got == noisy) < 1.0
    prob = np.random.default_rng(4).dirichlet(np.ones(3), size=(32, 32)).astype(np.float32)
    np.testing.assert_array_equal(host.densecrf(frames[0], prob, params),
                                  jax_crf.densecrf(frames[0], prob, params))
    probs = np.stack([1.0 - noisy, noisy], -1).astype(np.float32)
    np.testing.assert_array_equal(host.densecrf_batch(frames, probs, params, num_threads=2),
                                  jax_crf.densecrf_batch(frames, probs, params))


def test_shapes_are_checked():
    frames, gt = generate_frames(2, size=16, seed=0)
    with pytest.raises(ValueError):
        host.densecrf(frames[0], np.ones((8, 8, 2), np.float32), crf.REFERENCE_CRF_PARAMS)
    with pytest.raises(ValueError):
        host.densecrf_batch(frames[:1], np.ones((2, 16, 16, 2), np.float32),
                            crf.REFERENCE_CRF_PARAMS)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host.compile_library()


def _models(seed):
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = weights.numpy_vae_params(seed, **NARROW)
    return critic_np, params, state, weights.critic_from_params(critic_np), \
        weights.vae_from_params(params, state)


def test_eval_episode_host_equals_jax():
    frames, gt = generate_frames(5, seed=6)
    critic_np, params, state, critic, vae = _models(1)
    want = jax_eval_episode(params, state, critic_np, frames, gt, crf_backend="host",
                            with_recons=False, batch_size=2)
    kb.reset_launches()
    got = eval_episode(vae, critic, frames, gt, device=CPU, crf_backend="host", batch_size=2)
    np.testing.assert_array_equal(got.thr_masks, want.thr_masks)
    np.testing.assert_array_equal(got.crf_masks, want.crf_masks)
    assert got.thr_iou == want.thr_iou and got.crf_iou == want.crf_iou
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)
    # the consumer thread refines chunk by chunk: the whole stack at once is the same
    np.testing.assert_array_equal(got.crf_masks, host.refine_masks(frames, got.thr_masks))


def test_threshold_sweep_host_equals_jax():
    frames, gt = generate_frames(4, seed=7)
    critic_np, params, state, critic, vae = _models(2)
    thresholds = (0, 30, 50, 90)
    want = jax_threshold_sweep(params, state, critic_np, frames, gt, thresholds,
                               crf_backend="host", batch_size=3)
    got = threshold_sweep(vae, critic, frames, gt, thresholds, device=CPU, crf_backend="host",
                          batch_size=3)
    assert got == want
