"""The port's numpy copies of the data and IoU modules are bit-exact with the
JAX package's originals (which cannot be imported without jax)."""

import importlib

import numpy as np
import pytest
import torch

from critic_vae_tpu.data import episode as j_episode
from critic_vae_tpu.data import synthetic as j_synth
from critic_vae_tpu_torch.data import episode as t_episode
from critic_vae_tpu_torch.data import synthetic as t_synth
from critic_vae_tpu_torch.ops import iou as t_iou

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

# the module, not the ``iou`` function that critic_vae_tpu.ops re-exports
j_iou = importlib.import_module("critic_vae_tpu.ops.iou")


@pytest.mark.parametrize("n,size,seed", [(12, 64, 0), (5, 16, 7), (3, 32, 2)])
def test_generate_frames_bit_exact(n, size, seed):
    fj, gj = j_synth.generate_frames(n, size=size, seed=seed)
    ft, gt = t_synth.generate_frames(n, size=size, seed=seed)
    assert ft.dtype == fj.dtype and gt.dtype == gj.dtype
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("ep_slice", [t_episode.DEFAULT_SLICE, None, (1, 9, 3)])
def test_generate_and_load_episode_bit_exact(tmp_path, ep_slice):
    assert t_episode.DEFAULT_SLICE == j_episode.DEFAULT_SLICE
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    j_synth.generate_episode(str(dj), num_frames=10, seed=4)
    t_synth.generate_episode(str(dt), num_frames=10, seed=4)
    for name in ("X.npy", "Y.npy"):
        assert (dj / name).read_bytes() == (dt / name).read_bytes()
    fj, gj = j_episode.load_episode(str(dj), ep_slice)
    ft, gt = t_episode.load_episode(str(dj), ep_slice)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(gt, gj)
    (dj / "Y.npy").unlink()
    assert t_episode.load_episode(str(dj), ep_slice)[1] is None


def test_iou_bit_exact():
    rng = np.random.default_rng(0)
    gt = rng.random((7, 16, 16)) < 0.3
    pred = rng.random((7, 16, 16)) < 0.4
    empty = np.zeros_like(gt)
    for a, b in ((gt, pred), (empty, empty), (gt, empty)):
        assert t_iou.iou(a, b) == j_iou.iou(a, b)
        assert t_iou.iou(a, b, round_digits=None) == j_iou.iou(a, b, round_digits=None)
        np.testing.assert_array_equal(t_iou.iou_batch(a, b), j_iou.iou_batch(a, b))
