"""The port's mask stage (critic_vae_tpu_torch.ops) against the JAX package:
kernel B1's plain version, the uint8 semantics and ``episode_forward``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.ops import mask as jmask
from critic_vae_tpu.ops.pallas_kernels import fused_diff_mask
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.ops import mask as tmask
from critic_vae_tpu_torch.ops.diff_mask import diff_mask, diff_mask_reference

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"


def _pre(n, seed):
    rng = np.random.default_rng(seed)
    return [(2.0 * rng.normal(size=(n, 64, 64, 3))).astype(np.float32) for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_diff_mask_plain_matches_pallas_and_xla_tail():
    a, b = _pre(5, 0)
    grey_p, max_p = fused_diff_mask(jnp.asarray(a), jnp.asarray(b))  # interpret mode
    ra, rb = np.tanh(a), np.tanh(b)
    grey_x, max_x = (np.asarray(v) for v in _xla_tail(ra, rb))
    grey, maxv = diff_mask(_nchw(a), _nchw(b))
    assert grey.shape == (5, 64, 64) and maxv.shape == (5,)
    for want_g, want_m in ((np.asarray(grey_p), np.asarray(max_p)), (grey_x, max_x)):
        assert np.abs(grey.numpy() - want_g).max() <= 1e-6
        assert np.abs(maxv.numpy() - want_m).max() <= 1e-6


def _xla_tail(recon_one, recon_zero):
    """ops/mask.py diff_images' XLA branch, on given reconstructions."""
    d = jnp.abs(jnp.asarray(recon_zero) - jnp.asarray(recon_one))
    w = jmask.REC601
    grey = d[..., 0] * w[0] + d[..., 1] * w[1] + d[..., 2] * w[2]
    return grey, jnp.max(grey, axis=(1, 2))


def test_diff_mask_wrapper_checks_and_counts_nothing_on_cpu():
    a, b = (_nchw(x) for x in _pre(2, 1))
    kb.reset_launches()
    diff_mask(a, b)
    diff_mask(a.bfloat16(), b.bfloat16())
    assert kb.LAUNCHES == {"diff_mask": 0, "bilateral_build": 0, "kernel_i8_build": 0,
                           "matvec_i8": 0, "mean_field_resident": 0, "caps_probe": 0,
                           "front_end_probe": 0}
    with pytest.raises(ValueError):
        diff_mask(a[:, :2], b[:, :2])
    with pytest.raises(TypeError):
        diff_mask(a.double(), b.double())
    with pytest.raises(ValueError):
        diff_mask(a.to("meta"), b.to("meta"))  # neither CPU nor CUDA: no plain fallback
    g1, m1 = diff_mask(a.bfloat16(), b.bfloat16())
    g2, m2 = diff_mask_reference(a.bfloat16().float(), b.bfloat16().float())
    assert torch.equal(g1, g2) and torch.equal(m1, m2)


@pytest.mark.parametrize("mean_max", [0.0, 0.37, 1e-30, 2.5])
def test_normalize_diffs_given_mean_exact(mean_max):
    rng = np.random.default_rng(5)
    d = (rng.random((3, 64, 64)) * 0.8).astype(np.float32)
    d[0, :4, :4] = [0.0, 0.37, 0.3699999, 0.37000001]
    want = np.asarray(jmask.normalize_diffs_given_mean(jnp.asarray(d), np.float32(mean_max)))
    got = tmask.normalize_diffs_given_mean(torch.from_numpy(d), np.float32(mean_max)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_quantize_recons_edge_cases_exact():
    vals = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -0.001, -0.5, -1.0, -3.7, 0.999,
                     1.0, 1.004, 1.5, 2.0, 7.3, -7.3, 1e4, -1e4, 3e38, -3e38],
                    np.float32).reshape(2, 10)
    want = np.asarray(jmask.quantize_recons(jnp.asarray(vals)))
    got = tmask.quantize_recons(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_threshold_masks_and_iou_stacked_exact():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    u8[0, 0, :4] = [0, 255, 254, 1]
    ts = np.array([0, 1, 50, 254, 255, 256, 300, -1], np.int32)
    want = np.asarray(jmask.threshold_masks(jnp.asarray(u8), jnp.asarray(ts)))
    got = tmask.threshold_masks(torch.from_numpy(u8), torch.from_numpy(ts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[ts >= 255].any()
    gt = rng.random((3, 16, 16)) < 0.3
    masks = np.concatenate([got, np.zeros((1, 3, 16, 16), bool)])
    gt_empty = np.zeros_like(gt)
    for g in (gt, gt_empty):
        w = np.asarray(jmask.iou_stacked(jnp.asarray(g), jnp.asarray(masks)))
        h = tmask.iou_stacked(torch.from_numpy(g), torch.from_numpy(masks)).numpy()
        np.testing.assert_array_equal(h, w)


@pytest.fixture(scope="module")
def stage_pair():
    """JAX and port episode_forward on the same uint8 frames and weights
    (full-width critic, narrow VAE)."""
    from critic_vae_tpu.data.synthetic import generate_frames

    frames, _ = generate_frames(6, seed=3)
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = weights.numpy_vae_params(5, dims=(4, 8, 8, 16), bottleneck=256)
    want = jmask.episode_forward(
        params, state, {k: jnp.asarray(v) for k, v in critic_np.items()},
        jnp.asarray(frames), with_recons=False, compute_dtype="float32", front_end="split",
    )
    got = tmask.episode_forward(
        weights.vae_from_params(params, state), weights.critic_from_params(critic_np),
        torch.from_numpy(frames),
    )
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def test_episode_forward_matches_jax(stage_pair):
    want, got = stage_pair
    assert got["diff"].shape == (6, 64, 64) and got["preds"].shape == (6,)
    assert np.abs(got["preds"] - want["preds"]).max() <= 1e-5
    assert np.abs(got["diff"] - want["diff"]).max() <= 1e-5
    assert np.abs(got["max_value"] - want["max_value"]).max() <= 1e-5


def test_uint8_maps_and_threshold_masks_meet_parity_bars(stage_pair):
    want, got = stage_pair
    u8_j, _ = jmask.normalize_diffs(jnp.asarray(want["diff"]), jnp.asarray(want["max_value"]))
    u8_t, _ = tmask.normalize_diffs(torch.from_numpy(got["diff"]),
                                    torch.from_numpy(got["max_value"]))
    u8_j, u8_t = np.asarray(u8_j).astype(int), u8_t.numpy().astype(int)
    assert np.mean(np.abs(u8_t - u8_j) <= 1) >= 0.999
    t = np.array([50], np.int32)
    thr_j = np.asarray(jmask.threshold_masks(jnp.asarray(u8_j.astype(np.uint8)), jnp.asarray(t)))
    thr_t = tmask.threshold_masks(torch.from_numpy(u8_t.astype(np.uint8)),
                                  torch.from_numpy(t)).numpy()
    assert np.mean(thr_t == thr_j) >= 0.998
