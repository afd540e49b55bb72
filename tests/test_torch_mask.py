"""The port's mask stage (critic_vae_tpu_torch.ops) against the JAX package:
kernel B1's plain version, the uint8 semantics and ``episode_forward``."""

import jax
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

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"


def _pre(n, seed):
    rng = np.random.default_rng(seed)
    return [(2.0 * rng.normal(size=(n, 64, 64, 3))).astype(np.float32) for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _decode(a, b):
    """The (2B, 3, H, W) decode of the two NHWC halves, as B1 takes it."""
    return torch.cat([_nchw(a), _nchw(b)])


def test_diff_mask_plain_matches_pallas_and_xla_tail():
    a, b = _pre(5, 0)
    grey_p, max_p = fused_diff_mask(jnp.asarray(a), jnp.asarray(b))  # interpret mode
    ra, rb = np.tanh(a), np.tanh(b)
    grey_x, max_x = (np.asarray(v) for v in _xla_tail(ra, rb))
    grey, maxv = diff_mask(_decode(a, b))
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
    pre = _decode(*_pre(2, 1))
    kb.reset_launches()
    diff_mask(pre)
    diff_mask(pre.bfloat16())
    assert kb.LAUNCHES == {"diff_mask": 0, "bilateral_build": 0, "kernel_i8_build": 0,
                           "matvec_i8": 0, "mean_field_resident": 0, "caps_probe": 0,
                           "front_end_probe": 0}
    with pytest.raises(ValueError):
        diff_mask(pre[:, :2])
    with pytest.raises(ValueError):
        diff_mask(pre[:3])  # an odd batch is no pair of decodes
    with pytest.raises(TypeError):
        diff_mask(pre.double())
    with pytest.raises(ValueError):
        diff_mask(pre.to("meta"))  # neither CPU nor CUDA: no plain fallback
    # bf16: tanh of the widened decode in float32, never rounded back to bf16
    pre16 = pre.bfloat16()
    g1, m1 = diff_mask(pre16)
    r = torch.tanh(pre16.float())
    d = (r[2:] - r[:2]).abs()
    g2 = d[:, 0] * 0.2989 + d[:, 1] * 0.5870 + d[:, 2] * 0.1140
    assert torch.equal(g1, g2) and torch.equal(m1, g2.amax(dim=(1, 2)))
    g3, m3 = diff_mask_reference(pre16.float())
    assert torch.equal(g1, g3) and torch.equal(m1, m3)


def _f32_ulps(x, y):
    """Distance in float32 ulps between finite float32 arrays of one sign."""
    return np.abs(x.view(np.int32).astype(np.int64) - y.view(np.int32).astype(np.int64))


def test_bf16_tanh_rounding_matches_jax_on_every_bf16():
    """B1's tanh of a bf16 decode, torch's float32 tanh of the widened value,
    is the JAX tail as XLA compiles it on all 65,536 bf16 bit patterns: XLA
    drops the bf16 rounding of a tanh whose only use is a cast to float32
    (bitwise its float32 tanh of the widened value), and the two float32
    tanh implementations, torch's and XLA:CPU's, agree within 4 ulps, NaN
    where NaN."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    got = torch.tanh(x.float()).numpy()
    xb = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: jnp.tanh(v).astype(jnp.float32))(xb))
    widened = np.asarray(jax.jit(jnp.tanh)(xb.astype(jnp.float32)))
    assert np.array_equal(want, widened, equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(got)
    assert _f32_ulps(got[ok], want[ok]).max() <= 4


def _u8_and_thr50(grey, maxv):
    u8, _ = jmask.normalize_diffs(jnp.asarray(grey), jnp.asarray(maxv))
    u8 = np.asarray(u8)
    return u8.astype(int), u8 > 50


def _jit_xla_tail(one, zero):
    """The JAX default tail as XLA compiles it: jnp.tanh of the bf16 decodes,
    cast to float32, then ``_xla_tail``."""
    return jax.jit(lambda a, b: _xla_tail(jnp.tanh(a).astype(jnp.float32),
                                          jnp.tanh(b).astype(jnp.float32)))(one, zero)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["default_tail", "pallas_tail"])
@pytest.mark.parametrize("s", [0.02, 0.1, 0.5])
def test_bf16_tail_matches_jax(s, use_pallas):
    """The port's bf16 tail against each of the JAX package's on the same
    bf16 pre-activations, pre_zero = pre_one + s·N(0, 1): the default tail
    jitted (XLA drops its tanh's bf16 rounding), and fused_diff_mask
    (``use_pallas``, interpret mode)."""
    rng = np.random.default_rng(int(s * 100))
    one = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    zero = (one + s * rng.normal(size=one.shape)).astype(np.float32)
    j1, j0 = (jnp.asarray(x).astype(jnp.bfloat16) for x in (one, zero))
    want_g, want_m = fused_diff_mask(j1, j0) if use_pallas else _jit_xla_tail(j1, j0)
    want_g, want_m = np.asarray(want_g), np.asarray(want_m)
    pre = _decode(one, zero).bfloat16()
    assert np.array_equal(pre[:8].float().numpy(),
                          np.asarray(j1.astype(jnp.float32)).transpose(0, 3, 1, 2))
    grey, maxv = diff_mask(pre)
    grey, maxv = grey.numpy(), maxv.numpy()
    assert np.abs(grey - want_g).max() <= 1e-6
    assert np.abs(maxv - want_m).max() <= 1e-6
    (u8_t, thr_t), (u8_j, thr_j) = _u8_and_thr50(grey, maxv), _u8_and_thr50(want_g, want_m)
    assert np.mean(np.abs(u8_t - u8_j) <= 1) >= 0.999
    assert np.mean(thr_t == thr_j) >= 0.998


def test_diff_images_use_pallas_picks_the_tail(monkeypatch):
    """``diff_images`` runs B1 once on the port's own bf16 decode, in its one
    arithmetic (tanh of the widened decode), which both JAX tails compute
    once jitted; so it takes no ``use_pallas``
    (tests/test_torch_bf16_parity.py holds the maps against JAX's)."""
    params, state = weights.numpy_vae_params(3, dims=(4, 8, 8, 16), bottleneck=256)
    vae = weights.vae_from_params(params, state)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64))).bfloat16()
    values = torch.tensor([0.9, 0.1], dtype=torch.bfloat16)
    calls = []

    def spy(pre):
        calls.append(pre)
        return diff_mask_reference(pre)

    monkeypatch.setattr(tmask, "diff_mask", spy)
    with torch.inference_mode():
        grey, maxv = tmask.diff_images(vae, x, values)
        with pytest.raises(TypeError):
            tmask.diff_images(vae, x, values, use_pallas=True)
        mu, _ = vae.encode(x)
        pre = vae.decode(torch.cat([mu, mu]), torch.cat([values, torch.zeros(2).bfloat16()]),
                         apply_tanh=False)
    assert len(calls) == 1 and calls[0].shape == (4, 3, 64, 64)
    assert calls[0].dtype == torch.bfloat16 and torch.equal(calls[0], pre)
    want_g, want_m = diff_mask_reference(pre)
    assert torch.equal(grey, want_g) and torch.equal(maxv, want_m)


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
