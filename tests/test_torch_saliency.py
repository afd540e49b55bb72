"""The port's saliency mask source (critic_vae_tpu_torch/ops/saliency.py,
ops/resize.py, the critic's logits and tap) against the JAX package on the
same numpy frames and the full-width critic ``critic-synthetic.npz``: the
resize matrices, the Gaussian taps and blur, every map of
``critic_saliency`` (SmoothGrad with JAX's own draws injected), its errors,
the saturated-logit gradient, and the saliency threshold sweep's goldens."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu.models.critic import critic_apply
from critic_vae_tpu.ops import saliency as jsal
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.models import critic as critic_mod
from critic_vae_tpu_torch.ops import saliency as tsal
from critic_vae_tpu_torch.ops.resize import METHODS, resize_maps, weight_matrix
from critic_vae_tpu_torch.pipelines.video import threshold_sweep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    params = weights.load_critic_npz(CRITIC_NPZ)
    frames, _ = generate_frames(4, seed=3)
    x = frames.astype(np.float32) / 255.0
    return params, weights.critic_from_params(params), x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("method", METHODS)
def test_resize_matrices_match_jax(method):
    for n in (4, 8, 16, 32):
        want = np.asarray(jax.image.resize(jnp.eye(n, dtype=jnp.float32), (64, n), method))
        assert np.abs(weight_matrix(n, 64, method) - want).max() <= 1e-6, n
    x = np.random.default_rng(0).random((3, 16, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 64, 64), method))
    got = resize_maps(torch.from_numpy(x), (64, 64), method).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_lanczos3_first_row_renormalises_the_dropped_taps():
    np.testing.assert_allclose(weight_matrix(16, 64, "lanczos3")[0, :3],
                               [1.1807, -0.2275, 0.0468], atol=1e-4)
    np.testing.assert_allclose(weight_matrix(16, 64, "lanczos3").sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.5, 2.0])
def test_gaussian_taps_bitwise(sigma):
    got, want = tsal.gaussian_taps(sigma), jsal.gaussian_taps(sigma)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_sep_blur_matches_jax():
    x = np.random.default_rng(1).random((3, 64, 64)).astype(np.float32)
    taps = jsal.gaussian_taps(1.5)
    want = np.asarray(jsal._sep_blur(jnp.asarray(x), jnp.asarray(taps)))
    got = tsal._sep_blur(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got[:, :1], want[:, :1], rtol=1e-6)  # the replicated edge


def test_critic_logits_and_tap_match_jax(setup):
    params, critic, x = setup
    want_logit = np.asarray(critic_apply(params, jnp.asarray(x), return_logits=True))
    got_logit = critic(_nchw(x), return_logits=True).numpy()
    np.testing.assert_allclose(got_logit, want_logit, atol=1e-5)
    for k in range(4):
        off = jnp.zeros((4, 64 >> (k + 1), 64 >> (k + 1), params[f"conv{k}_w"].shape[-1]))
        _, tap_want = critic_apply(params, jnp.asarray(x), return_logits=True,
                                   tap_offset=(k, off))
        logit, tap = critic(_nchw(x), return_logits=True, tap=k)
        np.testing.assert_allclose(tap.permute(0, 2, 3, 1).numpy(), np.asarray(tap_want),
                                   atol=1e-5)
        np.testing.assert_allclose(logit.numpy(), want_logit, atol=1e-5)
    with pytest.raises(ValueError, match="tap block"):
        critic(_nchw(x), tap=4)


MAP_CASES = {
    "gradient": {},
    "gradient_logits": {"logits": True},
    **{f"layercam_block{k}": {"method": "layercam", "cam_block": k} for k in range(4)},
    **{f"layercam_{u}": {"method": "layercam", "cam_upsample": u}
       for u in ("bilinear", "bicubic", "nearest")},
    "tta_flip": {"method": "layercam", "tta_flip": True},
    "tta_shift2": {"method": "layercam", "tta_shift": 2},
    "tta_flip_shift2": {"method": "layercam", "tta_flip": True, "tta_shift": 2},
    "gradient_tta_flip_shift2": {"logits": True, "tta_flip": True, "tta_shift": 2},
}


def _check_maps(got, want):
    (pt, st), (pj, sj) = got, want
    pj, sj = np.asarray(pj), np.asarray(sj)
    assert st.shape == sj.shape and st.dtype == torch.float32
    assert np.abs(pt.numpy() - pj).max() <= 1e-6
    assert np.abs(st.numpy() - sj).max() <= 1e-5 * np.abs(sj).max()


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_maps_match_jax(setup, case):
    params, critic, x = setup
    kw = MAP_CASES[case]
    _check_maps(tsal.critic_saliency(critic, _nchw(x), **kw),
                jsal.critic_saliency(params, jnp.asarray(x), **kw))


SMOOTHGRAD_CASES = {
    "gradient_logits": {"logits": True, "smooth_sigma": 1.0},
    "layercam": {"method": "layercam"},
    "layercam_tta": {"method": "layercam", "tta_flip": True, "tta_shift": 2},
}


@pytest.mark.parametrize("case", sorted(SMOOTHGRAD_CASES))
def test_smoothgrad_with_jax_draws(setup, case):
    """SmoothGrad with JAX's own noise: ``jax.random.normal(k, x.shape)``
    over ``jax.random.split(key, samples)``, given to the port's hook."""
    params, critic, x = setup
    key = jax.random.key(5)
    draws = np.stack([np.asarray(jax.random.normal(k, x.shape))
                      for k in jax.random.split(key, 3)])
    kw = SMOOTHGRAD_CASES[case]
    _check_maps(tsal.critic_saliency_from_noise(critic, _nchw(x), torch.from_numpy(draws),
                                                noise=0.08, **kw),
                jsal.critic_saliency(params, jnp.asarray(x), samples=3, noise=0.08, key=key,
                                     **kw))


def test_generator_draws_and_zero_noise(setup):
    """``critic_saliency`` draws (samples, B, H, W, 3) unit normals from its
    generator; ``noise == 0`` is one backward pass whatever ``samples``."""
    _, critic, x = setup
    xt = _nchw(x)
    got = tsal.critic_saliency(critic, xt, samples=2, noise=0.05,
                               generator=torch.Generator().manual_seed(9))
    draws = torch.randn((2, 4, 64, 64, 3), generator=torch.Generator().manual_seed(9))
    want = tsal.critic_saliency_from_noise(critic, xt, draws, noise=0.05)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = tsal.critic_saliency(critic, xt)
    many = tsal.critic_saliency(critic, xt, samples=8)
    assert all(torch.equal(a, b) for a, b in zip(one, many))


def test_saturated_logit_gradient_is_finite(setup):
    """A logit of about -200: the op-by-op sigmoid's backward is NaN there
    (exp(200) overflows), ``jax.nn.sigmoid``'s y(1 - y) is 0, and so are the
    port's gradient maps."""
    params, _, x = setup
    sat = dict(params, fc1_b=params["fc1_b"] - np.float32(200.0))
    critic = weights.critic_from_params(sat)
    xt = _nchw(x).requires_grad_(True)
    logit = critic(xt, return_logits=True)
    assert float(logit.detach().max()) < -100.0
    (g,) = torch.autograd.grad(critic_mod.sigmoid(logit).sum(), xt)
    assert torch.isnan(g).any()  # the trap the saliency graph avoids
    pt, st = tsal.critic_saliency(critic, _nchw(x))
    pj, sj = jsal.critic_saliency(sat, jnp.asarray(x))
    assert torch.isfinite(st).all() and np.isfinite(np.asarray(sj)).all()
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


ERROR_CASES = {
    "samples": {"samples": 0},
    "noise": {"noise": -0.1},
    "method": {"method": "gradcam"},
    "cam_block": {"method": "layercam", "cam_block": 4},
    "cam_upsample": {"cam_upsample": "area"},
    "tta_shift": {"tta_shift": -1},
    "key": {"noise": 0.1, "samples": 2},
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_are_jax_s(setup, case):
    params, critic, x = setup
    kw = ERROR_CASES[case]
    with pytest.raises(ValueError) as want:
        jsal.critic_saliency(params, jnp.asarray(x), **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tsal.critic_saliency(critic, _nchw(x), **kw)


def test_inference_tensors_reach_autograd(setup):
    """Frames made under ``torch.inference_mode`` and a call from inside it
    give the maps of a plain call."""
    _, critic, x = setup
    want = tsal.critic_saliency(critic, _nchw(x), method="layercam")
    with torch.inference_mode():
        xi = _nchw(x).clone()
        got = tsal.critic_saliency(critic, xi, method="layercam")
    assert xi.is_inference()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# tests/test_golden_saliency.py's GOLDEN: the JAX package's saliency sweep on
# 48 frames of seed 9999 with critic-synthetic.npz
GOLDEN = {
    "layercam": [(80, 0.498), (100, 0.499), (140, 0.464)],
    "layercam-bilinear": [(80, 0.481), (112, 0.493), (140, 0.479)],
    "gradient": [(60, 0.270), (110, 0.279), (150, 0.233)],
}


@pytest.mark.parametrize("method", sorted(GOLDEN))
def test_saliency_sweep_matches_jax_golden(method):
    frames, gt = generate_frames(48, seed=9999)
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))
    vae = weights.vae_from_params(*weights.numpy_vae_params(0))
    opts = {"method": method.split("-")[0]}
    if method.endswith("-bilinear"):
        opts["cam_upsample"] = "bilinear"
    sweep = threshold_sweep(vae, critic, frames, gt, [t for t, _ in GOLDEN[method]],
                            device=CPU, run_crf=False, batch_size=16, mask_source="saliency",
                            saliency_opts=opts)
    got = {r["threshold"]: r["thr_iou"] for r in sweep}
    for thr, want in GOLDEN[method]:
        assert abs(got[thr] - want) <= 0.0015, (method, thr, got[thr], want)
