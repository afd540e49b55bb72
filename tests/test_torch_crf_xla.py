"""The port's Gram-form ``xla`` CRF build (critic_vae_tpu_torch/crf/device.py)
against the JAX package's, and the build resolution against its rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.crf import device as jax_device
from critic_vae_tpu.crf.device import _coords as jax_coords
from critic_vae_tpu.crf.device import _normalized_kernel as jax_kernel
from critic_vae_tpu.crf.device import refine_masks_device as jax_refine
from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    _half_sqdist,
    _normalized_kernel,
    _resolve_build,
    build_bilateral_xla,
    refine_masks_device,
)
from critic_vae_tpu_torch.data.synthetic import generate_frames

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

W1, ALPHA, BETA = REFERENCE_CRF_PARAMS[:3]


def _jax_m(img, side):
    xy = jax_coords(side, side)
    return np.asarray(jax.jit(jax_kernel, static_argnums=(3,))(
        xy / jnp.float32(ALPHA), jnp.asarray(img).astype(jnp.float32) / jnp.float32(BETA),
        jnp.float32(W1), jnp.float32, 0.25 / (jnp.float32(ALPHA) ** 2)))


@pytest.mark.parametrize("side", [16, 20])
def test_xla_build_matches_jax_f32(side):
    frames, _ = generate_frames(2, size=side, seed=side)
    imgs = frames.reshape(2, side * side, 3)
    got = build_bilateral_xla(torch.from_numpy(imgs), W1, ALPHA, BETA, h=side, w=side).numpy()
    assert got.dtype == np.float32 and got.shape == (2, side * side, side * side)
    for i in range(2):
        want = _jax_m(imgs[i], side)
        sig = np.abs(want) > 1e-3
        assert sig.sum() > 500
        # the same Gram arithmetic: bitwise on most entries, the rest within
        # float32 reordering of the normaliser's row sums
        assert (np.abs(got[i] - want)[sig] / want[sig]).max() <= 1e-5
        assert np.mean(got[i] == want) >= 0.5
        assert np.all(np.diagonal(got[i]) == 0.0)
        np.testing.assert_array_equal(got[i] > 0, want > 0)


@pytest.mark.parametrize("side", [16, 20])
def test_xla_refine_matches_jax_f32(side, monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)
    frames, gt = generate_frames(4, size=side, seed=1)
    noisy = gt ^ (np.random.default_rng(side).random(gt.shape) < 0.08)
    want = jax_refine(frames, noisy, REFERENCE_CRF_PARAMS, build="xla")
    got = refine_masks_device(frames, noisy, REFERENCE_CRF_PARAMS, build="xla", device="cpu")
    assert np.mean(got == want) >= 0.999
    assert np.mean(got == noisy) < 1.0  # the CRF changed something


def test_diagonal_margin():
    """The diagonal is dropped by the margin, every distinct pair kept: the
    kernel equals a float64 one with an explicit i != j mask within the
    Gram form's own float32 cancellation (~1e-3 of logk at colour norms of
    ~2e4, so 5e-3 relative), and the Gram half-distances are <= 0 with an
    exactly zero diagonal."""
    side = 12
    frames, _ = generate_frames(1, size=side, seed=4)
    img = torch.from_numpy(frames.reshape(side * side, 3)).float() / BETA
    y, x = np.mgrid[0:side, 0:side]
    xy = torch.from_numpy(np.stack([x.ravel(), y.ravel()], -1).astype(np.float32)) / ALPHA
    hp = _half_sqdist(xy)
    assert hp.max().item() <= 0.0 and torch.all(torch.diagonal(hp) == 0.0)
    got = _normalized_kernel(xy, img, W1, torch.float32, diag_margin=0.25 / ALPHA**2).double()
    f = torch.cat([xy, img], dim=1).double()
    d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    k = torch.exp(-0.5 * d2) * (1 - torch.eye(side * side, dtype=torch.float64))
    n = torch.rsqrt(k.sum(-1) + 1e-20)
    want = W1 * n[:, None] * n[None, :] * k
    assert torch.all(torch.diagonal(got) == 0.0)
    sig = want > 1e-3
    assert ((got - want).abs()[sig] / want[sig]).max().item() <= 5e-3
    assert torch.equal(got > 0, want > 0)


BUILDS = ["auto", "xla", "pallas", "int8", "vmem", "lattice"]
SIZES = [(16, 16), (20, 20), (64, 64), (10, 10), (128, 128)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_build_follows_jax(device, monkeypatch):
    """Every (build, size) on the CPU and on CUDA against the JAX package's
    rule, the TPU standing for CUDA (its backend patched to "tpu")."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu" if device == "cuda" else "cpu")
    for build in BUILDS:
        for h, w in SIZES:
            try:
                want = jax_device._resolve_build(build, h, w)
            except ValueError:
                with pytest.raises(ValueError):
                    _resolve_build(build, h, w, device)
                continue
            assert _resolve_build(build, h, w, device) == want, (build, h, w)
    assert _resolve_build("auto", 64, 64, device) == ("pallas" if device == "cuda" else "xla")
    monkeypatch.setenv(BUILD_ENV, "xla")
    assert _resolve_build("pallas", 20, 20, device) == "xla"
