"""The port's MS-SSIM and VAE losses (critic_vae_tpu_torch.ops.msssim,
ops/losses.py) against the JAX package's on the same numpy images: values
within 1e-6, gradients within 1e-4 of the largest of ``jax.grad``'s (float32
sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.ops import losses as jlosses
from critic_vae_tpu.ops import msssim as jmsssim
from critic_vae_tpu_torch.ops import losses as tlosses
from critic_vae_tpu_torch.ops import msssim as tmsssim

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

LOSS_TOL = 1e-6
GRAD_TOL = 1e-4  # relative to the largest gradient entry


@functools.partial(jax.jit, static_argnames="faithful")
def _jax_loss_grad(a, b, faithful=True):
    """JAX's loss and its gradient in the first image, compiled once a shape."""
    return jax.value_and_grad(lambda x: jmsssim.msssim_loss(x, b, faithful=faithful))(a)


def _pair(seed, noise, n=2, size=64):
    rng = np.random.default_rng(seed)
    a = rng.random((n, size, size, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


def _nchw(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(grad)


def _close_grads(got, want):
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


@pytest.mark.parametrize("faithful", [True, False])
def test_window_equals_jax(faithful):
    np.testing.assert_array_equal(tmsssim.window_1d(faithful), jmsssim.window_1d(faithful))
    if faithful:  # quirk 1: the edges outweigh the centre
        assert tmsssim.window_1d(True)[0] > tmsssim.window_1d(True)[5]


@pytest.mark.parametrize("faithful,noise", [(True, 0.05), (True, 0.3), (False, 0.05),
                                            (False, 0.3)])
def test_msssim_loss_and_gradient_match_jax(faithful, noise):
    a, b = _pair(1, noise)
    want, want_g = _jax_loss_grad(jnp.asarray(a), jnp.asarray(b), faithful=faithful)
    want = float(want)
    ta = _nchw(a, grad=True)
    got = tmsssim.msssim_loss(ta, _nchw(b), faithful=faithful)
    got.backward()
    assert abs(got.item() - want) <= LOSS_TOL
    _close_grads(ta.grad, want_g)


def test_faithful_and_textbook_differ():
    a, b = _pair(2, 0.1)
    f = tmsssim.msssim_loss(_nchw(a), _nchw(b), faithful=True).item()
    t = tmsssim.msssim_loss(_nchw(a), _nchw(b), faithful=False).item()
    assert abs(f - t) > 1e-4


def test_straight_through_floor_keeps_the_gradient():
    """Anti-correlated images drive SSIM and CS below the floor at coarse
    scales: the loss must equal JAX's there, and so must its gradient, which
    a hard clamp would zero (the documented failure: training stranded at
    loss ~1 with no signal)."""
    rng = np.random.default_rng(3)
    a = rng.random((2, 64, 64, 3), dtype=np.float32)
    b = (1.0 - a).astype(np.float32)
    want, want_g = _jax_loss_grad(jnp.asarray(a), jnp.asarray(b))
    want = float(want)
    ta = _nchw(a, grad=True)
    got = tmsssim.msssim_loss(ta, _nchw(b))
    got.backward()
    assert abs(got.item() - want) <= LOSS_TOL
    assert np.abs(np.asarray(want_g)).max() > 0
    _close_grads(ta.grad, want_g)
    # the floor is active here: some scale's statistic sits below it ...
    stats = []
    x, y = _nchw(a), _nchw(b)
    k = torch.from_numpy(tmsssim.window_1d(True))
    for _ in range(5):
        stats += list(tmsssim._ssim_level(x, y, k))
        x, y = torch.nn.functional.avg_pool2d(x, 2), torch.nn.functional.avg_pool2d(y, 2)
    assert min(s.item() for s in stats) < tmsssim.FLOOR
    # ... where st_floor forwards max(x, eps) (up to the rounding of x +
    # (eps - x), as JAX's) and passes the gradient through
    v = torch.tensor([-0.5, 1e-5, 0.3], requires_grad=True)
    out = tmsssim.st_floor(v)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.float32([tmsssim.FLOOR, tmsssim.FLOOR, 0.3]), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(v.grad.numpy(), np.ones(3, np.float32))


def test_kld_and_vae_loss_match_jax():
    rng = np.random.default_rng(4)
    mu = rng.normal(0, 1, (5, 32)).astype(np.float32)
    logvar = rng.normal(0, 0.5, (5, 32)).astype(np.float32)
    a, b = _pair(5, 0.1, n=5, size=32)
    jmu, jlv = jnp.asarray(mu), jnp.asarray(logvar)
    assert abs(tlosses.kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar)).item()
               - float(jlosses.kld_loss(jmu, jlv))) <= LOSS_TOL * 10  # a sum of ~30

    def jtotal(recon, mu_, lv_):
        return jlosses.vae_loss(jnp.asarray(a), mu_, lv_, recon)["total_loss"]

    want = jax.jit(jlosses.vae_loss)(jnp.asarray(a), jmu, jlv, jnp.asarray(b))
    gr, gm, gl = jax.jit(jax.grad(jtotal, argnums=(0, 1, 2)))(jnp.asarray(b), jmu, jlv)
    tb, tmu, tlv = _nchw(b, grad=True), torch.tensor(mu, requires_grad=True), \
        torch.tensor(logvar, requires_grad=True)
    got = tlosses.vae_loss(_nchw(a), tmu, tlv, tb)
    assert set(got) == set(want) == {"total_loss", "recon_loss", "kld"}
    for k in got:
        assert abs(got[k].item() - float(want[k])) <= LOSS_TOL
    # kld is already weighted by 1e-3
    assert abs(got["kld"].item() / tlosses.kld_loss(tmu, tlv).item() - 1e-3) <= 1e-9
    got["total_loss"].backward()
    _close_grads(tb.grad, gr)
    for t, j in ((tmu, gm), (tlv, gl)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)
