"""The port's phase-split upsample+conv (critic_vae_tpu_torch/ops/upconv.py)
and its decoder, both modes, with and without FiLM, against the JAX package
on the same numpy weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from critic_vae_tpu.models import vae as jvae
from critic_vae_tpu.ops.upconv import _phase_kernels
from critic_vae_tpu.ops.upconv import upsample2_conv5 as jax_upconv
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.models.critic import conv, linear
from critic_vae_tpu_torch.ops.upconv import phase_kernels, upsample2_conv5

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
F32_TOL = 1e-5  # relative to the largest output, float32 summation order


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 5, 16, 24), (5, 5, 32, 3), (5, 5, 256, 128)])
def test_phase_kernels_bitwise_equal_to_jax(shape, dtype):
    """Rows summed and rounded first, then columns, as XLA contracts the
    JAX package's three-operand einsum."""
    w = np.random.default_rng(shape[2]).normal(size=shape).astype(np.float32)
    wj = jnp.asarray(w).astype(dtype)
    want = np.asarray(jax.jit(_phase_kernels)(wj).astype(jnp.float32))  # (a, b, u, v, i, o)
    got = phase_kernels(_oihw(np.asarray(wj.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, shape[3], shape[2], 3, 3)
    np.testing.assert_array_equal(got.float().numpy(), want.transpose(0, 1, 5, 4, 2, 3))


@pytest.mark.parametrize("cin,cout", [(8, 8), (32, 3)])
def test_upsample2_conv5_f32_against_jax_and_literal(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(3, 8, 8, cin)).astype(np.float32)
    w = (rng.normal(size=(5, 5, cin, cout)) / np.sqrt(25 * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    want = np.asarray(jax.jit(jax_upconv)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = upsample2_conv5(_nchw(x), _oihw(w), torch.from_numpy(b))
    assert got.shape == (3, cout, 16, 16)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want.transpose(0, 3, 1, 2)).max() <= F32_TOL * scale
    literal = F.conv2d(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"), _oihw(w),
                       torch.from_numpy(b), padding=2)
    assert (got - literal).abs().max().item() <= F32_TOL * scale


def test_upsample2_conv5_bf16_against_jax():
    """bf16: the same phase kernels and the bias after the interleave; the
    conv's own summation order may move a rare output by one bf16 ulp."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 16, 16, 32)).astype(np.float32)
    w = (rng.normal(size=(5, 5, 32, 32)) / 40).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax_upconv)(xb, jnp.asarray(w), jnp.asarray(b))
                      .astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = upsample2_conv5(_nchw(np.asarray(xb.astype(jnp.float32))).bfloat16(), _oihw(w),
                          torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert np.mean(got.float().numpy() == want) >= 0.999


def _film_params(seed, **kw):
    """Narrow JAX-layout VAE params with nonzero film{i} layers."""
    params, state = weights.numpy_vae_params(seed, **kw)
    rng = np.random.default_rng(seed + 100)
    dims = kw.get("dims", (32, 64, 128, 256))
    for i, co in enumerate((dims[2], dims[1], dims[0], dims[0])):
        params["decoder"][f"film{i}"] = {
            "w": rng.normal(0, 0.3, (1, 2 * co)).astype(np.float32),
            "b": rng.normal(0, 0.1, (2 * co,)).astype(np.float32),
        }
    return params, state


@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "literal"])
def test_decoder_against_jax_decode(fused, film):
    params, state = _film_params(6, **NARROW) if film else weights.numpy_vae_params(6, **NARROW)
    vae = weights.vae_from_params(params, state)
    assert (vae.decoder.film is not None) == film
    rng = np.random.default_rng(7)
    z = rng.normal(size=(6, 32)).astype(np.float32)
    v = rng.random(6).astype(np.float32)
    dec = jax.jit(lambda p, z, v: jvae.decode(p, z, v, fused=fused, apply_tanh=False))
    want = np.asarray(dec(params, jnp.asarray(z), jnp.asarray(v))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z), torch.from_numpy(v), apply_tanh=False,
                         fused=fused).numpy()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    # bf16: each op rounds as XLA rounds the JAX decode
    zb, vb = jnp.asarray(z).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    want16 = np.asarray(dec(params, zb, vb).astype(jnp.float32)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got16 = vae.decode(torch.from_numpy(np.array(zb.astype(jnp.float32))).bfloat16(),
                           torch.from_numpy(np.array(vb.astype(jnp.float32))).bfloat16(),
                           apply_tanh=False, fused=fused)
    assert got16.dtype == torch.bfloat16
    assert np.mean(got16.float().numpy() == want16) >= 0.999


def test_fused_and_literal_decoders_agree_in_f32():
    vae = weights.vae_from_params(*_film_params(8, **NARROW))
    z = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 32)).astype(np.float32))
    v = torch.tensor([0.0, 0.3, 0.7, 1.0])
    with torch.no_grad():
        a = vae.decode(z, v, apply_tanh=False, fused=True)
        b = vae.decode(z, v, apply_tanh=False, fused=False)
    assert (a - b).abs().max().item() <= F32_TOL * b.abs().max().item()


def test_film_round_trips_through_the_bridge():
    params, state = _film_params(3, **NARROW)
    back, back_state = weights.vae_to_params(weights.vae_from_params(params, state))
    for i in range(4):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back["decoder"][f"film{i}"][leaf],
                                          params["decoder"][f"film{i}"][leaf])
    assert "film0" not in weights.vae_to_params(
        weights.vae_from_params(*weights.numpy_vae_params(3, **NARROW)))[0]["decoder"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_keeps_its_phase_weights_until_the_weights_change(dtype):
    """The decoder builds each stage's phase weight once per dtype and reuses
    it; its decode is bitwise the one that rebuilds the weight every call; an
    in-place load of new weights rebuilds it."""
    dt = getattr(torch, dtype)
    vae = weights.vae_from_params(*weights.numpy_vae_params(10, **NARROW))
    dec = vae.decoder
    z = torch.from_numpy(np.random.default_rng(11).normal(size=(3, 32)).astype(np.float32))
    v = torch.tensor([0.1, 0.5, 0.9])

    def uncached():
        x = F.relu(conv(dec.convs[0], linear(dec.input, torch.cat([z, v[:, None]], 1).to(dt))
                        .view(3, *dec.start_shape)))
        for i in (1, 2, 3):
            x = F.relu(upsample2_conv5(x, dec.convs[i].weight, dec.convs[i].bias))
        return upsample2_conv5(x, dec.convs[4].weight, dec.convs[4].bias)

    with torch.inference_mode():
        first = vae.decode(z.to(dt), v.to(dt), apply_tanh=False)
        kept = {k: w for k, (_, w) in dec._phase_weights.items()}
        assert sorted(i for i, d in kept if d == dt) == [1, 2, 3, 4]
        again = vae.decode(z.to(dt), v.to(dt), apply_tanh=False)
        assert all(dec._phase_weights[k][1] is w for k, w in kept.items())
        assert torch.equal(first, again) and torch.equal(first, uncached())
    vae.load_state_dict(
        weights.vae_from_params(*weights.numpy_vae_params(12, **NARROW)).state_dict())
    with torch.inference_mode():
        moved = vae.decode(z.to(dt), v.to(dt), apply_tanh=False)
        assert dec._phase_weights[(4, dt)][1] is not kept[(4, dt)]
        assert torch.equal(moved, uncached()) and not torch.equal(moved, first)
