"""The port's weight bridge and models (critic_vae_tpu_torch.io.weights,
models/) against the JAX package on the same numpy weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.models import critic as jcritic
from critic_vae_tpu.models import vae as jvae
from critic_vae_tpu_torch.io import weights

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)


@pytest.fixture(scope="module")
def critic_np():
    return weights.load_critic_npz(CRITIC_NPZ)


@pytest.fixture(scope="module")
def narrow_vae():
    params, state = weights.numpy_vae_params(3, **NARROW)
    # non-trivial BN statistics, so eval-mode BatchNorm is really exercised
    rng = np.random.default_rng(4)
    for i in range(4):
        c = params["encoder"][f"bn{i}"]["scale"].shape[0]
        params["encoder"][f"bn{i}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params["encoder"][f"bn{i}"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[f"bn{i}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[f"bn{i}"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return params, state


def _frames(n, seed):
    return np.random.default_rng(seed).random((n, 64, 64, 3), dtype=np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_critic_npz_load_and_round_trip_exact(critic_np):
    with np.load(CRITIC_NPZ) as raw:
        assert set(raw.files) == set(critic_np)
        for k in raw.files:
            np.testing.assert_array_equal(raw[k], critic_np[k])
    back = weights.critic_to_params(weights.critic_from_params(critic_np))
    assert set(back) == set(critic_np)
    for k, v in critic_np.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_vae_round_trip_and_npz_exact(narrow_vae, tmp_path):
    params, state = narrow_vae
    back_p, back_s = weights.vae_to_params(weights.vae_from_params(params, state))
    path = str(tmp_path / "vae.npz")
    weights.save_vae_npz(path, params, state)
    file_p, file_s = weights.load_vae_npz(path)
    for got in ((back_p, back_s), (file_p, file_s)):
        want = _leaves((params, state))
        have = _leaves(got)
        assert [p for p, _ in have] == [p for p, _ in want]
        for (_, a), (_, b) in zip(have, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, NARROW], ids=["full", "narrow"])
def test_numpy_vae_params_matches_init_layout(kw):
    # shapes and dtypes of init_vae_params without running it
    want_tree = jax.eval_shape(lambda k: jvae.init_vae_params(k, **kw), jax.random.key(0))
    npp, nps = weights.numpy_vae_params(0, **kw)
    want = [(p, tuple(v.shape), np.dtype(v.dtype)) for p, v in _leaves(want_tree)]
    have = [(p, np.shape(v), np.asarray(v).dtype) for p, v in _leaves((npp, nps))]
    assert have == want
    # the same torch-default uniform bounds: every conv/linear leaf spans
    # most of, and stays inside, +-1/sqrt(fan_in)
    w = npp["encoder"]["conv1"]["w"]
    bound = 1.0 / np.sqrt(w.shape[0] * w.shape[1] * w.shape[2])
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert not np.array_equal(weights.numpy_vae_params(1, **kw)[0]["decoder"]["conv4"]["w"],
                              npp["decoder"]["conv4"]["w"])


def test_critic_preds_match_jax_full_width(critic_np):
    x = _frames(8, 0)
    want = np.asarray(jcritic.critic_apply({k: jnp.asarray(v) for k, v in critic_np.items()},
                                           jnp.asarray(x)))
    with torch.no_grad():
        got = weights.critic_from_params(critic_np)(_nchw(x)).numpy()
    assert got.shape == want.shape == (8, 1)
    assert np.abs(got - want).max() <= 1e-5


def test_encode_matches_jax(narrow_vae):
    params, state = narrow_vae
    x = _frames(6, 1)
    mu_j, lv_j, _ = jvae.encode(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        mu, lv = weights.vae_from_params(params, state).encode(_nchw(x))
    assert mu.shape == (6, 32)
    assert np.abs(mu.numpy() - np.asarray(mu_j)).max() <= 1e-5
    assert np.abs(lv.numpy() - np.asarray(lv_j)).max() <= 1e-5


@pytest.mark.parametrize("fused,tol", [(False, 1e-5), (True, 1e-4)],
                         ids=["literal", "phase_split"])
def test_decode_pre_tanh_matches_jax(narrow_vae, fused, tol):
    """The port's decoder is the literal repeat-then-conv graph; the JAX
    default (fused=True, ops/upconv.py) equals it up to reassociation."""
    params, state = narrow_vae
    rng = np.random.default_rng(2)
    z = rng.normal(size=(5, 32)).astype(np.float32)
    v = rng.random(5).astype(np.float32)
    want = np.asarray(jvae.decode(params, jnp.asarray(z), jnp.asarray(v),
                                  fused=fused, apply_tanh=False))
    with torch.no_grad():
        got = weights.vae_from_params(params, state).decode(
            torch.from_numpy(z), torch.from_numpy(v), apply_tanh=False)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (5, 64, 64, 3)
    assert np.abs(got - want).max() <= tol
