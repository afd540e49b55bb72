"""The port's front end (critic_vae_tpu_torch.ops.poolconv, the serving
options of ``Critic.forward`` and ``VAE.encode``, and ``episode_forward``'s
front ends) against the JAX package on the same numpy weights and inputs.

Tolerances: float32 results within 1e-5 absolute, relative to the largest
magnitude where that exceeds 1 (summation order differs between XLA's and
torch's CPU convs); bfloat16 results within a few bf16
ulps of values in [0, 1] (2^-6), since the two frameworks round each layer's
bf16 output at other places. Layout moves (packing, embedding,
space-to-depth) are exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu.models import critic as jcritic
from critic_vae_tpu.models import vae as jvae
from critic_vae_tpu.ops import mask as jmask
from critic_vae_tpu.ops import poolconv as jpc
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.models.critic import conv
from critic_vae_tpu_torch.models.vae import FUSED_POOL_SERVING, batchnorm_eval
from critic_vae_tpu_torch.ops import mask as tmask
from critic_vae_tpu_torch.ops import poolconv as tpc

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


# ----------------------------------------------------------------- poolconv


POOLCONV = ("pack_pool_phases", "conv_pool2_phases", "conv_pool2_max", "_embed6",
            "space_to_depth2", "s2d_pool_weights", "s2d_conv_pool2_phases")


@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("fn", POOLCONV)
def test_poolconv_matches_jax(fn, k, cin):
    rng = np.random.default_rng(10 * k + cin)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    xt, wt = _nchw(x), _oihw(w)
    if fn == "pack_pool_phases":
        np.testing.assert_array_equal(_hwio(tpc.pack_pool_phases(wt)),
                                      np.asarray(jpc.pack_pool_phases(jnp.asarray(w))))
    elif fn == "_embed6":
        want = np.asarray(jpc._embed6(jpc.pack_pool_phases(jnp.asarray(w)), k))
        np.testing.assert_array_equal(_hwio(tpc._embed6(tpc.pack_pool_phases(wt), k)), want)
    elif fn == "space_to_depth2":
        np.testing.assert_array_equal(_nhwc(tpc.space_to_depth2(xt)),
                                      np.asarray(jpc.space_to_depth2(jnp.asarray(x))))
    elif fn == "s2d_pool_weights":
        np.testing.assert_array_equal(_hwio(tpc.s2d_pool_weights(wt)),
                                      np.asarray(jpc.s2d_pool_weights(jnp.asarray(w))))
    elif fn == "conv_pool2_max":
        want = np.asarray(jpc.conv_pool2_max(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        got = _nhwc(tpc.conv_pool2_max(xt, wt, torch.from_numpy(b)))
        assert got.shape == want.shape == (2, 4, 4, 6)
        assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max())
    else:  # the two phase convs: (B, 4, C, h, w) here, (B, h, w, 4, C) there
        want = np.asarray(getattr(jpc, fn)(jnp.asarray(x), jnp.asarray(w)))
        got = getattr(tpc, fn)(xt, wt).permute(0, 3, 4, 1, 2).numpy()
        assert got.shape == want.shape == (2, 4, 4, 4, 6)
        assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max())


def test_phase_max_is_the_pool_of_the_conv():
    """The phases' max is maxpool2 of the SAME conv, for both formulations."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 3, 5, 5)).astype(np.float32))
    want = torch.nn.functional.max_pool2d(torch.nn.functional.conv2d(x, w, padding=2), 2)
    for fn in (tpc.conv_pool2_phases, tpc.s2d_conv_pool2_phases):
        err = (fn(x, w).amax(dim=1) - want).abs().max().item()
        assert err <= F32_TOL * max(1.0, want.abs().max().item())


# ----------------------------------------------------------------- the nets


@pytest.fixture(scope="module")
def critic_np():
    return weights.load_critic_npz(CRITIC_NPZ)


@pytest.fixture(scope="module")
def narrow_vae():
    """A narrow VAE with non-trivial BN statistics, negative scales included,
    so per-phase BN and the folded BN are really exercised."""
    params, state = weights.numpy_vae_params(3, **NARROW)
    rng = np.random.default_rng(4)
    for i in range(4):
        c = params["encoder"][f"bn{i}"]["scale"].shape[0]
        params["encoder"][f"bn{i}"]["scale"] = rng.uniform(-1.5, 1.5, c).astype(np.float32)
        params["encoder"][f"bn{i}"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[f"bn{i}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        state[f"bn{i}"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return params, state


def _frames(n, seed):
    return np.random.default_rng(seed).random((n, 64, 64, 3), dtype=np.float32)


CRITIC_CASES = {
    "fused_pool": dict(fused_pool=True),
    "s2d": dict(fused_pool="s2d"),
    "block0_f32": dict(block0_f32=True),
    "block0_f32_bf16": dict(block0_f32=True, downstream_dtype="bfloat16"),
    "start_block_1": dict(start_block=1),
}


@pytest.mark.parametrize("case", list(CRITIC_CASES))
def test_critic_forward_options_match_critic_apply(critic_np, case):
    kw = dict(CRITIC_CASES[case])
    x = _frames(5, 0)
    if kw.get("start_block"):  # block 0's post-pool activation
        x = np.maximum(np.random.default_rng(1).normal(size=(5, 32, 32, 8)), 0).astype(np.float32)
    ddt = kw.pop("downstream_dtype", None)
    apply = jax.jit(functools.partial(jcritic.critic_apply,
                                      downstream_dtype=ddt and jnp.dtype(ddt), **kw))
    want = np.asarray(apply(critic_np, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = weights.critic_from_params(critic_np)(
            _nchw(x), downstream_dtype=ddt and getattr(torch, ddt), **kw)
    assert got.shape == want.shape == (5, 1)
    assert got.dtype == (torch.bfloat16 if ddt else torch.float32)
    assert np.abs(got.float().numpy() - want).max() <= (BF16_TOL if ddt else F32_TOL)


ENCODE_CASES = {
    "fused_pool": dict(fused_pool=True),
    "fused_pool_all": dict(fused_pool=(True, True, True, True)),
    "fused_pool_mixed": dict(fused_pool=("s2d", "s2d", True, False)),
    "fold_bn": dict(fold_bn=True),
    "strided": dict(pool_impl="strided"),
    "block0_f32_bf16": dict(block0_f32=True, downstream_dtype="bfloat16"),
    "start_block_1": dict(start_block=1),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_options_match_jax(narrow_vae, case):
    params, state = narrow_vae
    kw = dict(ENCODE_CASES[case])
    x = _frames(4, 2)
    if kw.get("start_block"):  # block 0's post-activation output
        x = np.maximum(np.random.default_rng(3).normal(size=(4, 32, 32, 4)), 0).astype(np.float32)
    ddt = kw.pop("downstream_dtype", None)
    encode = jax.jit(functools.partial(jvae.encode, train=False,
                                       downstream_dtype=ddt and jnp.dtype(ddt), **kw))
    mu_j, lv_j, _ = encode(params, state, jnp.asarray(x))
    with torch.no_grad():
        mu, lv = weights.vae_from_params(params, state).encode(
            _nchw(x), downstream_dtype=ddt and getattr(torch, ddt), **kw)
    tol = BF16_TOL if ddt else F32_TOL
    assert mu.shape == (4, 32) and mu.dtype == (torch.bfloat16 if ddt else torch.float32)
    assert np.abs(mu.float().numpy() - np.asarray(mu_j, np.float32)).max() <= tol
    assert np.abs(lv.float().numpy() - np.asarray(lv_j, np.float32)).max() <= tol


def test_encode_fused_pool_true_is_the_serving_tuple(narrow_vae):
    vae = weights.vae_from_params(*narrow_vae)
    x = _nchw(_frames(2, 5))
    with torch.no_grad():
        a = vae.encode(x, fused_pool=True)
        b = vae.encode(x, fused_pool=FUSED_POOL_SERVING)
    assert FUSED_POOL_SERVING == tuple(jvae.FUSED_POOL_SERVING)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        vae.encode(x, pool_impl="window")


# ------------------------------------------------------------ episode_forward


@pytest.fixture(scope="module")
def stage(critic_np, narrow_vae):
    frames, _ = generate_frames(4, seed=3)
    params, state = narrow_vae
    return dict(frames=frames, params=params, state=state,
                critic_j={k: jnp.asarray(v) for k, v in critic_np.items()},
                vae=weights.vae_from_params(params, state),
                critic=weights.critic_from_params(critic_np))


EPISODE_CASES = {
    "default": {},
    "auto": dict(front_end="auto"),
    "split": dict(front_end="split"),
    "merged": dict(front_end="merged"),
    "fused_pool": dict(fused_pool=True),
    "fused_pool_all": dict(fused_pool=(True, True, True, True)),
    "fold_bn": dict(fold_bn=True),
    "strided": dict(pool_impl="strided"),
    "block0_f32": dict(block0_f32=True),
    "merged_fused_pool": dict(front_end="merged", fused_pool=True),
}


@pytest.mark.parametrize("case", list(EPISODE_CASES))
def test_episode_forward_front_ends_match_jax(stage, case):
    """The port's episode_forward against JAX's with the same arguments; the
    default case is the port's default against JAX's default."""
    kw = EPISODE_CASES[case]
    want = jmask.episode_forward(stage["params"], stage["state"], stage["critic_j"],
                                 jnp.asarray(stage["frames"]), with_recons=False, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tmask.episode_forward(stage["vae"], stage["critic"],
                                torch.from_numpy(stage["frames"]), **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["diff"].shape == (4, 64, 64) and got["preds"].shape == (4,)
    assert np.abs(got["preds"] - want["preds"]).max() <= 1e-4
    assert np.abs(got["diff"] - want["diff"]).max() <= F32_TOL
    assert np.abs(got["max_value"] - want["max_value"]).max() <= F32_TOL
    u8_j = np.asarray(jmask.normalize_diffs(jnp.asarray(want["diff"]),
                                            jnp.asarray(want["max_value"]))[0]).astype(int)
    u8_t = tmask.normalize_diffs(torch.from_numpy(got["diff"]),
                                 torch.from_numpy(got["max_value"]))[0].numpy().astype(int)
    assert np.mean(np.abs(u8_t - u8_j) <= 1) >= 0.999
    assert np.mean((u8_t > 50) == (u8_j > 50)) >= 0.998


@pytest.mark.parametrize("front_end", ["split", "merged"])
def test_episode_forward_block0_f32_bf16_matches_jax(stage, front_end):
    """block0_f32 with a bf16 compute dtype: the f32 first convs cast to
    bf16 as in the JAX package; the preds agree within bf16 rounding."""
    kw = dict(front_end=front_end, block0_f32=True, compute_dtype="bfloat16")
    want = jmask.episode_forward(stage["params"], stage["state"], stage["critic_j"],
                                 jnp.asarray(stage["frames"]), with_recons=False, **kw)
    got = tmask.episode_forward(stage["vae"], stage["critic"],
                                torch.from_numpy(stage["frames"]), **kw)
    assert got["preds"].dtype == torch.float32 and np.isfinite(got["diff"].numpy()).all()
    assert np.abs(got["preds"].numpy() - np.asarray(want["preds"])).max() <= BF16_TOL


def _jax_front_end(stage, **kw):
    """The front end JAX's episode_forward traced: merged iff its program
    holds the merged (5, 5, 3, C_enc + C_critic) first-conv weights."""
    fn = functools.partial(jmask.episode_forward, with_recons=False, **kw)
    text = str(jax.make_jaxpr(fn)(stage["params"], stage["state"], stage["critic_j"],
                                  np.zeros((1, 64, 64, 3), np.uint8)))
    merged = f"[5,5,3,{NARROW['dims'][0] + 8}]"
    return "merged" if merged in text else "split"


@pytest.mark.parametrize("block0_f32", [False, True])
@pytest.mark.parametrize("fold_bn", [False, True])
@pytest.mark.parametrize("fused_pool", [False, True])
def test_auto_front_end_resolves_as_jax(stage, fused_pool, fold_bn, block0_f32):
    kw = dict(fused_pool=fused_pool, fold_bn=fold_bn, block0_f32=block0_f32)
    want = _jax_front_end(stage, front_end="auto", **kw)
    assert tmask.resolve_front_end("auto", **kw) == want
    assert want == ("merged" if not (fused_pool or fold_bn or block0_f32) else "split")
    for explicit in ("split", "merged"):
        assert tmask.resolve_front_end(explicit, **kw) == explicit


def test_unknown_front_end_raises_in_both(stage):
    with pytest.raises(ValueError):
        _jax_front_end(stage, front_end="fused")
    with pytest.raises(ValueError):
        tmask.episode_forward(stage["vae"], stage["critic"],
                              torch.from_numpy(stage["frames"]), front_end="fused")


def test_merged_front_end_equals_split_block0(stage):
    """The merged conv's two branches are the split nets' block-0 outputs."""
    vae, critic = stage["vae"], stage["critic"]
    x = _nchw(stage["frames"].astype(np.float32) / 255.0)
    with torch.no_grad():
        h_enc, h_cr = tmask.merged_front_end(vae, critic, x, torch.float32)
        enc0, bn0 = vae.encoder.convs[0], vae.encoder.bns[0]
        want_enc = torch.relu(torch.nn.functional.max_pool2d(batchnorm_eval(bn0, conv(enc0, x)), 2))
        want_cr = torch.nn.functional.max_pool2d(torch.relu(conv(critic.convs[0], x)), 2)
    assert (h_enc - want_enc).abs().max() <= F32_TOL
    assert (h_cr - want_cr).abs().max() <= F32_TOL
