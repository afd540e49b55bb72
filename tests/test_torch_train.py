"""The port's VAE training (critic_vae_tpu_torch: models/vae.py's train
mode, train/step.py, pipelines/train.py, io/checkpoint.py, io/events.py,
data/sources.py, data/sampler.py and the ``train`` command) against the JAX
package on the same numpy inputs, at a narrow width (VAE dims (4, 8, 8, 16),
the full-width critic of critic-synthetic.npz).

The JAX package draws its reparametrize noise from threefry, so each step
here is given JAX's draws, replayed from its state's key (split, then
normal (B, 32) float32, as ``_step_logic`` does). Tolerances, float32:

* per-step losses (total, recon, kld) within 1e-5 relative;
* BatchNorm running stats after the first step (computed from the same
  parameters) within 1e-6: means absolute, variances relative;
* after 3 steps, BatchNorm running variances within 1e-5 relative; running
  means within 1.5·lr: the encoder's conv biases have a zero gradient in exact
  arithmetic (train-mode BatchNorm removes them), so each implementation's
  float noise there is what Adam normalises into a move of up to lr a step,
  and the batch mean, hence the running mean, carries the bias;
* parameters: those biases within 2·lr a step, every other leaf within
  0.25·lr (Adam's first steps turn near-zero gradients into ±lr, so the
  bound is in units of lr; a real fault moves whole leaves by lr or more).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from critic_vae_tpu.data import sampler as jsampler
from critic_vae_tpu.data import sources as jsources
from critic_vae_tpu.io import checkpoint as jckpt
from critic_vae_tpu.io import events as jevents
from critic_vae_tpu.models import vae as jvae
from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.pipelines import train as jtrain
from critic_vae_tpu.train import step as jstep
from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.data import sampler as tsampler
from critic_vae_tpu_torch.data import sources as tsources
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import checkpoint as tckpt
from critic_vae_tpu_torch.io import events as tevents
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines import train as ttrain
from critic_vae_tpu_torch.train import step as tstep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
GOLDEN = "tests/golden/torch_train_golden.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
LR = 5e-5
LOSS_REL = 1e-5
BN_VAR_REL = 1e-5
BN_FIRST = 1e-6  # the first step's BN stats: means absolute, variances relative
BN_MEAN_ABS = 1.5 * LR
PARAM_TOL = 0.25 * LR
ENC_CONV_BIASES = {f"encoder/conv{i}/b" for i in range(4)}


def _tx():
    return optax.apply_if_finite(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
                                 max_consecutive_errors=100)


def _jax_state(params, bn_state, key):
    p = jax.tree.map(jnp.asarray, params)
    return jstep.TrainState(p, jax.tree.map(jnp.asarray, bn_state), _tx().init(p), key,
                            jnp.zeros((), jnp.int32))


def _jax_eps(key, steps, batch):
    """The noise ``_step_logic`` draws from a state's key, step by step."""
    out = []
    for _ in range(steps):
        key, sample_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sample_key, (batch, 32), jnp.float32)))
    return np.stack(out)


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def _names(tree):
    return ["/".join(k.key for k in path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_state_close(state, jparams, jbn, steps):
    """The port's state against JAX-layout params and BN stats, at the
    module's tolerances."""
    got_p, got_bn = weights.vae_to_params(state.vae)
    for name in _names(jparams):
        bound = 2 * steps * LR if name in ENC_CONV_BIASES else PARAM_TOL
        err = np.abs(_leaf(got_p, name) - _leaf(jparams, name)).max()
        assert err <= bound, (name, err / LR)
    for i in range(4):
        m, v = got_bn[f"bn{i}"]["mean"], got_bn[f"bn{i}"]["var"]
        assert np.abs(m - _leaf(jbn, f"bn{i}/mean")).max() <= BN_MEAN_ABS
        np.testing.assert_allclose(v, _leaf(jbn, f"bn{i}/var"), rtol=BN_VAR_REL, atol=0)


def _assert_losses_close(got, want):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=LOSS_REL, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def critics():
    crit = weights.load_critic_npz(CRITIC_NPZ)
    return weights.critic_from_params(crit), jax_load_critic(CRITIC_NPZ)


@pytest.fixture(scope="module")
def narrow():
    return weights.numpy_vae_params(3, **NARROW)


@pytest.fixture(scope="module")
def dataset():
    return generate_frames(12, seed=1)[0]


@pytest.fixture(scope="module")
def jax_run(critics, narrow, dataset):
    """3 steps of the JAX multi-step loop over (3, 4) batch indices."""
    idx = np.random.default_rng(0).permutation(12)[:12].reshape(3, 4).astype(np.int32)
    key = jax.random.key(7)
    multi = jstep.make_multi_step(critics[1], _tx(), compute_dtype=jnp.float32, donate=False)
    state, metrics = multi(_jax_state(*narrow, key), jnp.asarray(dataset), jnp.asarray(idx))
    return {"idx": idx, "eps": _jax_eps(key, 3, 4), "state": state,
            "losses": {k: np.asarray(v) for k, v in metrics.items()}}


def _nchw(frames):
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------- the model


def test_train_mode_batchnorm_matches_jax(narrow):
    params, bn_state = narrow
    x = np.random.default_rng(2).random((6, 64, 64, 3), dtype=np.float32)
    mu, logvar, new = jax.jit(lambda p, s, xx: jvae.encode(p, s, xx, train=True))(
        params, bn_state, jnp.asarray(x))
    vae = weights.vae_from_params(params, bn_state)
    tmu, tlv, stats = vae.encode(_nchw(x), train=True)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(logvar), rtol=1e-5, atol=1e-5)
    for i, (m, v) in enumerate(stats):
        np.testing.assert_allclose(m.numpy(), np.asarray(new[f"bn{i}"]["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(new[f"bn{i}"]["var"]), rtol=1e-6, atol=0)
    # the module's own running stats are not written by a train-mode encode
    for bn, i in zip(vae.encoder.bns, range(4)):
        np.testing.assert_array_equal(bn.running_mean.numpy(), bn_state[f"bn{i}"]["mean"])


@pytest.mark.parametrize("option", [{"fused_pool": True}, {"fold_bn": True}])
def test_train_encode_refuses_serving_options(narrow, option):
    vae = weights.vae_from_params(*narrow)
    with pytest.raises(ValueError, match="eval-mode serving paths"):
        vae.encode(torch.zeros(2, 3, 64, 64), train=True, **option)


def test_vae_methods_match_jax(narrow):
    """vae_apply (train mode), evaluate, recon_samples and inject, with JAX's
    draws given to the port."""
    params, bn_state = narrow
    x = np.random.default_rng(3).random((3, 64, 64, 3), dtype=np.float32)
    value = np.float32([0.1, 0.5, 0.9])
    key = jax.random.key(5)
    jx, jv = jnp.asarray(x), jnp.asarray(value)
    vae = weights.vae_from_params(params, bn_state)
    tx, tv = _nchw(x), torch.from_numpy(value)

    def nhwc(t):
        return t.detach().numpy().transpose(*range(t.dim() - 3), -2, -1, -3)

    ladder = np.float32([0.0, 0.5, 1.0])

    @jax.jit
    def jax_all(p, s, xx, vv):
        return (jvae.vae_apply(p, s, key, xx, vv, train=True)[0], jvae.evaluate(p, s, xx, vv),
                jvae.recon_samples(p, s, key, xx, vv, n_samples=4), jvae.inject(p, s, xx),
                jvae.inject(p, s, xx, jnp.asarray(ladder)))

    recon, evaluated, samples, *injected = jax_all(params, bn_state, jx, jv)
    eps = np.asarray(jax.random.normal(key, (3, 32), jnp.float32))
    got = vae.vae_apply(tx, tv, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(recon), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc(vae.evaluate(tx, tv)), np.asarray(evaluated), atol=1e-5)
    eps = np.asarray(jax.random.normal(key, (12, 32), jnp.float32))
    got = vae.recon_samples(tx, tv, 4, eps=torch.from_numpy(eps))
    assert got.shape == (3, 4, 3, 64, 64)
    np.testing.assert_allclose(nhwc(got), np.asarray(samples), atol=1e-5)
    for values, want in zip((None, ladder), injected):
        got = vae.inject(tx, values)
        assert got.shape == (3, 6 if values is None else 3, 3, 64, 64)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


# -------------------------------------------------------------------- the step


@pytest.mark.parametrize("runner", ["step", "multi_step"])
def test_steps_match_jax(critics, narrow, dataset, jax_run, runner):
    state = tstep.init_train_state(*narrow, device="cpu")
    eps = torch.from_numpy(jax_run["eps"])
    if runner == "step":
        step = tstep.make_train_step(critics[0], learning_rate=LR)
        rows = [step(state, torch.from_numpy(dataset[i]), eps[k])
                for k, i in enumerate(jax_run["idx"])]
        losses = {k: np.stack([r[k].numpy() for r in rows]) for k in rows[0]}
    else:
        multi = tstep.make_multi_step(critics[0], learning_rate=LR)
        out = multi(state, torch.from_numpy(dataset), torch.from_numpy(jax_run["idx"]), eps)
        losses = {k: v.numpy() for k, v in out.items()}
    _assert_losses_close(losses, jax_run["losses"])
    js = jax_run["state"]
    _assert_state_close(state, js.params, js.bn_state, 3)
    assert int(state.step) == int(js.step) == 3
    assert float(state.counts[0]) == 3.0


def test_train_golden_at_full_width(critics):
    """The full-width golden that chip_smoke.py holds the card against, on
    the CPU: 3 steps from numpy_vae_params(0) with the golden's draws."""
    gold = np.load(GOLDEN)
    params, bn_state = weights.numpy_vae_params(int(gold["seed"]))
    state = tstep.init_train_state(params, bn_state, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=float(gold["lr"]))
    frames = torch.from_numpy(generate_frames(int(gold["batch"]), seed=int(gold["seed"]))[0])
    rows = []
    for e in gold["eps"]:
        rows.append(step(state, frames, torch.from_numpy(e)))
        if len(rows) == 1:  # the BN update itself, before the parameters drift
            for i, bn in enumerate(state.vae.encoder.bns):
                np.testing.assert_allclose(bn.running_mean.numpy(), gold[f"bn{i}_mean_1"],
                                           rtol=0, atol=BN_FIRST)
                np.testing.assert_allclose(bn.running_var.numpy(), gold[f"bn{i}_var_1"],
                                           rtol=BN_FIRST, atol=0)
    _assert_losses_close({k: [r[k].item() for r in rows] for k in rows[0]},
                         {k: gold[k] for k in rows[0]})
    got_p, got_bn = weights.vae_to_params(state.vae)
    steps = int(gold["steps"])
    for key in gold.files:
        if key.startswith("delta/"):
            name = key[len("delta/"):]
            delta = (_leaf(got_p, name) - _leaf(params, name)).ravel()[gold[f"index/{name}"]]
            bound = 2 * steps * LR if name in ENC_CONV_BIASES else PARAM_TOL
            assert np.abs(delta - gold[key]).max() <= bound, name
    for i in range(4):
        assert np.abs(got_bn[f"bn{i}"]["mean"] - gold[f"bn{i}_mean"]).max() <= BN_MEAN_ABS
        np.testing.assert_allclose(got_bn[f"bn{i}"]["var"], gold[f"bn{i}_var"], rtol=BN_VAR_REL)


def test_full_width_kld_error_is_the_encoders():
    """Step 1's kld at full width, split: the train-mode encoder's mu and
    logvar against JAX's (the golden's, same parameters and frames) within
    1e-4 (float32 conv sums in another order; measured 3e-6 to 3e-5 with
    the memory layout); the KL of them within 1e-6 of JAX's and of float64
    on the same tensors. The kld's larger error after 3 steps therefore
    comes from the parameters' drift, not from the KL's arithmetic."""
    from critic_vae_tpu_torch.ops.losses import kld_loss

    gold = np.load(GOLDEN)
    state = tstep.init_train_state(*weights.numpy_vae_params(int(gold["seed"])), device="cpu")
    frames = generate_frames(int(gold["batch"]), seed=int(gold["seed"]))[0]
    x = torch.from_numpy(frames).float().div(255.0).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        mu, logvar, _ = state.vae.encode(x, train=True)
    np.testing.assert_allclose(mu.numpy(), gold["mu1"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), gold["logvar1"], rtol=0, atol=1e-4)
    kl32 = kld_loss(mu, logvar).item()
    kl64 = kld_loss(mu.double(), logvar.double()).item()
    jax64 = kld_loss(*(torch.from_numpy(gold[k]).double() for k in ("mu1", "logvar1"))).item()
    assert abs(kl32 / kl64 - 1) <= 1e-6
    assert abs(kl64 / jax64 - 1) <= 1e-6
    np.testing.assert_allclose(1e-3 * kl32, gold["kld"][0], rtol=1e-6)


def test_adam_matches_numpy(critics, narrow, dataset, monkeypatch):
    """The step's update is optax's Adam (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, bias correction by the count) on the step's own
    gradients, held against numpy over 3 steps."""
    seen = []
    real = tstep.adam

    def spy(params, grads, *args, **kwargs):
        seen.append([g.numpy().copy() for g in grads])
        return real(params, grads, *args, **kwargs)

    monkeypatch.setattr(tstep, "adam", spy)
    state = tstep.init_train_state(*narrow, device="cpu")
    p = [t.detach().numpy().astype(np.float64) for t in state.params]
    m = [np.zeros_like(a) for a in p]
    v = [np.zeros_like(a) for a in p]
    step = tstep.make_train_step(critics[0], learning_rate=LR)
    for t in range(1, 4):
        step(state, torch.from_numpy(dataset[:4]))
        for j, g in enumerate(seen[-1]):
            m[j] = 0.9 * m[j] + 0.1 * g
            v[j] = 0.999 * v[j] + 0.001 * g.astype(np.float64) ** 2
            p[j] = p[j] - LR * (m[j] / (1 - 0.9**t)) / (np.sqrt(v[j] / (1 - 0.999**t)) + 1e-8)
    for j, t in enumerate(state.params):
        # within 1e-3·lr, beyond two float32 ulps of the stored parameter
        np.testing.assert_allclose(t.detach().numpy(), p[j], rtol=2.0**-22, atol=1e-3 * LR)
        for got, want in ((state.mu[j], m[j]), (state.nu[j], v[j])):  # float32 rounding
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())


def _snapshot(state):
    return ([t.detach().clone() for t in state.params + state.mu + state.nu + state.counts]
            + [b.clone() for bn in state.vae.encoder.bns for b in (bn.running_mean, bn.running_var)])


def test_nonfinite_steps_are_skipped_until_the_101st(critics, narrow, dataset):
    """``apply_if_finite(max_consecutive_errors=100)``: a NaN batch leaves the
    parameters, Adam's state and the BN stats as they are and advances the
    counters and the noise generator; a finite step resets the run; the
    101st NaN step in a row is applied (its update is NaN)."""
    state = tstep.init_train_state(*narrow, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=LR)
    good = torch.from_numpy(dataset[:2])
    bad = good.float() / 255.0
    bad[1, 5, 5, 0] = float("nan")
    before, rng = _snapshot(state), state.generator.get_state()
    losses = step(state, bad)
    assert not np.isfinite(losses["total_loss"].item())
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(state)))
    assert (int(state.notfinite_count), bool(state.last_finite), int(state.total_notfinite),
            int(state.step)) == (1, False, 1, 1)
    assert not torch.equal(rng, state.generator.get_state())
    step(state, good)
    assert (int(state.notfinite_count), bool(state.last_finite), int(state.total_notfinite),
            float(state.counts[0])) == (0, True, 1, 1.0)
    before = _snapshot(state)
    for _ in range(100):
        step(state, bad)
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(state)))
    assert (int(state.notfinite_count), int(state.total_notfinite)) == (100, 101)
    step(state, bad)  # the 101st in a row: applied anyway
    assert int(state.notfinite_count) == 101 and float(state.counts[0]) == 2.0
    assert not all(torch.isfinite(t).all() for t in state.params)
    bn = state.vae.encoder.bns[0]  # the BN stats stay as they were
    assert torch.equal(bn.running_mean, before[-8])


def test_value_consistency_matches_jax(critics, narrow, dataset):
    key = jax.random.key(9)
    jfn = jstep.make_train_step(critics[1], _tx(), compute_dtype=jnp.float32, donate=False,
                                value_consistency=0.5)
    jstate, want = jfn(_jax_state(*narrow, key), jnp.asarray(dataset[:4]))
    state = tstep.init_train_state(*narrow, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=LR, value_consistency=0.5)
    got = step(state, torch.from_numpy(dataset[:4]), torch.from_numpy(_jax_eps(key, 1, 4)[0]))
    assert set(got) == set(want) == {"total_loss", "recon_loss", "kld", "vc_loss"}
    _assert_losses_close({k: v.item() for k, v in got.items()},
                         {k: float(v) for k, v in want.items()})
    _assert_state_close(state, jstate.params, jstate.bn_state, 1)


def test_film_params_move(critics, dataset):
    params, bn_state = weights.numpy_vae_params(4, film=True, **NARROW)
    state = tstep.init_train_state(params, bn_state, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=LR)
    for _ in range(2):
        step(state, torch.from_numpy(dataset[:4]))
    film = [p for n, p in state.vae.named_parameters() if ".film." in n]
    assert len(film) == 8
    assert all(torch.isfinite(p).all() and p.abs().max() > 0 for p in film)


def test_bf16_step_descends_with_float32_state(critics, narrow, dataset):
    state = tstep.init_train_state(*narrow, device="cpu", seed=1)
    step = tstep.make_train_step(critics[0], learning_rate=1e-3, compute_dtype="bfloat16")
    batch = torch.from_numpy(dataset[:8])
    losses = [step(state, batch)["total_loss"].item() for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    tensors = state.params + state.mu + state.nu + [b for bn in state.vae.encoder.bns
                                                    for b in (bn.running_mean, bn.running_var)]
    assert all(t.dtype == torch.float32 for t in tensors)


# ------------------------------------------------------- the pipeline and files


def _train(critic, data, tmp, name, narrow, **kw):
    kw = dict(dict(epochs=2, batch_size=4, learning_rate=LR, seed=0, initial_params=narrow,
                   checkpoint_dir=str(tmp / name), checkpoint_every_steps=2, progress=False,
                   device="cpu"), **kw)
    return ttrain.train(critic, data, **kw)


def test_resume_mid_epoch_is_bitwise(critics, narrow, dataset, tmp_path):
    straight = _train(critics[0], dataset, tmp_path, "a", narrow)
    _train(critics[0], dataset, tmp_path, "b", narrow, epochs=1)
    for name in ("ckpt-3.npz", "ckpt-3.meta.json"):  # leave step 2: row 2 of epoch 0
        os.unlink(tmp_path / "b" / name)
    assert tckpt.latest_checkpoint(str(tmp_path / "b"))[1] == 2
    resumed = _train(critics[0], dataset, tmp_path, "b", narrow)
    a, b = tckpt.flatten(tstep.state_tree(straight)), tckpt.flatten(tstep.state_tree(resumed))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every 2 steps at the chunk ends (2, 3 | 5, 6), then at the end: 2, 5, 6
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt-2.meta.json", "ckpt-2.npz",
                                                 "ckpt-5.meta.json", "ckpt-5.npz",
                                                 "ckpt-6.meta.json", "ckpt-6.npz"]


@pytest.mark.parametrize("change", [dict(batch_size=3), dict(seed=1), dict(film=True),
                                    dict(data_rows=9)])
def test_resume_refuses_a_changed_run(critics, narrow, dataset, tmp_path, change):
    _train(critics[0], dataset, tmp_path, "c", narrow, epochs=1)
    change = dict(change)
    data = dataset[:change.pop("data_rows", len(dataset))]
    kw = dict(change, initial_params=None) if "film" in change else change
    with pytest.raises(ValueError, match="run configuration changed"):
        _train(critics[0], data, tmp_path, "c", narrow, **kw)


def test_log_cadence_and_scalars_follow_jax(critics, narrow, dataset, tmp_path, monkeypatch):
    """The port's metrics.jsonl logs the steps and tags JAX's does, at the
    reference cadence (every log_every_batches rows at row·B + N·ep)."""
    kw = dict(epochs=2, batch_size=4, log_every_batches=2, seed=0, progress=False)
    # JAX's train starts from the narrow state (its full-width threefry init
    # is skipped; the narrow state replaces it either way)
    monkeypatch.setattr(jtrain, "init_train_state",
                        lambda key, lr, film=False: (_jax_state(*narrow, key), _tx()))
    jtrain.train(critics[1], dataset, use_mesh=False, log_dir=str(tmp_path / "jax"), **kw)
    ttrain.train(critics[0], dataset, log_dir=str(tmp_path / "port"), initial_params=narrow,
                 device="cpu", **kw)

    def rows(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    want, got = rows("jax"), rows("port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 8, 12, 20]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert all(np.isfinite(r["total_loss"]) for r in got)


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    """Scalars, a histogram and an image: the same bytes as the JAX
    package's writer at the same wall time."""
    monkeypatch.setattr(jevents.time, "time", lambda: 1234.5)
    paths = []
    for mod, name in ((jevents, "jax"), (tevents, "port")):
        with mod.EventWriter(str(tmp_path / name)) as w:
            w.scalar("loss", 0.25, step=3)
            w.histogram("w", np.linspace(-1, 1, 50), step=4)
            w.image("probe", np.linspace(0, 1, 48, dtype=np.float32).reshape(4, 4, 3), step=5)
            paths.append(w.path)
    assert tevents.time is jevents.time  # the one clock both writers read
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    logger = tevents.MetricLogger(str(tmp_path / "log"))
    logger.log({"a": 1.0}, 7)
    logger.close()
    assert json.loads((tmp_path / "log" / "metrics.jsonl").read_text()) == {"step": 7, "a": 1.0}


def test_checkpoint_files_are_jaxs(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "file": np.int32(3), "rng": np.arange(4, dtype=np.uint8)}
    tckpt.save_pytree(str(tmp_path / "port.npz"), tree)
    jckpt.save_pytree(str(tmp_path / "jax.npz"), tree)
    for path in ("port.npz", "jax.npz"):
        for load in (tckpt.load_pytree, jckpt.load_pytree):
            back = load(str(tmp_path / path), tree)
            np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
            assert int(back["file"]) == 3
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    like = {"a": {"b": np.zeros((2, 3), np.float32)}, "file": np.int32(0),
            "rng": np.zeros(4, np.uint8)}
    for bad, error in (({**like, "extra": np.zeros(1)}, KeyError),
                       ({"a": like["a"], "file": like["file"]}, ValueError),
                       ({**like, "rng": np.zeros(5, np.uint8)}, ValueError),
                       ({**like, "rng": np.zeros(4, np.int8)}, ValueError)):
        with pytest.raises(error):
            tckpt.load_pytree(str(tmp_path / "port.npz"), bad)


@pytest.mark.parametrize("tree,error", [
    ({"a/b": np.zeros(1), "a": {"b": np.zeros(1)}}, ValueError),
    ({"x": np.array([object()], dtype=object)}, TypeError),
    ({"x": np.zeros(2, dtype="V2")}, TypeError),
])
def test_checkpoint_refuses_collisions_and_lossy_dtypes(tmp_path, tree, error):
    with pytest.raises(error):
        tckpt.save_pytree(str(tmp_path / "x.npz"), tree)
    with pytest.raises(error):
        jckpt.save_pytree(str(tmp_path / "y.npz"), tree)


def test_latest_and_prune_follow_jax(tmp_path):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        for name in ("ckpt-5.npz", "ckpt-40.npz", "ckpt-7.npz", "ckpt-x.npz", "other-9.npz"):
            (tmp_path / d / name).write_bytes(b"")
    assert (tckpt.latest_checkpoint(str(tmp_path / "port"))[1]
            == jckpt.latest_checkpoint(str(tmp_path / "jax"))[1] == 40)
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    tckpt.prune_checkpoints(str(tmp_path / "port"), 2)
    jckpt.prune_checkpoints(str(tmp_path / "jax"), 2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_final_weights_load_in_jax(critics, narrow, tmp_path):
    params, bn_state = weights.numpy_vae_params(6, film=True, **NARROW)
    state = tstep.init_train_state(params, bn_state, device="cpu")
    ttrain.save_final_weights(state, str(tmp_path / "e.ckpt"), str(tmp_path / "d.ckpt"))
    like = weights.numpy_vae_params(0, **NARROW)  # JAX reads the structure only
    jp, jbn = jtrain.load_final_weights(str(tmp_path / "e.ckpt"), str(tmp_path / "d.ckpt"),
                                        *like)
    for name in _names(jp):
        np.testing.assert_array_equal(_leaf(jp, name), _leaf(params, name))
    for name in _names(jbn):
        np.testing.assert_array_equal(_leaf(jbn, name), _leaf(bn_state, name))
    full = tstep.init_train_state(*weights.numpy_vae_params(0), device="cpu")
    ttrain.save_final_weights(full, str(tmp_path / "fe.ckpt"), str(tmp_path / "fd.ckpt"))
    back, _ = weights.load_final_weights(str(tmp_path / "fe.ckpt"), str(tmp_path / "fd.ckpt"))
    np.testing.assert_array_equal(back["decoder"]["conv4"]["w"],
                                  weights.numpy_vae_params(0)[0]["decoder"]["conv4"]["w"])


# ------------------------------------------------------------------ data


def test_select_balanced_is_jaxs():
    rng = np.random.default_rng(11)
    edges = np.float32([0.25, 0.4, 0.6, 0.7])
    preds = np.concatenate([rng.random(900).astype(np.float32), np.repeat(edges, 5)])
    rng.shuffle(preds)
    for collect in (3, 150):
        got, want = tsampler.select_balanced(preds, collect), jsampler.select_balanced(preds, collect)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_balanced_sampler_is_jaxs(critics):
    frames = [(f"t{i}", generate_frames(40, seed=30 + i)[0].astype(np.float32) / 255.0)
              for i in range(3)]
    want_scores = jsampler.score_frames(critics[1], frames[0][1], batch_size=16)
    got_scores = tsampler.score_frames(critics[0], frames[0][1], batch_size=16)
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6)
    for total in (10, 10_000):
        want = jsampler.balanced_critic_sampler(iter(frames), critics[1], total_images=total,
                                                collect=6, batch_size=16)
        got = tsampler.balanced_critic_sampler(iter(frames), critics[0], total_images=total,
                                               collect=6, batch_size=16, device="cpu")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_sources_follow_jax(tmp_path):
    for spec in ("synthetic:2:5", "synthetic"):
        got, want = list(tsources.open_source(spec)), list(jsources.open_source(spec))
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_array_equal(got[0][1], want[0][1])
    (tmp_path / "ep").mkdir()
    frames = generate_frames(3, seed=2)[0]
    np.save(tmp_path / "loose.npy", frames)
    np.save(tmp_path / "ep" / "X.npy", frames[:2])
    np.save(tmp_path / "ep" / "Y.npy", np.zeros((2, 64, 64, 3), np.uint8))  # masks, skipped
    np.save(tmp_path / "bad.npy", np.zeros((4, 64, 64), np.uint8))  # refused shape
    got, want = list(tsources.open_source(str(tmp_path))), list(jsources.open_source(str(tmp_path)))
    assert [n for n, _ in got] == [n for n, _ in want] == ["loose.npy", os.path.join("ep", "X.npy")]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["empty", "bad_shapes", "minerl"])
def test_source_errors_are_jaxs(tmp_path, case):
    if case == "bad_shapes":
        np.save(tmp_path / "bad.npy", np.zeros((4, 64, 64), np.uint8))
    spec = "minerl:" + str(tmp_path) if case == "minerl" else str(tmp_path)
    errors = []
    for mod in (jsources, tsources):
        with pytest.raises(Exception) as info:
            list(mod.open_source(spec))
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]) == str(errors[1])


# ------------------------------------------------------------------ the commands


def test_train_command_trains_resumes_and_feeds_eval(tmp_path, capsys):
    root = tmp_path / "root"
    root.mkdir()
    args = ["train", "--source", "synthetic:1:40", "--epochs", "1", "--batch-size", "8",
            "--device", "cpu", "--root", str(root), "--log-dir", str(root / "logs"),
            "--log-images"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "collected" in out and "saved" in out
    assert tckpt.latest_checkpoint(str(root / "checkpoints")) is not None
    assert main(args) == 0  # the same run again resumes and takes no step
    assert "resumed from" in capsys.readouterr().out
    enc, dec = root / "saved-networks" / "vae_encoder.ckpt", root / "saved-networks" / "vae_decoder.ckpt"
    params, _ = weights.load_final_weights(str(enc), str(dec))
    assert params["decoder"]["conv4"]["w"].shape == (5, 5, 32, 3)
    # --mask-distill builds the pseudo-label masks; the resume meta does not
    # hold the weight (nor does the JAX package's), so the same run resumes
    assert main(args + ["--mask-distill", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "building pseudo-label masks" in out and "resumed from" in out


def test_entry_points_default_to_the_card(critics, dataset):
    """Without ``device`` the training entry points run on CUDA (here: its
    error when there is no card), never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    frames = [("t", dataset.astype(np.float32) / 255.0)]
    calls = (lambda: ttrain.train(critics[0], dataset, batch_size=4, progress=False),
             lambda: tsampler.balanced_critic_sampler(iter(frames), critics[0]),
             lambda: main(["train", "--source", "synthetic:1:8"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


def test_event_writers_never_share_a_file(tmp_path):
    """Two writers opened within one second write two files (the JAX
    package's microsecond + pid suffix)."""
    a, b = tevents.EventWriter(str(tmp_path)), tevents.EventWriter(str(tmp_path))
    a.close()
    b.close()
    assert a.path != b.path and len(os.listdir(tmp_path)) == 2
