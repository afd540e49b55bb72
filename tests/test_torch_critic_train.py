"""The port's critic training (critic_vae_tpu_torch: models/critic.py's
dropout, train/critic.py, io/weights.py's critic helpers and the
``traincritic`` command) against the JAX package on the same numpy inputs,
at full width (critic (8, 8, 8, 16), bottleneck 32, 64x64 frames).

The JAX package draws the critic's initial weights and its dropout masks
from threefry; both sides start here from ``numpy_critic_params`` and the
port is given JAX's masks, replayed from the state's key with public
``jax.random`` calls (split the state's key, split the step's key in 3,
bernoulli at each layer's NHWC shape). Tolerances, float32:

* the train-mode forward with JAX's masks: logits within 1e-5 (absolute
  and relative: one conv chain's reassociation);
* per-step losses within 1e-5 relative;
* after 3 steps, every parameter leaf within 0.25·lr (Adam's first steps
  turn float noise in near-zero gradients into moves of up to lr, so the
  bound is in units of lr; a real fault moves whole leaves by lr or more);
* ``critic_cam_health``: every field within 1e-3 (LayerCAM's maps go
  through the uint8 threshold, where a map within float noise of a level
  may land on the other side of it);
* labels, the epoch shuffle and the saved files: bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from critic_vae_tpu.models import critic as jcritic
from critic_vae_tpu.train import critic as jtc
from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.train import critic as ttc

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
GOLDEN = "tests/golden/torch_critic_golden.npz"
LR = 1e-3
DROPOUT = 0.3
LOSS_REL = 1e-5
PARAM_TOL = 0.25 * LR
HEALTH_TOL = 1e-3
SHAPES = ((8, 8, 8), (4, 4, 16), (32,))  # NHWC of block 2's pool, block 3's pool, fc0


def _masks_of_key(drop_key, batch):
    """JAX's three keep masks of one dropout key, as the port takes them (NCHW)."""
    out = []
    for k, shape in zip(jax.random.split(drop_key, 3), SHAPES):
        m = np.asarray(jax.random.bernoulli(k, 1.0 - DROPOUT, (batch,) + shape))
        out.append(torch.from_numpy(m.transpose(0, 3, 1, 2).copy() if m.ndim == 4 else m.copy()))
    return out


def _step_masks(key, steps, batch):
    """Each step's masks, replayed from the state's key as the step splits it."""
    out = []
    for _ in range(steps):
        key, drop_key = jax.random.split(key)
        out.append(_masks_of_key(drop_key, batch))
    return out


def _nchw(frames):
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def data():
    frames, gt = generate_frames(32, seed=4)
    return frames, gt, jtc.soft_trunk_labels(gt)


@pytest.mark.parametrize("logits", [True, False])
def test_dropout_with_jax_masks_matches_critic_apply(logits):
    params = weights.numpy_critic_params(2)
    x = np.random.default_rng(1).random((6, 64, 64, 3), dtype=np.float32)
    key = jax.random.key(3)
    want = jcritic.critic_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), train=True,
                                dropout_rate=DROPOUT, rng=key, return_logits=logits)
    critic = weights.critic_from_params(params)
    got = critic(_nchw(x), return_logits=logits, dropout_rate=DROPOUT,
                 dropout_masks=_masks_of_key(key, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # no dropout without a rate; a rate without masks or generator raises
    np.testing.assert_array_equal(critic(_nchw(x)).numpy(),
                                  critic(_nchw(x), dropout_rate=0.0).numpy())
    with pytest.raises(ValueError, match="generator or dropout_masks"):
        critic(_nchw(x), dropout_rate=DROPOUT)


def test_generator_dropout_keeps_its_share():
    critic = weights.critic_from_params(weights.numpy_critic_params(0))
    x = torch.rand(64, 3, 64, 64)
    g = torch.Generator().manual_seed(0)
    a = critic(x, return_logits=True, dropout_rate=DROPOUT, generator=g)
    b = critic(x, return_logits=True, dropout_rate=DROPOUT, generator=g)
    assert not torch.equal(a, b)  # the generator advances
    h = torch.ones(4096, 8, 8, 8)
    kept = (torch.rand(h.shape, generator=torch.Generator().manual_seed(1)) < 0.7).float().mean()
    assert abs(float(kept) - 0.7) < 0.01


def _jax_steps(params, frames, labels, idx, key):
    tx = optax.adam(LR)
    multi = jtc.make_critic_multi_step(tx, dropout_rate=DROPOUT, donate=False)
    p = jax.tree.map(jnp.asarray, params)
    (new, _, _), losses = multi((p, tx.init(p), key), jnp.asarray(frames), jnp.asarray(labels),
                                jnp.asarray(idx))
    return {k: np.asarray(v) for k, v in new.items()}, np.asarray(losses)


@pytest.mark.parametrize("runner", ["step", "multi_step"])
def test_critic_steps_match_jax(data, runner):
    frames, _, labels = data
    params = weights.numpy_critic_params(0)
    idx = np.random.default_rng(0).permutation(32)[:24].reshape(3, 8).astype(np.int32)
    key = jax.random.key(5)
    want_params, want_losses = _jax_steps(params, frames, labels, idx, key)
    masks = _step_masks(key, 3, 8)
    state = ttc.init_critic_state(params, device="cpu")
    if runner == "step":
        step = ttc.make_critic_step(learning_rate=LR, dropout_rate=DROPOUT)
        got = [step(state, torch.from_numpy(frames[i]), torch.from_numpy(labels[i]), m).item()
               for i, m in zip(idx, masks)]
    else:
        multi = ttc.make_critic_multi_step(learning_rate=LR, dropout_rate=DROPOUT)
        got = multi(state, torch.from_numpy(frames), torch.from_numpy(labels),
                    torch.from_numpy(idx), masks).numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64), want_losses.astype(np.float64),
                               rtol=LOSS_REL, atol=0)
    got_params = weights.critic_to_params(state.critic)
    for name, want in want_params.items():
        assert np.abs(got_params[name] - want).max() <= PARAM_TOL, name


def test_critic_golden_steps():
    """3 steps against tests/golden/torch_critic_golden.npz (the JAX
    package's steps, with its masks), at full batch 128."""
    gold = np.load(GOLDEN)
    n, steps = int(gold["num_frames"]), int(gold["steps"])
    frames = generate_frames(n, seed=int(gold["frames_seed"]))[0]
    np.testing.assert_array_equal(ttc.soft_trunk_labels(generate_frames(
        n, seed=int(gold["frames_seed"]))[1]), gold["labels"])
    state = ttc.init_critic_state(weights.numpy_critic_params(0), device="cpu")
    step = ttc.make_critic_step(learning_rate=float(gold["lr"]),
                                dropout_rate=float(gold["dropout"]))
    batch, labels = torch.from_numpy(frames), torch.from_numpy(gold["labels"])
    losses = []
    for t in range(steps):
        masks = []
        for j, shape in enumerate(SHAPES):
            m = np.unpackbits(gold[f"mask{t}_{j}"], axis=-1, count=shape[-1]).astype(bool)
            masks.append(torch.from_numpy(m.transpose(0, 3, 1, 2).copy() if m.ndim == 4 else m))
        losses.append(step(state, batch, labels, masks).item())
    np.testing.assert_allclose(losses, gold["losses"], rtol=LOSS_REL, atol=0)
    got = weights.critic_to_params(state.critic)
    for name in got:
        assert np.abs(got[name] - gold[f"params/{name}"]).max() <= 0.25 * float(gold["lr"]), name


def test_epoch_shuffle_is_jaxs(data, monkeypatch):
    """train_critic's batches, epoch by epoch, are the JAX package's."""
    frames, _, labels = data
    seen = {"jax": [], "port": []}

    def jax_recorder(lr, rate):
        tx = optax.adam(lr)

        def multi(carry, dataset, lab, idx):
            seen["jax"].append(np.asarray(idx))
            return carry, jnp.zeros((idx.shape[0],))

        return tx, multi

    def port_recorder(**options):
        def multi(state, dataset, lab, idx, dropout_masks=None):
            seen["port"].append(idx.numpy())
            return torch.zeros(idx.shape[0])

        return multi

    monkeypatch.setattr(jtc, "_cached_multi_step", jax_recorder)
    monkeypatch.setattr(ttc, "make_critic_multi_step", port_recorder)
    jtc.train_critic(frames, labels, epochs=3, batch_size=10, seed=7, progress=False)
    ttc.train_critic(frames, labels, epochs=3, batch_size=10, seed=7, progress=False,
                     device="cpu")
    assert len(seen["port"]) == 3
    for a, b in zip(seen["jax"], seen["port"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["synthetic", "none_positive", "min_pixels"])
def test_labels_are_jaxs(case):
    gt = generate_frames(40, seed=6)[1]
    if case == "none_positive":
        gt = np.zeros_like(gt)
    kw = {"min_pixels": 50} if case == "min_pixels" else {}
    for a, b in ((ttc.labels_from_masks(gt, **kw), jtc.labels_from_masks(gt, **kw)),
                 (ttc.soft_trunk_labels(gt), jtc.soft_trunk_labels(gt))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cam_health_matches_jax_and_the_golden():
    """critic_cam_health of the synthetic critic over JAX's own 128 frames."""
    frames = generate_frames(128, seed=9999)[0]
    want = jtc.critic_cam_health(jcritic.load_critic(CRITIC_NPZ), frames)
    got = ttc.critic_cam_health(weights.critic_from_params(weights.load_critic(CRITIC_NPZ)),
                                frames, device="cpu")
    gold = np.load(GOLDEN)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= HEALTH_TOL, (k, got[k], want[k])
        assert abs(got[k] - float(gold[f"health/{k}"])) <= HEALTH_TOL, k
    assert got["deletion_drop"] >= ttc.CAM_HEALTH_MIN_DELETION_DROP


def test_cam_health_no_positive_frames():
    """A critic that scores every frame negative gives the defined
    degenerate values, as the JAX package's."""
    params = weights.numpy_critic_params(0)
    params["fc1_b"] = np.float32([-50.0])
    frames = generate_frames(8, seed=0)[0]
    got = ttc.critic_cam_health(params, frames, device="cpu")
    want = jtc.critic_cam_health(jax.tree.map(jnp.asarray, params), frames)
    assert got == want


@pytest.mark.parametrize("target,trained,selected,met", [
    (0.65, [0, 1], 1, True), (0.95, [0, 1, 2, 3], 2, False), (None, [0, 1, 2, 3], 2, None)])
def test_train_critic_selected_modes(monkeypatch, target, trained, selected, met):
    """The argmax mode and the health-target mode, both packages scripted by
    the same per-seed health (tests/test_critic_training.py's fakes)."""
    drops = {0: 0.30, 1: 0.70, 2: 0.90, 3: 0.10}
    runs = {"jax": [], "port": []}

    def fakes(tag):
        def fake_train(frames, labels, *, seed, progress, **kw):
            runs[tag].append(seed)
            return {"seed_marker": seed}, 0.01

        def fake_health(params, hf, **kw):
            return {"deletion_drop": drops[params["seed_marker"]], "empty_rate": 0.0,
                    "positive_fraction": 0.5, "cam_top5_mass": 0.3, "n_frames": 8}

        return fake_train, fake_health

    for mod, tag in ((jtc, "jax"), (ttc, "port")):
        train, health = fakes(tag)
        monkeypatch.setattr(mod, "train_critic", train)
        monkeypatch.setattr(mod, "critic_cam_health", health)
    frames, labels = np.zeros((8, 64, 64, 3), np.uint8), np.zeros(8, np.float32)
    want = jtc.train_critic_selected(frames, labels, candidates=4, health_target=target,
                                     progress=False)
    got = ttc.train_critic_selected(frames, labels, candidates=4, health_target=target,
                                    progress=False, device="cpu")
    assert got == want
    assert runs["port"] == runs["jax"] == trained
    assert got[1]["selected_seed"] == selected
    assert got[1].get("health_target_met") is met


def test_saved_critic_files_cross(tmp_path):
    """save_critic's .npz reads in the JAX package's load_critic, and the
    JAX package's in the port's, bitwise."""
    params = weights.numpy_critic_params(9)
    weights.save_critic(str(tmp_path / "port.npz"), params)
    got = jcritic.load_critic(str(tmp_path / "port.npz"))
    jcritic.save_critic(str(tmp_path / "jax.npz"), jax.tree.map(jnp.asarray, params))
    back = weights.load_critic(str(tmp_path / "jax.npz"))
    for k, v in params.items():
        assert np.array_equal(np.asarray(got[k]), v) and np.asarray(got[k]).dtype == v.dtype
        assert np.array_equal(back[k], v) and back[k].dtype == v.dtype


def test_numpy_critic_params_have_jaxs_structure():
    want = jcritic.init_critic_params(jax.random.key(0))
    got = weights.numpy_critic_params(0)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype
        w = want[k[:-1] + "w"]  # a bias's fan-in is its weight's
        bound = 1.0 / np.sqrt(np.prod(w.shape[:-1]))
        assert np.abs(got[k]).max() <= bound and np.abs(np.asarray(v)).max() <= bound, k


def test_traincritic_command_synthetic(tmp_path, capsys):
    out = tmp_path / "c.npz"
    args = ["traincritic", "--synthetic-frames", "48", "--epochs", "1", "--batch-size", "16",
            "--device", "cpu", "--root", str(tmp_path), "--out", str(out)]
    assert main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("training critic on 48 frames (")
    assert "soft labels" in lines[0]
    assert any(ln.startswith("final loss=") and ln.endswith(f"saved {out}") for ln in lines)
    assert any(ln.startswith("cam health (no-GT") for ln in lines)
    params = weights.load_critic(str(out))
    assert set(params) == set(weights.numpy_critic_params(0))
    # the default out path, binary labels, selection of 2, no health report
    assert main(["traincritic", "--synthetic-frames", "32", "--epochs", "1", "--batch-size",
                 "16", "--device", "cpu", "--root", str(tmp_path), "--labels", "binary",
                 "--cam-select", "2", "--cam-health-target", "0.99"]) == 0
    out_text = capsys.readouterr().out
    assert "best-of-2 by CAM health" in out_text and "WARNING: no candidate reached" in out_text
    assert (tmp_path / "saved-networks" / "critic.npz").is_file()


def test_traincritic_command_episodes(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["traincritic", "--episodes", str(empty), "--device", "cpu"]) == 1
    assert capsys.readouterr().err == f"error: no episodes (X.npy/Y.npy) under {empty}\n"
    eps = tmp_path / "eps"
    generate_episode(str(eps / "a"), num_frames=24, seed=1)
    generate_episode(str(eps / "b"), num_frames=24, seed=2)
    os.remove(eps / "a" / "Y.npy")
    os.remove(eps / "b" / "Y.npy")
    assert main(["traincritic", "--episodes", str(eps), "--device", "cpu"]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == [f"skipping {eps / 'a'}: no Y.npy ground truth",
                   f"skipping {eps / 'b'}: no Y.npy ground truth",
                   "error: no episode with Y.npy ground truth found — "
                   "traincritic needs labeled frames"]
    generate_episode(str(eps / "c"), num_frames=24, seed=3)
    assert main(["traincritic", "--episodes", str(eps), "--device", "cpu", "--epochs", "1",
                 "--batch-size", "8", "--no-cam-health", "--root", str(tmp_path)]) == 0
    captured = capsys.readouterr()
    assert "training critic on 24 frames" in captured.out
    assert "cam health" not in captured.out
