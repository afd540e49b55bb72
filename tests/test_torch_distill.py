"""The port's mask self-distillation (critic_vae_tpu_torch:
pipelines/distill.py, train/step.py's ``mask_distill`` term and its
multi-step mask gather, pipelines/train.py's ``mask_distill`` and
``pseudo_masks``, and ``train --mask-distill``) against the JAX package on
the same numpy inputs, with the synthetic critic at full width.

Tolerances:

* ``build_pseudo_masks``: thresholded LayerCAM masks >= 99.8% identical
  (the uint8 level of a map within float noise of the threshold can differ,
  as the saliency tests' bar); CRF masks, the host lattice and the device
  CRF's float32 ``xla`` build against JAX's ``device`` backend on the CPU,
  >= 99.9%;
* the warnings: JAX's text, character for character;
* the train step with the term (VAE dims (4, 8, 8, 16), JAX's draws
  given): total, recon and md losses within 1e-5 relative, kld within 1e-4
  (the KL follows the encoder's float noise, test_torch_train.py), each
  parameter leaf's change within 0.25·lr, the encoder's conv biases
  (zero gradient in exact arithmetic; Adam moves them on float noise)
  within 2·lr a step. At full width the golden's steps
  (tests/golden/torch_distill_golden.npz) take the frames the critic scores
  at least 0.05: near a value of 0 the term's gradient moves by up to 10%
  with float32 noise in mu (the golden maker says why), and there the
  port's gradient is held to JAX's at the same mu instead.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.pipelines import distill as jdistill
from critic_vae_tpu.pipelines import train as jtrain
from critic_vae_tpu.train import step as jstep
from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.crf.device import MEM_ENV
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines import distill as tdistill
from critic_vae_tpu_torch.pipelines import train as ttrain
from critic_vae_tpu_torch.train import step as tstep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
GOLDEN = "tests/golden/torch_distill_golden.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
LR = 5e-5
LOSS_REL = {"total_loss": 1e-5, "recon_loss": 1e-5, "md_loss": 1e-5, "kld": 1e-4}
PARAM_TOL = 0.25 * LR
ENC_CONV_BIASES = {f"encoder/conv{i}/b" for i in range(4)}
THR_BAR = 0.998
CRF_BAR = 0.999
MD = 0.5
CRF_MEM = str(1 << 30)  # the CRF's workspace cap in both packages: at most 16 frames a chunk


@pytest.fixture(scope="module")
def critics():
    return (weights.critic_from_params(weights.load_critic(CRITIC_NPZ)),
            jax_load_critic(CRITIC_NPZ))


@pytest.fixture(scope="module")
def frames():
    return generate_frames(8, seed=31)[0]


# one LayerCAM chunk of the frames, unpadded, in both packages
CHUNK = {"batch_size": 8}


def _agreement(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == bool
    return float(np.mean(a == b))


def test_thresholded_masks_match_jax(critics, frames):
    got = tdistill.build_pseudo_masks(critics[0], frames, run_crf=False, device="cpu", **CHUNK)
    want = jdistill.build_pseudo_masks(critics[1], frames, run_crf=False, **CHUNK)
    assert _agreement(got, want) >= THR_BAR
    assert want.any()
    # float frames in [0, 1] take the JAX package's uint8 conversion
    got_f = tdistill.build_pseudo_masks(critics[0], frames.astype(np.float32) / 255.0,
                                        run_crf=False, device="cpu", **CHUNK)
    np.testing.assert_array_equal(got_f, got)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_crf_masks_match_jax(critics, frames, backend, monkeypatch):
    """The host lattice against JAX's host lattice; the device CRF (on the
    CPU its float32 ``xla`` build) against JAX's ``device`` backend."""
    monkeypatch.setenv(MEM_ENV, CRF_MEM)
    got = tdistill.build_pseudo_masks(critics[0], frames, crf_backend=backend, device="cpu",
                                      **CHUNK)
    want = jdistill.build_pseudo_masks(critics[1], frames, crf_backend=backend, **CHUNK)
    assert _agreement(got, want) >= CRF_BAR
    assert want.any()


def test_distill_golden_masks(critics):
    """The thresholded masks of the golden's 32 frames
    (tests/golden/torch_distill_golden.npz, the JAX package's); its CRF
    masks are the card's bar (chip_smoke.py phase 26)."""
    gold = np.load(GOLDEN)
    n = int(gold["num_frames"])
    f = generate_frames(n, seed=int(gold["frames_seed"]))[0]
    thr = tdistill.build_pseudo_masks(critics[0], f, run_crf=False, device="cpu", batch_size=n)
    want = np.unpackbits(gold["thr_bits"], axis=-1, count=64).astype(bool)
    assert _agreement(thr, want) >= THR_BAR
    assert tuple(gold["crf_params"]) == tdistill.CAM_TUNED_CRF_PARAMS


def _warning_texts(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught if "build_pseudo_masks" in str(w.message)]


@pytest.mark.parametrize("case", ["empty_masks", "saturated_critic"])
def test_warnings_are_jaxs(critics, frames, case):
    """threshold 255 leaves every mask empty (both reasons: the empty rate,
    and nothing erased, so no deletion drop); a critic saturated positive
    loses nothing when its CAM support is erased (the deletion reason)."""
    kw = {"threshold": 255} if case == "empty_masks" else {}
    if case == "saturated_critic":
        params = weights.load_critic(CRITIC_NPZ)
        params["fc1_b"] = params["fc1_b"] + np.float32(60.0)
        port, jax_critic = weights.critic_from_params(params), jax.tree.map(jnp.asarray, params)
    else:
        port, jax_critic = critics
    kw.update(CHUNK)
    with pytest.warns(UserWarning, match="critic's LayerCAM localization looks DEGENERATE"):
        tdistill.build_pseudo_masks(port, frames, run_crf=False, device="cpu", **kw)
    got = _warning_texts(lambda: tdistill.build_pseudo_masks(port, frames, run_crf=False,
                                                             device="cpu", **kw))
    want = _warning_texts(lambda: jdistill.build_pseudo_masks(jax_critic, frames,
                                                              run_crf=False, **kw))
    assert got == want and len(got) == 1
    assert "CAM deletion_drop" in got[0]
    if case == "empty_masks":
        assert "100% of critic-positive frames have EMPTY pseudo-masks" in got[0]


def _tx():
    return optax.apply_if_finite(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
                                 max_consecutive_errors=100)


def _jax_state(params, bn_state, key):
    p = jax.tree.map(jnp.asarray, params)
    return jstep.TrainState(p, jax.tree.map(jnp.asarray, bn_state), _tx().init(p), key,
                            jnp.zeros((), jnp.int32))


def _jax_eps(key, steps, batch):
    out = []
    for _ in range(steps):
        key, sample_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sample_key, (batch, 32), jnp.float32)))
    return np.stack(out)


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def _assert_params_close(state, jparams, steps):
    got, _ = weights.vae_to_params(state.vae)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        name = "/".join(k.key for k in path)
        bound = 2 * steps * LR if name in ENC_CONV_BIASES else PARAM_TOL
        assert np.abs(_leaf(got, name) - np.asarray(leaf)).max() <= bound, name


def _assert_losses_close(got, want):
    assert set(got) == set(want) == set(LOSS_REL)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=LOSS_REL[k], atol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def narrow():
    return weights.numpy_vae_params(3, **NARROW)


@pytest.fixture(scope="module")
def dataset():
    f, gt = generate_frames(12, seed=1)
    return f, gt


def test_mask_distill_steps_match_jax(critics, narrow, dataset):
    batch, masks = dataset[0][:4], dataset[1][:4]
    key = jax.random.key(9)
    jfn = jstep.make_train_step(critics[1], _tx(), compute_dtype=jnp.float32, donate=False,
                                mask_distill=MD)
    jstate = _jax_state(*narrow, key)
    want = []
    for _ in range(3):
        jstate, m = jfn(jstate, jnp.asarray(batch), jnp.asarray(masks))
        want.append(m)
    state = tstep.init_train_state(*narrow, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=LR, mask_distill=MD)
    eps = _jax_eps(key, 3, 4)
    got = [step(state, torch.from_numpy(batch), torch.from_numpy(e), torch.from_numpy(masks))
           for e in eps]
    _assert_losses_close({k: [g[k].item() for g in got] for k in got[0]},
                         {k: [float(w[k]) for w in want] for k in want[0]})
    _assert_params_close(state, jstate.params, 3)
    with pytest.raises(ValueError, match="requires the batch's pseudo-label masks"):
        step(state, torch.from_numpy(batch))


def test_multi_step_gathers_mask_rows_as_jax(critics, narrow, dataset):
    frames, gt = dataset
    idx = np.random.default_rng(0).permutation(12).reshape(3, 4).astype(np.int32)
    key = jax.random.key(7)
    multi = jstep.make_multi_step(critics[1], _tx(), compute_dtype=jnp.float32, donate=False,
                                  mask_distill=MD)
    jstate, want = multi(_jax_state(*narrow, key), jnp.asarray(frames), jnp.asarray(idx),
                         jnp.asarray(gt.astype(np.uint8)))
    state = tstep.init_train_state(*narrow, device="cpu")
    tmulti = tstep.make_multi_step(critics[0], learning_rate=LR, mask_distill=MD)
    got = tmulti(state, torch.from_numpy(frames), torch.from_numpy(idx),
                 torch.from_numpy(_jax_eps(key, 3, 4)), torch.from_numpy(gt.astype(np.uint8)))
    _assert_losses_close({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})
    _assert_params_close(state, jstate.params, 3)


def _jax_dice(rv, r0, masks):
    """The JAX step's mask_distill term on NHWC decodes
    (critic_vae_tpu/train/step.py), as a function of the two decodes."""
    d = jnp.abs(r0 - rv)
    grey = d[..., 0] * 0.2989 + d[..., 1] * 0.5870 + d[..., 2] * 0.1140
    dn = grey / (jnp.max(grey, axis=(1, 2), keepdims=True) + 1e-6)
    m = jnp.asarray(masks, jnp.float32)
    inter = jnp.sum(dn * m, axis=(1, 2))
    return jnp.mean(1.0 - (2.0 * inter + 1e-6) / (
        jnp.sum(dn, axis=(1, 2)) + jnp.sum(m, axis=(1, 2)) + 1e-6))


def test_dice_term_gradient_at_equal_decodes_is_jaxs():
    """Where the two decodes are equal in float32 (a critic value too small
    to move a pixel) JAX's |x| passes the gradient with slope 1 and
    torch.abs with 0: the term's gradients are JAX's there too."""
    rng = np.random.default_rng(0)
    rv = np.tanh(rng.standard_normal((3, 16, 16, 3))).astype(np.float32)
    r0 = rv + np.float32(0.05) * rng.standard_normal(rv.shape).astype(np.float32)
    r0[:, :8] = rv[:, :8]  # half of every frame: equal decodes
    masks = rng.random((3, 16, 16)) < 0.3
    want = jax.grad(_jax_dice, argnums=(0, 1))(jnp.asarray(rv), jnp.asarray(r0), masks)
    trv, tr0 = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
                for a in (rv, r0))
    loss = tstep._dice_term(trv, tr0, torch.from_numpy(masks))
    np.testing.assert_allclose(loss.item(), float(_jax_dice(rv, r0, masks)), rtol=1e-6)
    for g, w in zip(torch.autograd.grad(loss, (trv, tr0)), want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_distill_golden_steps_at_full_width(critics):
    """The full-width steps chip_smoke.py holds the card against, on the CPU:
    3 steps with mask_distill=0.5 from numpy_vae_params(0) on the golden's
    step rows and their CRF masks, with its draws."""
    gold = np.load(GOLDEN)
    rows = gold["step_rows"]
    frames = generate_frames(int(gold["num_frames"]), seed=int(gold["frames_seed"]))[0][rows]
    masks = np.unpackbits(gold["crf_bits"], axis=-1, count=64).astype(bool)[rows]
    params, bn_state = weights.numpy_vae_params(int(gold["seed"]))
    state = tstep.init_train_state(params, bn_state, device="cpu")
    step = tstep.make_train_step(critics[0], learning_rate=float(gold["lr"]),
                                 mask_distill=float(gold["mask_distill"]))
    got = [step(state, torch.from_numpy(frames), torch.from_numpy(e), torch.from_numpy(masks))
           for e in gold["eps"]]
    _assert_losses_close({k: [g[k].item() for g in got] for k in got[0]},
                         {k: gold[k] for k in got[0]})
    got_p, _ = weights.vae_to_params(state.vae)
    steps = int(gold["steps"])
    for key in gold.files:
        if key.startswith("delta/"):
            name = key[len("delta/"):]
            delta = (_leaf(got_p, name) - _leaf(params, name)).ravel()[gold[f"index/{name}"]]
            bound = 2 * steps * LR if name in ENC_CONV_BIASES else PARAM_TOL
            assert np.abs(delta - gold[key]).max() <= bound, name


def test_md_gradient_at_the_same_mu_is_jaxs(critics):
    """On frames the critic scores near 0 the term's gradient moves by up to
    10% with float32 noise in mu (tests/golden/make_torch_slice_golden.py);
    given the same mu, the port's decoder gradient is JAX's on every frame:
    each leaf within 1e-4 of the decoder's largest gradient entry."""
    gold = np.load(GOLDEN)
    frames = generate_frames(16, seed=int(gold["frames_seed"]))[0]
    masks = np.unpackbits(gold["crf_bits"], axis=-1, count=64).astype(bool)[:16]
    params, bn_state = weights.numpy_vae_params(0)
    vae = weights.vae_from_params(params, bn_state).requires_grad_(True)
    x = torch.from_numpy(frames).float().div(255.0).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        preds = critics[0](x)[:, 0]
        mu = vae.encode(x, train=True)[0]
    assert (preds < 0.01).sum() >= 4  # low-value frames are in the batch
    loss = tstep._dice_term(vae.decode(mu, preds), vae.decode(mu, torch.zeros_like(preds)),
                            torch.from_numpy(masks))
    grads = torch.autograd.grad(loss, list(vae.decoder.parameters()))
    holder = weights.vae_from_params(params, bn_state)
    for p, g in zip(holder.decoder.parameters(), grads):
        p.data.copy_(g)
    got = weights.vae_to_params(holder)[0]["decoder"]

    def jax_loss(p, m, v):
        from critic_vae_tpu.models import vae as jvae

        return _jax_dice(jvae.decode(p, m, v), jvae.decode(p, m, jnp.zeros_like(v)), masks)

    want = jax.jit(jax.grad(jax_loss))(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(mu.numpy()), jnp.asarray(preds.numpy()))
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jax.tree.leaves(want["decoder"]))
    for layer, leaves in got.items():
        for leaf, g in leaves.items():
            err = np.abs(g - np.asarray(want["decoder"][layer][leaf])).max() / scale
            assert err <= 1e-4, (layer, leaf, err)


@pytest.mark.parametrize("case", ["missing", "misaligned"])
def test_train_mask_distill_errors_are_jaxs(critics, dataset, case):
    frames = dataset[0]
    masks = None if case == "missing" else np.zeros((len(frames), 32, 32), bool)
    errors = []
    for fn, critic, extra in ((jtrain.train, critics[1], {}),
                              (ttrain.train, critics[0], {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            fn(critic, frames, mask_distill=MD, pseudo_masks=masks, batch_size=4,
               progress=False, **extra)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert ("requires pseudo_masks" if case == "missing" else "row-aligned") in errors[1]


def test_train_with_mask_distill_logs_md_loss(critics, narrow, dataset, tmp_path):
    frames, gt = dataset
    state = ttrain.train(critics[0], frames, epochs=1, batch_size=4, mask_distill=MD,
                         pseudo_masks=gt, initial_params=narrow, log_dir=str(tmp_path),
                         log_every_batches=1, progress=False, device="cpu")
    assert int(state.step) == 3
    import json

    rows = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert len(rows) == 3 and all("md_loss" in r and np.isfinite(r["md_loss"]) for r in rows)


def test_train_mask_distill_command(tmp_path, capsys):
    root = tmp_path / "root"
    root.mkdir()
    args = ["train", "--source", "synthetic:1:40", "--epochs", "1", "--batch-size", "8",
            "--device", "cpu", "--root", str(root), "--log-dir", str(root / "logs"),
            "--mask-distill", "0.3"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "building pseudo-label masks (LayerCAM + CAM-tuned CRF)..." in out
    assert "saved" in out
    weights.load_final_weights(str(root / "saved-networks" / "vae_encoder.ckpt"),
                               str(root / "saved-networks" / "vae_decoder.ckpt"))
