"""The port's saliency mask source through the pipeline and the CLI against
the JAX package's: ``episode_forward(mask_source="saliency")`` and its
errors, ``saliency_opts`` in the pipelines, the ``--quality`` chain
(LayerCAM, {id, mirror} x {0, +-2 px} TTA, threshold 64, the CAM-tuned CRF)
against JAX's ``eval_episode`` and against tests/golden/
torch_saliency_golden.npz, SmoothGrad end to end with the port's own
generator, ``_apply_quality_preset``, and ``video --quality`` /
``video --crf-search``."""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.cli import _apply_quality_preset as jax_apply_quality_preset
from critic_vae_tpu.cli import build_parser as jax_build_parser
from critic_vae_tpu.cli import main as jax_main
from critic_vae_tpu.ops.mask import episode_forward as jax_episode_forward
from critic_vae_tpu.pipelines.train import save_final_weights
from critic_vae_tpu.pipelines.video import eval_episode as jax_eval_episode
from critic_vae_tpu_torch.cli import _apply_quality_preset, build_parser, main
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops.mask import episode_forward, resolve_front_end
from critic_vae_tpu_torch.pipelines.video import episode_device_stage, eval_episode

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
GOLDEN = ROOT / "tests" / "golden" / "torch_saliency_golden.npz"
CPU = torch.device("cpu")
# the --quality preset (critic_vae_tpu/cli.py _QUALITY_PRESET)
QUALITY_OPTS = {"method": "layercam", "tta_flip": True, "tta_shift": 2}
QUALITY_CRF = (132.0, 32.0, 3.1, 8.0, 1.8, 10)
BATCH = 4  # frames of the CLI tests' episode and their chunk


@pytest.fixture(scope="module")
def models():
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = weights.numpy_vae_params(2, dims=(4, 8, 8, 16), bottleneck=256)
    return (critic_np, params, state, weights.critic_from_params(critic_np),
            weights.vae_from_params(params, state))


PRESET_CASES = {
    "plain": [],
    "explicit_flags_win": ["--saliency-tta-shift", "3", "--threshold", "80"],
    "search_keeps_searching": ["--crf-search"],
}


@pytest.mark.parametrize("case", sorted(PRESET_CASES))
def test_quality_preset_expansion(case):
    """The three cases of tests/test_cli.py's preset test, each against the
    JAX package's expansion of the same flags."""
    argv = ["video", "--quality", *PRESET_CASES[case]]
    args = build_parser().parse_args([*argv, "--episode", "ep"])
    want = jax_build_parser().parse_args(argv)
    _apply_quality_preset(args)
    jax_apply_quality_preset(want)
    for dest in ("mask_source", "saliency_method", "saliency_tta_flip", "saliency_tta_shift",
                 "crf_params", "threshold"):
        assert getattr(args, dest) == getattr(want, dest), dest
    if case == "plain":
        assert (args.mask_source, args.saliency_method, args.threshold) == \
            ("saliency", "layercam", 64)
        assert args.saliency_tta_flip and args.saliency_tta_shift == 2
        assert args.crf_params == "132,32,3.1,8,1.8,10"
    elif case == "explicit_flags_win":
        assert args.saliency_tta_shift == 3 and args.threshold == 80
        assert args.mask_source == "saliency"
    else:
        assert args.crf_params is None


FORWARD_CASES = {
    "gradient_logits_sigma1": {"saliency_logits": True, "saliency_sigma": 1.0},
    "quality": {"saliency_method": "layercam", "saliency_tta_flip": True,
                "saliency_tta_shift": 2},
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_episode_forward_saliency_matches_jax(models, case):
    """The saliency maps as ``diff``, their maxima, probabilities as
    ``preds``, and the reconstructions at those preds (float32)."""
    critic_np, params, state, critic, vae = models
    frames, _ = generate_frames(3, seed=4)
    kw = FORWARD_CASES[case]
    want = jax_episode_forward(params, state, critic_np, jnp.asarray(frames),
                               mask_source="saliency", **kw)
    got = episode_forward(vae, critic, torch.from_numpy(frames), mask_source="saliency",
                          with_recons=True, **kw)
    scale = float(np.abs(np.asarray(want["diff"])).max())
    assert np.abs(got["preds"].numpy() - np.asarray(want["preds"])).max() <= 1e-6
    assert np.abs(got["diff"].numpy() - np.asarray(want["diff"])).max() <= 1e-5 * scale
    assert np.abs(got["max_value"].numpy() - np.asarray(want["max_value"])).max() <= 1e-5 * scale
    for key in ("recon_one", "recon_zero"):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() <= 1e-5


ERROR_CASES = {
    "source": {"mask_source": "grad"},
    "merged": {"mask_source": "saliency", "front_end": "merged"},
    "block0_f32": {"mask_source": "saliency", "block0_f32": True},
    "seed": {"mask_source": "saliency", "saliency_noise": 0.1},
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_episode_forward_errors_are_jax_s(models, case):
    critic_np, params, state, critic, vae = models
    frames, _ = generate_frames(2, seed=4)
    with pytest.raises(ValueError) as want:
        jax_episode_forward(params, state, critic_np, jnp.asarray(frames),
                            **ERROR_CASES[case])
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        episode_forward(vae, critic, torch.from_numpy(frames), **ERROR_CASES[case])


def test_front_end_auto_is_split_for_saliency():
    assert resolve_front_end("auto", mask_source="saliency") == "split"
    assert resolve_front_end("auto") == "merged"


def test_saliency_opts_keys_and_chunk_seeds(models):
    """JAX's keys (another raises, with its message), and SmoothGrad chunk k
    seeded ``seed + k``; inference-mode frames reach autograd."""
    _, _, _, critic, vae = models
    frames, _ = generate_frames(6, seed=8)
    dev = torch.from_numpy(frames)
    with pytest.raises(ValueError, match=re.escape("unknown saliency_opts keys: ['nois']")):
        episode_device_stage(vae, critic, dev, 4, mask_source="saliency",
                             saliency_opts={"nois": 0.1})
    opts = {"noise": 0.1, "samples": 2, "seed": 7, "logits": True}
    with torch.inference_mode():
        preds, maxes, chunks, valids, _ = episode_device_stage(
            vae, critic, dev.clone(), 4, mask_source="saliency", saliency_opts=opts)
    assert valids == [4, 2]
    for k, chunk in enumerate((dev[:4], torch.cat([dev[4:], dev[5:].expand(2, -1, -1, -1)]))):
        want = episode_forward(vae, critic, chunk, mask_source="saliency", saliency_noise=0.1,
                               saliency_samples=2, saliency_seed=7 + k, saliency_logits=True)
        assert torch.equal(chunks[k], want["diff"])
    other = episode_device_stage(vae, critic, dev, 4, mask_source="saliency",
                                 saliency_opts={**opts, "seed": 8})[2]
    assert not torch.equal(other[0], chunks[0])


def _agreement(got, want_preds, want_u8, want_thr):
    return (float(np.abs(got.preds - want_preds).max()),
            float(np.mean(np.abs(got.diff_u8.astype(int) - want_u8.astype(int)) <= 1)),
            float(np.mean(got.thr_masks == want_thr)))


def test_quality_chain_matches_jax_eval_episode(models):
    """``--quality``'s chain through ``eval_episode`` on both packages, the
    CRF on the host (``auto`` on the CPU; bit-identical given the masks)."""
    critic_np, params, state, critic, vae = models
    frames, gt = generate_frames(8, seed=12)
    kw = dict(threshold=64, crf_params=QUALITY_CRF, batch_size=BATCH,
              mask_source="saliency", saliency_opts=QUALITY_OPTS)
    want = jax_eval_episode(params, state, critic_np, frames, gt, with_recons=False, **kw)
    got = eval_episode(vae, critic, frames, gt, device=CPU, **kw)
    pred_err, within1, thr = _agreement(got, want.preds, want.diff_u8, want.thr_masks)
    assert pred_err <= 1e-6 and within1 >= 0.999 and thr >= 0.998
    assert abs(got.thr_iou - want.thr_iou) <= 1e-3
    assert abs(got.crf_iou - want.crf_iou) <= 1e-3
    assert np.mean(got.crf_masks == want.crf_masks) >= 0.999


def test_quality_chain_matches_golden_masks():
    """The chain's maps and masks on the golden's 64 frames (full-width
    critic, float32) against the JAX package's, before the CRF (the card
    holds the CRF and the search, chip_smoke.py)."""
    gold = np.load(GOLDEN)
    frames, gt = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))
    vae = weights.vae_from_params(*weights.numpy_vae_params(0))
    got = eval_episode(vae, critic, frames, gt, device=CPU, threshold=int(gold["threshold"]),
                       run_crf=False, mask_source="saliency", saliency_opts=QUALITY_OPTS)
    thr_gold = np.unpackbits(gold["thr_bits"], axis=-1).astype(bool)
    pred_err, within1, thr = _agreement(got, gold["preds"], gold["diff_u8"], thr_gold)
    assert pred_err <= 1e-6 and within1 >= 0.999 and thr >= 0.998
    assert abs(got.thr_iou - float(gold["thr_iou"])) <= 1e-3


def test_smoothgrad_end_to_end_by_metric(models):
    """SmoothGrad (logits, 8 samples, noise 0.08, sigma 1.0) with the port's
    generator against JAX's threefry stream: no draw is shared, so the two
    are compared by metric: thr IoU within 0.01 (the reading on this
    episode: 0.458 against JAX's 0.462)."""
    critic_np, params, state, critic, vae = models
    frames, gt = generate_frames(48, seed=9999)
    opts = {"logits": True, "samples": 8, "noise": 0.08, "sigma": 1.0, "seed": 3}
    kw = dict(threshold=120, run_crf=False, batch_size=16, mask_source="saliency",
              saliency_opts=opts)
    want = jax_eval_episode(params, state, critic_np, frames, gt, with_recons=False, **kw)
    got = eval_episode(vae, critic, frames, gt, device=CPU, **kw)
    assert np.abs(got.preds - want.preds).max() <= 1e-6
    assert abs(got.thr_iou - want.thr_iou) <= 0.01, (got.thr_iou, want.thr_iou)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny synthetic episode and full-width artifacts written by the JAX
    package's ``save_final_weights``."""
    d = tmp_path_factory.mktemp("quality")
    params, state = weights.numpy_vae_params(5)
    enc, dec = d / "encoder.ckpt", d / "decoder.ckpt"
    save_final_weights(types.SimpleNamespace(params=params, bn_state=state), str(enc), str(dec))
    for n in (2, BATCH):
        generate_episode(str(d / f"ep{n}"), num_frames=n, seed=2)
    return d, ["video", "--no-slice", "--encoder", str(enc), "--decoder", str(dec),
               "--critic", CRITIC_NPZ, "--batch-size", str(BATCH), "--no-gif"]


def _run_both(cli_setup, capsys, extra, name, frames=BATCH):
    d, common = cli_setup
    common = [*common, "--episode", str(d / f"ep{frames}")]
    for who in ("jax", "port"):
        (d / f"{name}_{who}").mkdir()
    assert jax_main([*common, *extra, "--root", str(d / f"{name}_jax")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert main([*common, *extra, "--root", str(d / f"{name}_port"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    return got, want


def _lines(out, prefixes):
    return [ln for ln in out if ln.strip().startswith(prefixes)]


def test_cli_quality_prints_jax_s_lines(cli_setup, capsys):
    got, want = _run_both(cli_setup, capsys, ["--quality"], "quality")
    ious = _lines(want, ("thr_iou=", "crf_iou="))
    assert len(ious) == 2 and _lines(got, ("thr_iou=", "crf_iou=")) == ious


def test_cli_crf_search_prints_jax_s_lines(cli_setup, capsys):
    got, want = _run_both(cli_setup, capsys, ["--crf-search", "w1=11,22"], "search",
                         frames=2)
    lines = _lines(want, ("thr_iou=", "crf_iou=", "iou=", "searching CRF parameters"))
    assert len(_lines(want, ("iou=",))) == 2
    assert _lines(got, ("thr_iou=", "crf_iou=", "iou=", "searching CRF parameters")) == lines


EXCLUSIVE = {
    "sweep": (["--sweep", "--crf-search"], "error: --sweep and --crf-search are mutually "
              "exclusive (the sweep varies the threshold, the search varies CRF parameters "
              "at one threshold)"),
    "crf_params": (["--crf-params", "22,12,3.1,8,1.8,10", "--crf-search", "w1=11"],
                   "error: --crf-params and --crf-search are mutually exclusive (the search "
                   "finds parameters; pass its winner back via --crf-params)"),
}


@pytest.mark.parametrize("case", sorted(EXCLUSIVE))
def test_cli_mutual_exclusion_exits_1_with_jax_s_message(cli_setup, capsys, case):
    d, common = cli_setup
    common = [*common, "--episode", str(d / "ep2")]
    flags, message = EXCLUSIVE[case]
    assert jax_main([*common, *flags, "--root", str(d)]) == 1
    assert message in capsys.readouterr().err
    assert main([*common, *flags, "--root", str(d), "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert message in out.err and "processing" not in out.out  # before any weights load
