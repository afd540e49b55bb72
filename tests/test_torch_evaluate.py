"""The port's image evaluation and injection (critic_vae_tpu_torch
pipelines/evaluate.py, viz/panels.py ``inject_strip`` and the ``eval``,
``inject`` and ``evalsecond`` commands) against the JAX package's on the
same PNGs and numpy weights (a narrow VAE, dims (4, 8, 8, 16), and the
full-width critic of critic-synthetic.npz).

Bars: the parity bars of the JAX package (preds within 1e-4, uint8 maps
>= 99.9% of pixels within one level); in float32 the port's maps are
expected to equal JAX's, and reconstructions lie within 1e-5. Strips are
compared pixel for pixel."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.pipelines import evaluate as jev
from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import checkpoint as tckpt
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines import evaluate as tev

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
SLICE_GOLDEN = "tests/golden/torch_slice_golden.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)


@pytest.fixture(scope="module")
def models():
    params, state = weights.numpy_vae_params(8, **NARROW)
    crit = weights.load_critic_npz(CRITIC_NPZ)
    return {"vae": weights.vae_from_params(params, state),
            "critic": weights.critic_from_params(crit),
            "jax": (params, state, jax_load_critic(CRITIC_NPZ))}


def _write_pngs(directory, frames):
    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(directory, f"still-{i:02d}.png"))


@pytest.fixture(scope="module")
def stills(tmp_path_factory):
    d = tmp_path_factory.mktemp("stills")
    _write_pngs(str(d), generate_frames(10, seed=4)[0])
    return str(d)


def test_load_image_dir_is_jaxs(stills):
    got, got_files = tev.load_image_dir(stills)
    want, want_files = jev.load_image_dir(stills)
    assert got_files == want_files == sorted(got_files)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["empty", "mixed"])
def test_load_image_dir_errors_are_jaxs(tmp_path, case):
    if case == "mixed":
        Image.new("RGB", (64, 64)).save(tmp_path / "a.png")
        Image.new("RGB", (32, 32)).save(tmp_path / "b.png")
    (tmp_path / "notes.txt").write_text("not an image")
    errors = []
    for mod in (jev, tev):
        with pytest.raises(Exception) as info:
            mod.load_image_dir(str(tmp_path))
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1])


def _assert_eval_close(got, want):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=0, atol=1e-4)
    for k in ("recon_one", "recon_zero"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    assert got["diff_u8"].dtype == np.uint8 and got["diff_u8"].shape == want["diff_u8"].shape
    step = np.abs(got["diff_u8"].astype(int) - want["diff_u8"].astype(int))
    assert np.mean(step <= 1) >= 0.999
    return float(np.mean(step == 0))


@pytest.mark.parametrize("batch_size", [4, 512])
def test_evaluate_images_matches_jax(models, stills, batch_size):
    images, _ = tev.load_image_dir(stills)
    want = jev.evaluate_images(*models["jax"], images, batch_size=batch_size)
    got = tev.evaluate_images(models["vae"], models["critic"], images, batch_size=batch_size,
                              device="cpu")
    assert _assert_eval_close(got, want) >= 0.999  # float32: the maps equal JAX's


def test_evaluate_images_does_not_depend_on_chunking(models, stills):
    images, _ = tev.load_image_dir(stills)
    whole = tev.evaluate_images(models["vae"], models["critic"], images, device="cpu")
    chunked = tev.evaluate_images(models["vae"], models["critic"], images, batch_size=3,
                                  device="cpu")
    _assert_eval_close(chunked, whole)


def test_empty_batches_are_jaxs(models):
    images = np.zeros((0, 64, 64, 3), np.float32)
    for got, want in ((tev.evaluate_images(models["vae"], models["critic"], images, device="cpu"),
                       jev.evaluate_images(*models["jax"], images)),
                      (tev.inject_images(models["vae"], models["critic"], images, device="cpu"),
                       jev.inject_images(*models["jax"], images))):
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype


@pytest.mark.parametrize("values,batch_size", [(None, 256), (np.float32([0.0, 0.5, 1.0]), 4)])
def test_inject_images_matches_jax(models, stills, values, batch_size):
    images, _ = tev.load_image_dir(stills)
    want = jev.inject_images(*models["jax"], images, values, batch_size=batch_size)
    got = tev.inject_images(models["vae"], models["critic"], images, values,
                            batch_size=batch_size, device="cpu")
    assert got["recons"].shape == want["recons"].shape == (10, 6 if values is None else 3,
                                                            64, 64, 3)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["recons"], want["recons"], rtol=0, atol=1e-5)


def test_strips_equal_jaxs(models, stills, tmp_path):
    images, _ = tev.load_image_dir(stills)
    res = tev.evaluate_images(models["vae"], models["critic"], images[:3], device="cpu")
    inj = tev.inject_images(models["vae"], models["critic"], images[:3], device="cpu")
    for name, save_t, save_j, r in (("eval", tev.save_eval_strips, jev.save_eval_strips, res),
                                    ("inject", tev.save_inject_strips, jev.save_inject_strips,
                                     inj)):
        got = save_t(r, images[:3], str(tmp_path / f"{name}_port"))
        want = save_j(r, images[:3], str(tmp_path / f"{name}_jax"))
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] \
            == ["image-000.png", "image-001.png", "image-002.png"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w)))
    assert Image.open(tmp_path / "inject_port" / "image-000.png").size == (7 * 64, 64)


def test_entry_points_default_to_the_card(models):
    """Without ``device`` eval and inject run on CUDA (here: its error when
    there is no card), never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    images = np.zeros((2, 64, 64, 3), np.float32)
    for call in (lambda: tev.evaluate_images(models["vae"], models["critic"], images),
                 lambda: tev.inject_images(models["vae"], models["critic"], images)):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


def test_eval_inject_evalsecond_commands(tmp_path, capsys):
    """The three commands through the parser on the 16 frames of the slice
    golden, written as PNGs, with full-width artifacts of numpy_vae_params(0):
    eval's maps (the strips' 4th panel) at the bars against the JAX
    package's maps in that golden."""
    gold = np.load(SLICE_GOLDEN)
    frames = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))[0]
    root = tmp_path / "root"
    _write_pngs(str(root / "source-images"), frames)
    params, state = weights.numpy_vae_params(int(gold["seed"]))
    for enc, dec in (("saved-networks/vae_encoder.ckpt", "saved-networks/vae_decoder.ckpt"),
                     ("vae2_encoder.ckpt", "vae2_decoder.ckpt")):
        tckpt.save_pytree(str(root / enc), {"params": params["encoder"], "bn_state": state})
        tckpt.save_pytree(str(root / dec), {"params": params["decoder"]})
    common = ["--device", "cpu", "--root", str(root)]
    for command, out in (("eval", "images"), ("evalsecond", "second")):
        assert main([command, *common, "--out", str(root / out)]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == \
            f"wrote 16 strips to {root / out}"
        maps = np.stack([np.asarray(Image.open(root / out / f"image-{i:03d}.png"))[:, 192:256, 0]
                         for i in range(16)])
        step = np.abs(maps.astype(int) - gold["diff_u8"].astype(int))
        assert np.mean(step <= 1) >= 0.999
    assert main(["inject", *common, "--values", "0,0.5,1"]) == 0
    assert Image.open(root / "inject" / "image-015.png").size == (4 * 64, 64)
