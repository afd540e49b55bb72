"""The port's ``video`` command against the JAX package's: its weight
artifacts (plain and FiLM) and the reference's ``.pt`` critic, the
``--crf-params`` parser, ``bin_info_vae1.txt``, the panels, the behaviour
without Pillow, and the whole command on the CPU."""

import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from critic_vae_tpu.cli import _parse_crf_params as jax_parse_crf_params
from critic_vae_tpu.cli import main as jax_main
from critic_vae_tpu.io.legacy_pt import save_torch_pt
from critic_vae_tpu.models.critic import critic_state_dict_to_torch
from critic_vae_tpu.models.critic import load_critic as jax_load_critic
from critic_vae_tpu.models.vae import init_vae_params
from critic_vae_tpu.pipelines import video as jvid
from critic_vae_tpu.pipelines.train import load_final_weights as jax_load_final_weights
from critic_vae_tpu.pipelines.train import save_final_weights
from critic_vae_tpu_torch.cli import _parse_crf_params, main
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines import video as tvid

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
CPU = torch.device("cpu")


def _film(params, seed):
    rng = np.random.default_rng(seed)
    dec = dict(params["decoder"])
    for i, co in enumerate((128, 64, 32, 32)):
        dec[f"film{i}"] = {"w": rng.normal(0, 0.5, (1, 2 * co)).astype(np.float32),
                           "b": rng.normal(0, 0.2, (2 * co,)).astype(np.float32)}
    return {"encoder": params["encoder"], "decoder": dec}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Full-width encoder/decoder artifacts written by the JAX package's
    ``save_final_weights``, plain and FiLM, as ``*.ckpt``."""
    d = tmp_path_factory.mktemp("art")
    params, state = weights.numpy_vae_params(5)
    out = {}
    for name, p in (("plain", params), ("film", _film(params, 6))):
        enc, dec = d / f"{name}_encoder.ckpt", d / f"{name}_decoder.ckpt"
        save_final_weights(types.SimpleNamespace(params=p, bn_state=state), str(enc), str(dec))
        out[name] = (str(enc), str(dec), p, state)
    return out


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("name", ["plain", "film"])
def test_final_weights_load_as_jax(artifacts, name):
    enc, dec, params, state = artifacts[name]
    got = weights.load_final_weights(enc, dec)
    want = jax_load_final_weights(enc, dec, *init_vae_params(jax.random.key(0)))
    assert [k for k, _ in _leaves({"p": got[0], "s": got[1]})] == \
        [k for k, _ in _leaves({"p": want[0], "s": want[1]})]
    for (_, g), (_, w) in zip(_leaves({"p": got[0], "s": got[1]}),
                              _leaves({"p": want[0], "s": want[1]})):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    vae = weights.vae_from_params(*got)
    assert (vae.decoder.film is not None) == (name == "film")


def test_film_artifacts_give_jax_maps(artifacts):
    """The FiLM model from the artifacts, float32, full width: the port's
    maps and masks against the JAX package's at ROADMAP's bars."""
    enc, dec, _, _ = artifacts["film"]
    frames, gt = generate_frames(4, seed=3)
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = jax_load_final_weights(enc, dec, *init_vae_params(jax.random.key(0)))
    want = jvid.eval_episode(params, state, critic_np, frames, gt, run_crf=False,
                             with_recons=False, batch_size=4)
    got = tvid.eval_episode(weights.vae_from_params(*weights.load_final_weights(enc, dec)),
                            weights.critic_from_params(critic_np), frames, gt, device=CPU,
                            run_crf=False, batch_size=4)
    assert np.abs(got.preds - want.preds).max() <= 1e-4
    assert np.mean(np.abs(got.diff_u8.astype(int) - want.diff_u8.astype(int)) <= 1) >= 0.999
    assert np.mean(got.thr_masks == want.thr_masks) >= 0.998
    assert got.thr_iou == want.thr_iou


def _rewrite(src, dst, edit):
    with np.load(src) as data:
        flat = {k: np.asarray(data[k]) for k in data.files}
    edit(flat)
    with open(dst, "wb") as f:  # a file object: np.savez adds no .npz suffix
        np.savez(f, **flat)


@pytest.mark.parametrize("fault,error", [
    ("missing", KeyError), ("extra", ValueError), ("shape", ValueError), ("dtype", ValueError)])
def test_final_weights_are_strict(artifacts, tmp_path, fault, error):
    enc, dec, _, _ = artifacts["plain"]
    key = "params/conv1/w"
    edits = {
        "missing": lambda f: f.pop(key),
        "extra": lambda f: f.__setitem__("params/conv9/w", np.zeros(3, np.float32)),
        "shape": lambda f: f.__setitem__(key, f[key][:-1]),
        "dtype": lambda f: f.__setitem__(key, f[key].astype(np.float64)),
    }
    bad = tmp_path / "bad_encoder.ckpt"
    _rewrite(enc, bad, edits[fault])
    with pytest.raises(error):
        weights.load_final_weights(str(bad), dec)
    with pytest.raises(error):  # as the JAX package's loader
        jax_load_final_weights(str(bad), dec, *init_vae_params(jax.random.key(0)))


@pytest.mark.parametrize("writer", ["torch_zip", "torch_legacy", "jax_legacy_pt"])
def test_pt_critic_loads_as_jax(tmp_path, writer):
    sd = critic_state_dict_to_torch(weights.load_critic_npz(CRITIC_NPZ))
    path = tmp_path / "critic.pt"
    if writer == "jax_legacy_pt":
        save_torch_pt(str(path), sd)
    else:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
        torch.save(tensors, path, _use_new_zipfile_serialization=writer == "torch_zip")
    got = weights.load_critic(str(path))
    want = jax_load_critic(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    npz = weights.load_critic(CRITIC_NPZ)
    for k in npz:
        np.testing.assert_array_equal(got[k], npz[k])


@pytest.mark.parametrize("spec", ["1,2,3", "a,2,3,4,5,6", "1,2,3,4,5,6.5", "1,2,3,4,5,6,7"])
def test_crf_params_parse_errors_are_jaxs(spec):
    with pytest.raises(SystemExit) as got:
        _parse_crf_params(spec)
    with pytest.raises(SystemExit) as want:
        jax_parse_crf_params(spec)
    assert str(got.value) == str(want.value)


def test_crf_params_parse():
    assert _parse_crf_params("132, 32,3.1,8,1.8,10") == jax_parse_crf_params("132,32,3.1,8,1.8,10")


def test_bin_info_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 40
    preds = rng.random(n).astype(np.float32)
    preds[:3] = 0.97  # a bin of several frames
    preds[3] = 0.449  # and a bin of one
    gt = rng.random((n, 16, 16)) < 0.3
    thr = gt ^ (rng.random(gt.shape) < 0.2)
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    tvid.write_bin_info(tvid.bin_diagnostics(preds, gt, thr), str(got), total_frames=n)
    jvid.write_bin_info(jvid.bin_diagnostics(preds, gt, thr), str(want), total_frames=n)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("with_gt", [True, False])
def test_compose_frames_pixels_equal_jax(with_gt):
    frames, gt = generate_frames(3, seed=1)
    rng = np.random.default_rng(0)
    fields = dict(
        preds=rng.random(3).astype(np.float32),
        recon_one=rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8),
        recon_zero=rng.random((3, 64, 64, 3)).astype(np.float32),
        diff_u8=rng.integers(0, 256, (3, 64, 64), dtype=np.uint8),
        thr_masks=rng.random((3, 64, 64)) < 0.5, crf_masks=rng.random((3, 64, 64)) < 0.5,
        thr_iou=0.123, crf_iou=0.456)
    g = gt if with_gt else None
    got = tvid.compose_frames(frames, tvid.EpisodeResult(**fields), g, 50)
    want = jvid.compose_frames(frames, jvid.EpisodeResult(**fields), g, 50)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.size == b.size == ((7 if with_gt else 6) * 64, 128)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _episode(tmp_path, n=4):
    ep = tmp_path / "ep"
    generate_episode(str(ep), num_frames=n, seed=2)
    return str(ep)


def test_video_without_pillow_skips_the_gif(tmp_path, capsys, monkeypatch):
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    vae = tmp_path / "vae.npz"
    weights.save_vae_npz(str(vae), *weights.numpy_vae_params(1, dims=(4, 8, 8, 16),
                                                            bottleneck=256))
    rc = main(["video", "--episode", _episode(tmp_path), "--no-slice", "--vae", str(vae),
               "--device", "cpu", "--crf-backend", "device", "--root", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert "Pillow is not installed: no GIF is written (as with --no-gif)" in out
    assert not (tmp_path / "videos").exists() and (tmp_path / "bin_info_vae1.txt").exists()


def test_encoder_and_decoder_go_together(artifacts, tmp_path, capsys):
    enc, _, _, _ = artifacts["plain"]
    rc = main(["video", "--episode", _episode(tmp_path), "--encoder", enc, "--device", "cpu"])
    assert rc == 1 and "--encoder and --decoder go together" in capsys.readouterr().err


def test_video_command_matches_jax(artifacts, tmp_path, capsys):
    """JAX-written FiLM artifacts, a ``torch.save`` ``.pt`` critic,
    ``--crf-params`` and the host CRF: the port's printed IoUs and its
    ``bin_info_vae1.txt`` equal the JAX ``video``'s, and the GIF is written
    under ``--root``."""
    enc, dec, _, _ = artifacts["film"]
    critic = tmp_path / "critic.pt"
    sd = critic_state_dict_to_torch(weights.load_critic_npz(CRITIC_NPZ))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, critic)
    ep = _episode(tmp_path)
    common = ["video", "--episode", ep, "--no-slice", "--encoder", enc, "--decoder", dec,
              "--critic", str(critic), "--crf-backend", "host", "--batch-size", "4",
              "--crf-params", "44,12,3.1,8,1.8,5"]
    for root in ("jax", "port"):  # --root must exist, as in the JAX package
        (tmp_path / root).mkdir()
    assert jax_main([*common, "--root", str(tmp_path / "jax"), "--no-gif"]) == 0
    want = capsys.readouterr().out.splitlines()
    rc = main([*common, "--root", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert rc == 0
    ious = [ln for ln in want if ln.startswith(("thr_iou=", "crf_iou="))]
    assert len(ious) == 2 and [ln for ln in got if ln.startswith(("thr_iou=", "crf_iou="))] == ious
    assert (tmp_path / "port" / "bin_info_vae1.txt").read_bytes() == \
        (tmp_path / "jax" / "bin_info_vae1.txt").read_bytes()
    gif = tmp_path / "port" / "videos" / "video-threshold=50.gif"
    assert "creating video..." in got and f"wrote {gif}" in got
    from PIL import Image

    with Image.open(gif) as im:
        assert im.n_frames == 4 and im.size == (7 * 64, 128)
