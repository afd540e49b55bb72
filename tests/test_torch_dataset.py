"""The port's reconstruction dataset and export (critic_vae_tpu_torch:
pipelines/dataset.py, data/sampler.py's ``recon_fn``, io/weights.py's
export helpers, and the ``dataset``, ``second``, ``evalsecond`` and
``export`` commands) against the JAX package on the same numpy inputs.

Tolerances: reconstructions (float32, VAE dims (4, 8, 8, 16)) within 1e-5
absolute; the dataset's bin selection, the saved and loaded arrays and the
exported state dicts bitwise.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.data import sources as jsources
from critic_vae_tpu.io.legacy_pt import load_torch_pt
from critic_vae_tpu.models import critic as jcritic
from critic_vae_tpu.models import vae as jvae
from critic_vae_tpu.pipelines import dataset as jdataset
from critic_vae_tpu_torch.cli import main
from critic_vae_tpu_torch.data import sources as tsources
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import checkpoint as ckpt_io
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.pipelines import dataset as tdataset

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
RECON_ABS = 1e-5


@pytest.fixture(scope="module")
def narrow():
    return weights.numpy_vae_params(5, **NARROW)


def test_recon_fn_matches_jax(narrow):
    """make_recon_fn against JAX's ``_recon_both`` (one chunk) and JAX's
    ``make_recon_fn`` (ragged chunks, which JAX pads to bucket shapes)."""
    params, bn_state = narrow
    frames = np.random.default_rng(0).random((7, 64, 64, 3), dtype=np.float32)
    preds = np.random.default_rng(1).random(7).astype(np.float32)
    rp, rz = jdataset._recon_both(params, bn_state, jnp.asarray(frames), jnp.asarray(preds))
    vae = weights.vae_from_params(params, bn_state)
    got_p, got_z = tdataset.make_recon_fn(vae, device="cpu")(frames, preds)
    assert got_p.dtype == got_z.dtype == np.float32 and got_p.shape == (7, 64, 64, 3)
    np.testing.assert_allclose(got_p, np.asarray(rp), rtol=0, atol=RECON_ABS)
    np.testing.assert_allclose(got_z, np.asarray(rz), rtol=0, atol=RECON_ABS)
    want_p, want_z = jdataset.make_recon_fn(params, bn_state, batch_size=3)(frames, preds)
    got_p, got_z = tdataset.make_recon_fn(vae, batch_size=3, device="cpu")(frames, preds)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=RECON_ABS)
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=RECON_ABS)


def test_recon_dataset_selection_matches_jax(narrow):
    """build_recon_dataset over two synthetic trajectories: the same frames
    in the same order (recon@pred of mid and high bins, then recon@0 of low
    and mid bins, a trajectory at a time)."""
    params, bn_state = narrow
    want = jdataset.build_recon_dataset(jsources.open_source("synthetic:2:96"),
                                        jcritic.load_critic(CRITIC_NPZ), params, bn_state,
                                        collect=20)
    got = tdataset.build_recon_dataset(
        tsources.open_source("synthetic:2:96"),
        weights.critic_from_params(weights.load_critic(CRITIC_NPZ)),
        weights.vae_from_params(params, bn_state), collect=20, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert len(got) > 40
    np.testing.assert_allclose(got, want, rtol=0, atol=RECON_ABS)
    # total_images stops at a trajectory boundary, as the JAX package's
    one = tdataset.build_recon_dataset(
        tsources.open_source("synthetic:2:96"),
        weights.critic_from_params(weights.load_critic(CRITIC_NPZ)),
        weights.vae_from_params(params, bn_state), collect=20, total_images=1, device="cpu")
    assert 0 < len(one) < len(got)


def test_dataset_files_round_trip_and_cross(tmp_path):
    """save_dataset/load_dataset: the .npz both ways between the packages,
    a raw .npy memory-mapped, the reference's pickle (a list of (1, 3, H, W)
    float32 frames) through the restricted unpickler, and its refusals."""
    rng = np.random.default_rng(0)
    frames = rng.random((5, 64, 64, 3)).astype(np.float32)
    tdataset.save_dataset(str(tmp_path / "port.npz"), frames)
    jdataset.save_dataset(str(tmp_path / "jax.npz"), frames)
    for path in ("port.npz", "jax.npz"):
        for load in (tdataset.load_dataset, jdataset.load_dataset):
            got = load(str(tmp_path / path))
            assert got.dtype == np.float32 and np.array_equal(got, frames)
    np.save(tmp_path / "raw.npy", frames)
    raw = tdataset.load_dataset(str(tmp_path / "raw.npy"))
    assert isinstance(raw, np.memmap) and np.array_equal(raw, frames)
    bchw = [rng.random((1, 3, 64, 64)).astype(np.float32) for _ in range(4)]
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump(bchw, f)
    got = tdataset.load_dataset(str(tmp_path / "ref.pkl"))
    want = jdataset.load_dataset(str(tmp_path / "ref.pkl"))
    assert got.shape == (4, 64, 64, 3) and np.array_equal(got, want)
    np.testing.assert_array_equal(got[2], bchw[2][0].transpose(1, 2, 0))
    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump([{"not": "an array"}, object], f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.object is forbidden"):
        tdataset.load_dataset(str(tmp_path / "evil.pkl"))
    np.save(tmp_path / "flat.npy", frames[..., 0])
    with pytest.raises(ValueError, match=r"\.npy dataset must be \(N, H, W, 3\)"):
        tdataset.load_dataset(str(tmp_path / "flat.npy"))


def _write_artifacts(root, params, state, prefix="saved-networks/vae_"):
    ckpt_io.save_pytree(str(root / f"{prefix}encoder.ckpt"),
                        {"params": params["encoder"], "bn_state": state})
    ckpt_io.save_pytree(str(root / f"{prefix}decoder.ckpt"), {"params": params["decoder"]})


def test_dataset_second_evalsecond_commands(tmp_path, capsys):
    from PIL import Image

    root = tmp_path / "root"
    (root / "source-images").mkdir(parents=True)
    _write_artifacts(root, *weights.numpy_vae_params(0))
    common = ["--root", str(root), "--device", "cpu"]
    assert main(["dataset", "--source", "synthetic:1:64", "--total-images", "100", *common]) == 0
    out = capsys.readouterr().out.splitlines()
    dset = tdataset.load_dataset(str(root / "recon-dataset.npz"))
    assert out[-1] == f"saved {len(dset)} recon frames to {root / 'recon-dataset.npz'}"
    assert dset.shape[1:] == (64, 64, 3) and dset.dtype == np.float32 and len(dset) >= 8
    assert main(["second", "--epochs", "1", "--batch-size", "8", *common]) == 0
    out = capsys.readouterr().out
    assert out.startswith("training second vae...")
    assert f"saved {root / 'vae2_encoder.ckpt'} and {root / 'vae2_decoder.ckpt'}" in out
    for i, f in enumerate(generate_frames(2, seed=3)[0]):
        Image.fromarray(f).save(root / "source-images" / f"frame-{i}.png")
    assert main(["evalsecond", "--out", str(root / "second"), *common]) == 0
    assert "wrote 2 strips" in capsys.readouterr().out
    assert len(list((root / "second").glob("image-*.png"))) == 2


def test_export_is_read_by_load_torch_pt(tmp_path, capsys):
    """export's .pt files read by the JAX package's load_torch_pt (and by
    torch.load), bitwise equal to its vae_state_dicts_to_torch and
    critic_state_dict_to_torch of the same params."""
    params, state = weights.numpy_vae_params(4)
    _write_artifacts(tmp_path, params, state)
    paths = {k: str(tmp_path / f"{k}.pt") for k in ("enc", "dec", "critic")}
    assert main(["export", "--root", str(tmp_path), "--encoder-out", paths["enc"],
                 "--decoder-out", paths["dec"], "--critic-out", paths["critic"]]) == 0
    assert capsys.readouterr().out == (
        f"exported {paths['enc']}, {paths['dec']}, {paths['critic']}\n")
    want_enc, want_dec = jvae.vae_state_dicts_to_torch(params, state)
    want_critic = jcritic.critic_state_dict_to_torch(jcritic.load_critic(CRITIC_NPZ))
    for key, want in (("enc", want_enc), ("dec", want_dec), ("critic", want_critic)):
        got = load_torch_pt(paths[key])
        loaded = torch.load(paths[key], weights_only=True)
        assert list(got) == list(want) == list(loaded)
        for k, v in want.items():
            g = np.asarray(got[k])
            assert g.dtype == v.dtype and g.shape == v.shape and np.array_equal(g, v), (key, k)
            assert np.array_equal(loaded[k].numpy(), v)
    # the port's numpy helpers are the JAX package's, leaf for leaf
    for got, want in zip(weights.vae_state_dicts_to_torch(params, state), (want_enc, want_dec)):
        assert all(np.array_equal(got[k], v) and got[k].dtype == v.dtype for k, v in want.items())


def test_export_refusals_are_jaxs(tmp_path, capsys):
    assert main(["export", "--root", str(tmp_path)]) == 1
    assert capsys.readouterr().err == ("error: nothing to export (pass --encoder-out/"
                                       "--decoder-out and/or --critic-out)\n")
    assert main(["export", "--root", str(tmp_path), "--encoder-out", "e.pt"]) == 1
    assert capsys.readouterr().err == "error: --encoder-out and --decoder-out go together\n"
    params, state = weights.numpy_vae_params(0, film=True)
    _write_artifacts(tmp_path, params, state)
    with pytest.raises(ValueError) as got:
        main(["export", "--root", str(tmp_path), "--encoder-out", str(tmp_path / "e.pt"),
              "--decoder-out", str(tmp_path / "d.pt")])
    with pytest.raises(ValueError) as want:
        jvae.vae_state_dicts_to_torch(jax.tree.map(jnp.asarray, params), state)
    assert str(got.value) == str(want.value) and "FiLM" in str(got.value)
    assert not (tmp_path / "e.pt").exists()
