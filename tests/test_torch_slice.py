"""The port's mask-video slice as a whole: ``eval_episode`` against the JAX
package, against the golden file the JAX package wrote
(tests/golden/make_torch_slice_golden.py), the ``video`` CLI, the jax-free
import, and the device-honesty checks."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu.pipelines.video import eval_episode as jax_eval_episode
from critic_vae_tpu_torch.crf.device import BUILD_ENV
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.device import resolve_device
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.pipelines.video import eval_episode

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
GOLDEN = ROOT / "tests" / "golden" / "torch_slice_golden.npz"
CPU = torch.device("cpu")


def _critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


def test_eval_episode_matches_jax():
    frames, gt = generate_frames(4, seed=11)
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = weights.numpy_vae_params(2, dims=(4, 8, 8, 16), bottleneck=256)
    want = jax_eval_episode(params, state, critic_np, frames, gt, crf_backend="device",
                            with_recons=False, compute_dtype="float32", batch_size=3)
    got = eval_episode(weights.vae_from_params(params, state), _critic(), frames, gt,
                       device=CPU, crf_backend="device", batch_size=3)
    assert np.abs(got.preds - want.preds).max() <= 1e-5
    assert np.mean(np.abs(got.diff_u8.astype(int) - want.diff_u8.astype(int)) <= 1) >= 0.999
    assert np.mean(got.thr_masks == want.thr_masks) >= 0.998
    assert np.mean(got.crf_masks == want.crf_masks) >= 0.999
    assert got.thr_iou == want.thr_iou
    assert abs(got.crf_iou - want.crf_iou) <= 1e-3


def test_eval_episode_matches_golden_full_width(monkeypatch):
    """Full-width critic and VAE, 16 frames, f32: the port on the CPU
    against the JAX package's numbers (Pallas CRF build, interpret mode),
    the port's CRF on B2 too (its plain version)."""
    monkeypatch.setenv(BUILD_ENV, "pallas")
    gold = np.load(GOLDEN)
    frames, gt = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    vae = weights.vae_from_params(*weights.numpy_vae_params(int(gold["seed"])))
    res = eval_episode(vae, _critic(), frames, gt, device=CPU, crf_backend="device",
                       threshold=int(gold["threshold"]))
    thr_gold = np.unpackbits(gold["thr_bits"], axis=-1).astype(bool)
    crf_gold = np.unpackbits(gold["crf_bits"], axis=-1).astype(bool)
    assert np.abs(res.preds - gold["preds"]).max() <= 1e-4
    assert np.mean(np.abs(res.diff_u8.astype(int) - gold["diff_u8"].astype(int)) <= 1) >= 0.999
    assert np.mean(res.thr_masks == thr_gold) >= 0.998
    assert np.mean(res.crf_masks == crf_gold) >= 0.999
    assert res.thr_iou == float(gold["thr_iou"])
    assert abs(res.crf_iou - float(gold["crf_iou"])) <= 1e-3


def test_eval_episode_without_crf_or_gt():
    frames, gt = generate_frames(3, seed=1)
    vae = weights.vae_from_params(*weights.numpy_vae_params(0, dims=(4, 8, 8, 16),
                                                            bottleneck=256))
    res = eval_episode(vae, _critic(), frames, None, device=CPU, run_crf=False)
    assert res.crf_masks is None and res.thr_iou is None and res.crf_iou is None
    assert res.thr_masks.shape == (3, 64, 64) and res.diff_u8.dtype == np.uint8
    res = eval_episode(vae, _critic(), frames, gt, device=CPU)  # auto on the CPU: host CRF
    assert res.crf_masks.shape == (3, 64, 64) and res.crf_masks.dtype == bool


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_cli_video_on_cpu(tmp_path):
    generate_episode(str(tmp_path / "ep"), num_frames=4, seed=0)
    vae_path = tmp_path / "vae.npz"
    weights.save_vae_npz(str(vae_path), *weights.numpy_vae_params(1, dims=(4, 8, 8, 16),
                                                                   bottleneck=256))
    proc = _run(["-m", "critic_vae_tpu_torch", "video", "--episode", str(tmp_path / "ep"),
                 "--no-slice", "--vae", str(vae_path), "--device", "cpu",
                 "--crf-backend", "device", "--batch-size", "2"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert any(ln.startswith("thr_iou=") for ln in lines)
    assert any(ln.startswith("crf_iou=") for ln in lines)


def test_port_runs_without_jax(tmp_path):
    """Importing every module of the port (pkgutil.walk_packages) and running
    its CPU slice loads no jax and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch\n"
        "import critic_vae_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(critic_vae_tpu_torch.__path__,\n"
        "                                               'critic_vae_tpu_torch.')\n"
        "         if not m.name.endswith('.__main__')]  # that one runs the command line\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('critic_vae_tpu_torch.pipelines.distill',\n"
        "             'critic_vae_tpu_torch.train.critic',\n"
        "             'critic_vae_tpu_torch.pipelines.dataset',\n"
        "             'critic_vae_tpu_torch.pipelines.train',\n"
        "             'critic_vae_tpu_torch.pipelines.evaluate'):\n"
        "    assert name in names, name\n"
        "from critic_vae_tpu_torch.cli import main\n"
        "from critic_vae_tpu_torch.data.synthetic import generate_episode\n"
        "from critic_vae_tpu_torch.io.weights import numpy_vae_params, save_vae_npz\n"
        f"generate_episode({str(tmp_path / 'ep')!r}, num_frames=2, seed=0)\n"
        f"save_vae_npz({str(tmp_path / 'v.npz')!r}, *numpy_vae_params(0, dims=(4, 8, 8, 16),"
        " bottleneck=256))\n"
        f"rc = main(['video', '--episode', {str(tmp_path / 'ep')!r}, '--no-slice', '--vae',"
        f" {str(tmp_path / 'v.npz')!r}, '--device', 'cpu', '--crf-backend', 'device'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('critic_vae_tpu.') or m == 'critic_vae_tpu'"
        " for m in sys.modules)\n"
        "print('JAX_FREE_OK')\n"
    )
    proc = _run(["-c", code], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_FREE_OK" in proc.stdout


def test_device_honesty():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        resolve_device("tpu")
    # the build: sm_90a, no fast math, into a gitignored directory
    for src in kb.sources():
        for cmd in (kb.compile_command(src, Path("check.o")),
                    kb.link_command([Path("check.o")], Path("libcheck.so"))):
            assert "arch=compute_90a,code=sm_90a" in cmd
            assert not any("fast_math" in c or "fast-math" in c for c in cmd)
            assert all(Path(s).parent == kb.CSRC for s in cmd if s.endswith(".cu"))
    assert {p.name for p in kb.sources()} == {
        "diff_mask.cu", "bilateral_build.cu", "kernel_i8_build.cu", "matvec_i8.cu",
        "mean_field_resident.cu", "caps_probe.cu", "front_end_probe.cu", "mean_field_step.cu",
        "block_epilogue.cu", "spatial_message.cu"}
    rel = kb.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in (ROOT / ".gitignore").read_text().splitlines()
    # CPU runs never count a launch
    kb.reset_launches()
    frames, gt = generate_frames(2, seed=0)
    vae = weights.vae_from_params(*weights.numpy_vae_params(0, dims=(4, 8, 8, 16),
                                                            bottleneck=256))
    eval_episode(vae, _critic(), frames, gt, device=CPU, crf_backend="device")
    assert kb.LAUNCHES == {"diff_mask": 0, "bilateral_build": 0, "kernel_i8_build": 0,
                           "matvec_i8": 0, "mean_field_resident": 0, "caps_probe": 0,
                           "front_end_probe": 0, "mean_field_step": 0,
                           "block_epilogue": 0, "spatial_message": 0}
