"""The port's threshold sweep (pipelines/video.py::threshold_sweep and
``video --sweep``) against the JAX package and against the golden file the
JAX package wrote (tests/golden/make_torch_slice_golden.py), plus the
``int8``/``vmem`` builds through the CLI's build override."""

from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu.pipelines.video import threshold_sweep as jax_threshold_sweep
from critic_vae_tpu_torch.cli import _parse_sweep_range, main
from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.device import BUILD_ENV, refine_masks_device
from critic_vae_tpu_torch.data.synthetic import generate_episode, generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.pipelines.video import DEFAULT_SWEEP, eval_episode, threshold_sweep

ROOT = Path(__file__).resolve().parent.parent
CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
GOLDEN = ROOT / "tests" / "golden" / "torch_slice_golden.npz"
SWEEP_GOLDEN = ROOT / "tests" / "golden" / "torch_sweep_golden.npz"
CPU = torch.device("cpu")
SMALL = dict(dims=(4, 8, 8, 16), bottleneck=256)


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


def _critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


def _small_vae(seed):
    return weights.vae_from_params(*weights.numpy_vae_params(seed, **SMALL))


def test_threshold_sweep_matches_jax():
    frames, gt = generate_frames(4, seed=11)
    critic_np = weights.load_critic_npz(CRITIC_NPZ)
    params, state = weights.numpy_vae_params(2, **SMALL)
    want = jax_threshold_sweep(params, state, critic_np, frames, gt, crf_backend="device",
                               compute_dtype="float32", batch_size=3)
    kb.reset_launches()
    got = threshold_sweep(weights.vae_from_params(params, state), _critic(), frames, gt,
                          device=CPU, crf_backend="device", batch_size=3)
    assert [r["threshold"] for r in got] == list(DEFAULT_SWEEP) == [r["threshold"] for r in want]
    for g, w in zip(got, want):
        assert g["thr_iou"] == w["thr_iou"], g
        assert abs(g["crf_iou"] - w["crf_iou"]) <= 1e-3, g
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)


def test_threshold_sweep_matches_golden_full_width():
    """Full-width critic and VAE, 16 frames, f32: the port's sweep on the
    CPU against the JAX package's (Pallas CRF build, interpret mode)."""
    gold = np.load(SWEEP_GOLDEN)
    frames, gt = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    vae = weights.vae_from_params(*weights.numpy_vae_params(int(gold["seed"])))
    got = threshold_sweep(vae, _critic(), frames, gt, tuple(gold["thresholds"].tolist()),
                          device=CPU, crf_backend="device")
    assert [r["thr_iou"] for r in got] == gold["thr_iou"].tolist()
    np.testing.assert_allclose([r["crf_iou"] for r in got], gold["crf_iou"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("build", ["int8", "vmem"])
def test_golden_build_masks(build):
    """The int8 and vmem builds on the golden episode's first frames (64x64)
    against the JAX package's Pallas kernels."""
    gold, slice_gold = np.load(SWEEP_GOLDEN), np.load(GOLDEN)
    nb = int(gold["build_frames"])
    frames, _ = generate_frames(int(gold["num_frames"]), seed=int(gold["seed"]))
    thr = np.unpackbits(slice_gold["thr_bits"], axis=-1).astype(bool)[:nb]
    assert int(gold["build_threshold"]) == int(slice_gold["threshold"])
    got = refine_masks_device(frames[:nb], thr, REFERENCE_CRF_PARAMS, build=build, device=CPU)
    want = np.unpackbits(gold[f"{build}_bits"], axis=-1).astype(bool)
    assert np.mean(got == want) >= 0.999


def test_threshold_sweep_agrees_with_eval_episode():
    frames, gt = generate_frames(5, seed=3)
    vae, critic = _small_vae(1), _critic()
    sweep = threshold_sweep(vae, critic, frames, gt, (30, 50), device=CPU,
                            crf_backend="device", batch_size=2)
    single = eval_episode(vae, critic, frames, gt, device=CPU, threshold=50,
                          crf_backend="device", batch_size=2)
    assert [r["threshold"] for r in sweep] == [30, 50]
    assert sweep[1]["thr_iou"] == single.thr_iou
    assert abs(sweep[1]["crf_iou"] - single.crf_iou) <= 1e-3


def test_threshold_sweep_without_crf_and_policy():
    frames, gt = generate_frames(3, seed=2)
    vae, critic = _small_vae(0), _critic()
    with_crf = threshold_sweep(vae, critic, frames, gt, (0, 50, 300), device=CPU,
                               crf_backend="device")
    without = threshold_sweep(vae, critic, frames, gt, (0, 50, 300), device=CPU,
                              run_crf=False)
    assert [r["crf_iou"] for r in without] == [None] * 3
    assert [r["thr_iou"] for r in without] == [r["thr_iou"] for r in with_crf]
    assert without[2]["thr_iou"] == 0.0  # t > 255: no pixel passes, gt is not empty
    with pytest.raises(NotImplementedError):  # auto on the CPU is the unported host CRF
        threshold_sweep(vae, critic, frames, gt, device=CPU)
    with pytest.raises(NotImplementedError):
        threshold_sweep(vae, critic, frames, gt, device=CPU, crf_backend="host")


@pytest.mark.parametrize("spec,want", [("0:120", list(range(0, 130, 10))),
                                       ("10:30:5", [10, 15, 20, 25, 30]),
                                       ("40:40", [40])])
def test_parse_sweep_range(spec, want):
    assert _parse_sweep_range(spec) == want


@pytest.mark.parametrize("spec", ["0", "a:b", "0:300", "20:10", "0:10:0", "0:10:2:3"])
def test_parse_sweep_range_rejects(spec):
    with pytest.raises(SystemExit):
        _parse_sweep_range(spec)


def _run_video(tmp_path, capsys, *extra, with_gt=True):
    """``python -m critic_vae_tpu_torch video ...`` in this process on a
    4-frame episode; returns (exit code, stdout, stderr)."""
    ep = tmp_path / "ep"
    generate_episode(str(ep), num_frames=4, seed=0)
    if not with_gt:
        (ep / "Y.npy").unlink()
    vae_path = tmp_path / "vae.npz"
    weights.save_vae_npz(str(vae_path), *weights.numpy_vae_params(1, **SMALL))
    rc = main(["video", "--episode", str(ep), "--no-slice", "--vae", str(vae_path),
               "--device", "cpu", "--crf-backend", "device", "--batch-size", "2", *extra])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_video_sweep(tmp_path, capsys):
    rc, out, err = _run_video(tmp_path, capsys, "--sweep")
    assert rc == 0, err
    assert not any(ln.startswith("crf backend:") for ln in out.splitlines())  # not auto
    lines = [ln for ln in out.splitlines() if ln.startswith("thr=")]
    assert [ln.split(",")[0] for ln in lines] == [f"thr={t}" for t in DEFAULT_SWEEP]
    assert all(", thr_iou=" in ln and ", crf_iou=" in ln for ln in lines)


def test_cli_video_sweep_range(tmp_path, capsys):
    rc, out, err = _run_video(tmp_path, capsys, "--sweep-range", "0:20:10", "--no-crf")
    assert rc == 0, err
    lines = [ln for ln in out.splitlines() if ln.startswith("thr=")]
    assert len(lines) == 3 and lines[2].startswith("thr=20, thr_iou=")
    assert lines[0].endswith("crf_iou=None")


def test_cli_video_sweep_needs_ground_truth(tmp_path, capsys):
    rc, _, err = _run_video(tmp_path, capsys, "--sweep", with_gt=False)
    assert rc == 1 and "--sweep needs IoU scoring" in err


def test_cli_video_backend_error_is_reported(tmp_path, capsys):
    """``--crf-backend auto`` on the CPU resolves to the host CRF, which is
    not ported: ``error: ...`` on stderr and exit code 1, as the JAX
    package's ``video`` reports a backend it cannot run, not a traceback."""
    rc, out, err = _run_video(tmp_path, capsys, "--crf-backend", "auto")
    assert rc == 1
    assert err.startswith("error: ") and "host" in err and "Traceback" not in err
    assert "processing" not in out  # resolved before anything ran


def test_cli_video_prints_the_auto_backend(tmp_path, capsys, monkeypatch):
    """Where ``auto`` resolves to the device CRF (on CUDA), ``video`` says so
    with the JAX package's ``crf backend: device (auto)`` line."""
    from critic_vae_tpu_torch.crf import policy

    monkeypatch.setattr(policy, "resolve_crf_backend", lambda *a, **kw: "device")
    rc, out, err = _run_video(tmp_path, capsys, "--crf-backend", "auto")
    assert rc == 0, err
    assert "crf backend: device (auto)" in out.splitlines()
    assert any(ln.startswith("crf_iou=") for ln in out.splitlines())


@pytest.mark.parametrize("build", ["int8", "vmem"])
def test_cli_video_build_override(tmp_path, capsys, monkeypatch, build):
    """``CRITIC_VAE_TPU_CRF_BUILD`` selects the build for ``video``, as in the
    JAX package; on the CPU the builds run their plain versions."""
    monkeypatch.setenv(BUILD_ENV, build)
    kb.reset_launches()
    rc, out, err = _run_video(tmp_path, capsys)
    assert rc == 0, err
    assert any(ln.startswith("crf_iou=") for ln in out.splitlines())
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)
    monkeypatch.setenv(BUILD_ENV, "xla")  # and the override reaches the CRF
    with pytest.raises(NotImplementedError, match="xla"):
        _run_video(tmp_path / "xla", capsys)
