"""The ``--quality`` chain (the critic's LayerCAM at block 1 over six
test-time views) against the benchmark's plain reference,
bench_torch/reference/saliency.py, on the CPU: seeded, standardised critic
weights as the cell ``video-quality-nocrf`` makes them, 8 frames of 64x64.

Each view's map and the combined map of ``ops/saliency.py`` agree with the
reference's within 1e-5 of the reference map's largest value: both compute
in float32, the port adding each conv's bias after the conv and the
reference inside it, so their sums round in other orders (the worst seen,
seeds 3-5: 6.9e-7). ``eval_episode`` on the chain passes the cell's limits
through the cell's own check; each planted fault of the cell's driver
fails them, so the check has teeth; the cell's CPU rehearsal exits 3,
correct."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from critic_vae_tpu_torch.ops import saliency
from critic_vae_tpu_torch.pipelines.video import eval_episode

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import core, traffic  # noqa: E402
from bench_torch.reference import saliency as ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CELL = "video-quality-nocrf"
CPU = torch.device("cpu")
MAP_RTOL = 1e-5
VIEWS = [(mirror, dx) for mirror in (False, True) for dx in (0, 2, -2)]


@pytest.fixture(scope="module")
def quality():
    return core.driver("quality")


@pytest.fixture(scope="module")
def setup(quality):
    """The cell, its seeded critic (module and state dict) standardised on
    64 frames, and 8 frames with their ground truth."""
    cell = core.load_cell(CELL, rehearsal=True)
    cfg = {**cell.config, "calibration_frames": 64}
    critic, _, critic_sd, _ = quality._video._models(cfg, cell.traffic, 3, CPU)
    frames, gt = traffic.frames(8, 103, cell.traffic, CPU)
    return cell, critic, critic_sd, frames, gt


def _nchw(frames):
    return frames.float().permute(0, 3, 1, 2) / 255.0


@pytest.mark.parametrize("mirror, dx", VIEWS)
def test_each_view_map_matches_the_reference(setup, mirror, dx):
    cell, critic, critic_sd, frames, _ = setup
    x = _nchw(frames)
    preds, got = saliency._eager(saliency._view(
        critic, x, None, smooth_sigma=0.0, logits=False, noise=0.0, method="layercam",
        cam_block=1, cam_upsample="lanczos3", flip=mirror, shift=dx))
    view = torch.roll(x.flip(3) if mirror else x, dx, dims=3)
    logit, want = ref.layercam(critic_sd, view, 1)
    assert want.max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=MAP_RTOL * float(want.max()))
    torch.testing.assert_close(preds, torch.sigmoid(logit), rtol=0, atol=1e-6)


def test_combined_map_and_preds_match_the_reference(setup):
    cell, critic, critic_sd, frames, _ = setup
    cfg = cell.config
    x = _nchw(frames)
    preds, got = saliency.critic_saliency(critic, x, method=cfg["method"],
                                          cam_block=cfg["cam_block"],
                                          cam_upsample=cfg["cam_upsample"],
                                          tta_flip=cfg["tta_flip"], tta_shift=cfg["tta_shift"])
    want_preds, want = ref.views_min(critic_sd, x, cfg["cam_block"], cfg["tta_flip"],
                                     cfg["tta_shift"])
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=MAP_RTOL * float(want.max()))
    torch.testing.assert_close(preds, want_preds, rtol=0, atol=1e-6)
    # the minimum over the views differs from the clean view alone
    _, clean = ref.layercam(critic_sd, x, cfg["cam_block"])
    assert not torch.allclose(clean, want)


def _judged(quality, setup, mode: str):
    """``eval_episode`` on the chain as the cell runs it, with ``mode``
    planted, and the cell's check of it: (correct, numbers)."""
    cell, critic, critic_sd, frames, gt = setup
    pool = [(frames.numpy(), gt.numpy())]
    with quality._planted(mode):
        res = eval_episode(None, critic, *pool[0], **quality._episode_kwargs(cell, CPU, mode))
    numbers = quality._check(cell, critic_sd, None, pool, [(0, res)], CPU)
    return core.judge(numbers, cell.workload["limits"])[0], numbers


def test_eval_episode_on_the_chain_is_within_the_cells_limits(quality, setup):
    correct, numbers = _judged(quality, setup, "program")
    assert correct, numbers
    assert numbers["thr_mask_mismatch"] == 0.0


@pytest.mark.parametrize("fault", ["no_mirror", "finite_border"])
def test_each_planted_fault_fails_the_cells_limits(quality, setup, fault):
    correct, numbers = _judged(quality, setup, fault)
    assert not correct, numbers


def test_cell_rehearsal_on_the_cpu_is_correct():
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELL, "--device",
                           "cpu", "--seed", "3000000019", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "correct True" in proc.stdout, proc.stdout[-2000:]
