"""The whole-stack IoUs counted on the masks' device (ops/mask.py::
iou_counts, divided on the host by ``ious_from_counts``) against numpy's
(ops/iou.py::iou), bitwise: in ``eval_episode`` with the device CRF (its
``xla`` build on the CPU) and the host CRF, and in ``threshold_sweep`` and
``crf_param_search``. Cases: random masks, an empty union (0/0 -> 1.0),
every mask set, and counts whose quotient lies on a third-decimal
rounding boundary."""

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    crf_param_search,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops.iou import iou
from critic_vae_tpu_torch.ops.mask import iou_counts, ious_from_counts
from critic_vae_tpu_torch.pipelines.video import eval_episode, threshold_sweep

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
CPU = torch.device("cpu")
CRF_PARAMS = (22.0, 12.0, 3.1, 8.0, 1.8, 3)
CASES = ("random", "empty_union", "all_set", "rounding_boundary")
# each case's threshold: 255 leaves every mask empty, -1 sets every one
THRESHOLDS = {"random": 50, "empty_union": 255, "all_set": -1, "rounding_boundary": 50}


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


@pytest.fixture(scope="module")
def models():
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))
    return weights.vae_from_params(*weights.numpy_vae_params(4, **NARROW)), critic


@pytest.fixture(scope="module")
def episode():
    """Two frames in two chunks, so the masks are joined across chunks."""
    return generate_frames(2, seed=13)


@pytest.fixture(scope="module")
def without_gt(models, episode):
    """``eval_episode`` without ground truth, at the boundary case's
    threshold, by backend (None: no CRF)."""
    vae, critic = models
    return {backend: eval_episode(vae, critic, episode[0], None, device=CPU,
                                  threshold=THRESHOLDS["rounding_boundary"],
                                  run_crf=backend is not None, crf_backend=backend or "auto",
                                  batch_size=1, crf_params=CRF_PARAMS)
            for backend in ("device", "host", None)}


def _boundary_gt(masks: np.ndarray) -> np.ndarray:
    """Ground truth whose IoU against ``masks`` is 5/16 = 0.3125 exactly,
    which round(., 3) takes to even (0.312): 5q of the masks' pixels, and
    16q - |masks| pixels outside them."""
    flat = masks.reshape(-1)
    on, off = np.flatnonzero(flat), np.flatnonzero(~flat)
    q = -(-len(on) // 16)
    assert 5 * q <= len(on) and 16 * q - len(on) <= len(off)
    gt = np.zeros_like(flat)
    gt[on[:5 * q]] = True
    gt[off[:16 * q - len(on)]] = True
    return gt.reshape(masks.shape)


def _numpy_counts(gt: np.ndarray, pred: np.ndarray) -> tuple:
    """numpy's whole-stack (tp, fn, fp) of boolean ``pred`` against ``gt``."""
    return (int(np.sum(gt & pred)), int(np.sum(gt & ~pred)), int(np.sum(~gt & pred)))


def _gt(case: str, shape, thr_masks: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(case))
    if case == "empty_union":
        return np.zeros(shape, bool)
    if case == "rounding_boundary":
        return _boundary_gt(thr_masks)
    return rng.random(shape) < 0.3


@pytest.mark.parametrize("case", CASES)
def test_counts_give_numpys_iou_over_leading_axes(case):
    shape = (3, 8, 8)
    rng = np.random.default_rng(7)
    masks = {"random": rng.random((4,) + shape) < 0.5,
             "empty_union": np.zeros((4,) + shape, bool),
             "all_set": np.ones((4,) + shape, bool)}.get(case)
    if masks is None:
        masks = np.stack([rng.random(shape) < 0.5 for _ in range(4)])
    gt = _gt(case, shape, masks[0])
    counts = iou_counts(torch.from_numpy(gt), torch.from_numpy(masks).to(torch.uint8))
    assert counts.shape == (4, 3) and counts.dtype == torch.int64
    assert ious_from_counts(counts) == [iou(gt, m) for m in masks]
    assert ious_from_counts(counts, round_digits=None) == [iou(gt, m, round_digits=None)
                                                          for m in masks]
    assert ious_from_counts(iou_counts(torch.from_numpy(gt), torch.from_numpy(masks[0]))) == \
        [iou(gt, masks[0])]
    if case == "empty_union":
        assert ious_from_counts(counts) == [1.0] * 4
    if case == "rounding_boundary":
        assert ious_from_counts(counts)[0] == 0.312


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("case", CASES)
def test_eval_episode_ious_are_numpys_on_its_masks(models, episode, without_gt, case,
                                                   backend):
    vae, critic = models
    frames = episode[0]
    thr_masks = without_gt[backend].thr_masks
    gt = _gt(case, frames.shape[:3], thr_masks)
    r = eval_episode(vae, critic, frames, gt, device=CPU, threshold=THRESHOLDS[case],
                     crf_backend=backend, batch_size=1, crf_params=CRF_PARAMS)
    assert r.thr_iou == iou(gt, r.thr_masks) and r.crf_iou == iou(gt, r.crf_masks)
    assert type(r.thr_iou) is float and type(r.crf_iou) is float
    if case == "empty_union":
        assert not r.thr_masks.any() and r.thr_iou == 1.0
    if case == "all_set":
        assert r.thr_masks.all()
    if case == "rounding_boundary":
        np.testing.assert_array_equal(r.thr_masks, thr_masks)
        assert r.thr_iou == 0.312


@pytest.mark.parametrize("backend", ["device", "host", None])
def test_eval_episode_without_ground_truth_scores_nothing(without_gt, backend):
    r = without_gt[backend]
    assert r.thr_iou is None and r.crf_iou is None
    assert (r.crf_masks is None) == (backend is None)


@pytest.mark.parametrize("pipeline", ["threshold_sweep", "crf_param_search"])
def test_sweep_and_param_search_ious_are_numpys(models, episode, without_gt, pipeline):
    """The helper pair gives ``threshold_sweep``'s IoUs (rounded) and
    ``crf_param_search``'s scores (unrounded) as numpy does on the masks
    they count."""
    vae, critic = models
    frames, gt = episode
    if pipeline == "threshold_sweep":
        thresholds = (-1, 60, 255)
        got = threshold_sweep(vae, critic, frames, gt, thresholds, device=CPU,
                              crf_backend="device", batch_size=1, crf_params=CRF_PARAMS)
        diff_u8 = without_gt[None].diff_u8.astype(np.int32)
        masks = np.stack([diff_u8 > th for th in thresholds])
        crf = refine_masks_multi_device(frames, masks, CRF_PARAMS, device=CPU)
        assert got == [{"threshold": th, "thr_iou": iou(gt, m), "crf_iou": iou(gt, c),
                        "thr_counts": _numpy_counts(gt, m), "crf_counts": _numpy_counts(gt, c)}
                       for th, m, c in zip(thresholds, masks, crf)]
        return
    small, small_gt = generate_frames(3, size=16, seed=5)
    noisy = small_gt ^ (np.random.default_rng(1).random(small_gt.shape) < 0.1)
    best, got = crf_param_search(small, noisy, small_gt, {"w1": [11.0, 22.0], "iters": [2]},
                                 device="cpu")
    for score, params in got:
        refined = refine_masks_device(small, noisy, params, device="cpu")
        assert score == iou(small_gt, refined, round_digits=None)
    np.testing.assert_array_equal(best, refine_masks_device(small, noisy, got[0][1], device="cpu"))
