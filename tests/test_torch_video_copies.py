"""The mask pipeline's copies between host and card
(critic_vae_tpu_torch/pipelines/video.py): on the CPU nothing moves and
``COPIES`` counts nothing; on the card (marked ``card``, skipped without
one) ``eval_episode`` and ``threshold_sweep`` give bitwise what the plain
path gives (``.to()`` and ``.cpu()`` of the same tensors, composed here),
a call's arrays survive the next call, an episode copies no pageable byte,
and under a profiler every copy between host and card is launched inside
``video.upload`` or ``video.readback``, none inside ``video.device_stage``
or ``video.crf``. No JAX here: the card's machine has none, so the file
runs there without tests/conftest.py, which imports it:

    python -m pytest --noconftest tests/test_torch_video_copies.py -m card
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf.device import refine_masks_device, refine_masks_multi_device
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops.mask import (
    iou_counts,
    ious_from_counts,
    normalize_diffs_given_mean,
    threshold_masks,
)
from critic_vae_tpu_torch.pipelines import video as pv

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import core, spans, tracing  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
PARAMS = (22.0, 12.0, 3.1, 8.0, 1.8, 5)
BATCH = 256
FIELDS = ("preds", "diff_u8", "thr_masks", "crf_masks", "recon_one", "recon_zero")


def _nets(device):
    critic = weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ)).to(device)
    vae = weights.vae_from_params(*weights.numpy_vae_params(3, **NARROW)).to(device)
    return vae.eval(), critic.eval()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned, asynchronous copies run only there")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same convs on both paths
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _episode(vae, critic, frames, gt, device, backend, **kw):
    return pv.eval_episode(vae, critic, frames, gt, device=device, crf_params=PARAMS,
                           run_crf=backend is not None, crf_backend=backend or "auto",
                           batch_size=BATCH, **kw)


def _plain(vae, critic, frames_u8, gt, device, backend, *, with_recons=False,
           recons_u8=False, threshold=50):
    """eval_episode's arithmetic with plain ``.to()`` and ``.cpu()`` copies."""
    frames = torch.from_numpy(frames_u8).to(device)
    preds, max_value, diff_chunks, valids, recons = pv.episode_device_stage(
        vae, critic, frames, BATCH, with_recons=with_recons, recons_u8=recons_u8)
    mean_max = torch.mean(max_value)
    u8 = torch.cat([normalize_diffs_given_mean(d, mean_max)[:v]
                    for d, v in zip(diff_chunks, valids)])
    thr = threshold_masks(u8, torch.tensor([threshold], dtype=torch.int32, device=device))[0]
    crf = crf_masks = None
    if backend == "device":
        crf = refine_masks_device(frames, thr, PARAMS, fetch=False)
        crf_masks = crf.cpu().numpy()
    elif backend == "host":
        from critic_vae_tpu_torch.crf.host import refine_masks

        crf_masks = refine_masks(frames_u8, thr.cpu().numpy(), PARAMS)
        crf = torch.from_numpy(crf_masks).to(device)
    ious = [None, None]
    if gt is not None:
        gt_dev = torch.from_numpy(gt).to(device)
        counts = [iou_counts(gt_dev, m) for m in (thr, crf) if m is not None]
        ious = ious_from_counts(torch.stack(counts)) + [None]
    return dict(preds=preds.cpu().numpy(), diff_u8=u8.cpu().numpy(), thr_masks=thr.cpu().numpy(),
                crf_masks=crf_masks, thr_iou=ious[0], crf_iou=ious[1],
                recon_one=recons[0].cpu().numpy() if recons else None,
                recon_zero=recons[1].cpu().numpy() if recons else None)


def _assert_same(res, want):
    for field in FIELDS:
        got, ref = getattr(res, field), want[field]
        if ref is None:
            assert got is None, field
        else:
            assert got.dtype == ref.dtype and got.shape == ref.shape, field
            assert np.array_equal(got, ref), field
    assert (res.thr_iou, res.crf_iou) == (want["thr_iou"], want["crf_iou"])


def test_cpu_episode_copies_nothing_and_returns_the_tensors_own_memory():
    frames, gt = generate_frames(3, seed=2)
    vae, critic = _nets("cpu")
    pv.reset_copies()
    res = _episode(vae, critic, frames, gt, torch.device("cpu"), "device")
    assert pv.COPIES == {"pinned": 0, "pinned_bytes": 0, "pageable": 0, "pageable_bytes": 0}
    assert res.thr_masks.shape == (3, 64, 64) and res.crf_masks.dtype == bool
    t = torch.arange(6)
    assert np.shares_memory(pv._to_host(t), t.numpy())
    host = np.arange(6, dtype=np.int32)
    assert np.shares_memory(pv._to_device(host, torch.device("cpu")).numpy(), host)
    assert pv._side_stream(torch.device("cpu")) is None


def test_reset_copies_zeroes_every_kind():
    pv.COPIES.update(pinned=2, pinned_bytes=10, pageable=1, pageable_bytes=3)
    pv.reset_copies()
    assert pv.COPIES == {"pinned": 0, "pinned_bytes": 0, "pageable": 0, "pageable_bytes": 0}


@pytest.mark.card
@pytest.mark.parametrize("backend", [None, "device", "host"])
@pytest.mark.parametrize("with_gt", [True, False])
def test_eval_episode_is_bitwise_the_plain_path(card, backend, with_gt):
    frames, gt = generate_frames(700, seed=4)  # 3 chunks, the last ragged
    gt = gt if with_gt else None
    vae, critic = _nets(card)
    res = _episode(vae, critic, frames, gt, card, backend)
    _assert_same(res, _plain(vae, critic, frames, gt, card, backend))


@pytest.mark.card
@pytest.mark.parametrize("recons_u8", [False, True])
def test_eval_episode_reconstructions_are_bitwise_the_plain_path(card, recons_u8):
    frames, gt = generate_frames(300, seed=6)
    vae, critic = _nets(card)
    res = _episode(vae, critic, frames, gt, card, "device", with_recons=True,
                   recons_u8=recons_u8)
    _assert_same(res, _plain(vae, critic, frames, gt, card, "device", with_recons=True,
                             recons_u8=recons_u8))


@pytest.mark.card
def test_threshold_sweep_is_bitwise_the_plain_path(card):
    frames, gt = generate_frames(600, seed=8)
    thresholds = (0, 30, 50, 90)
    vae, critic = _nets(card)
    got = pv.threshold_sweep(vae, critic, frames, gt, thresholds, device=card,
                             crf_params=PARAMS, batch_size=BATCH)
    frames_dev, gt_dev = torch.from_numpy(frames).to(card), torch.from_numpy(gt).to(card)
    _, max_value, diff_chunks, valids, _ = pv.episode_device_stage(vae, critic, frames_dev,
                                                                   BATCH)
    t = torch.tensor(thresholds, dtype=torch.int32, device=card)
    masks = torch.cat([threshold_masks(normalize_diffs_given_mean(d, torch.mean(max_value))[:v], t)
                       for d, v in zip(diff_chunks, valids)], dim=1)
    refined = refine_masks_multi_device(frames_dev, masks, PARAMS, fetch=False)
    thr_counts, crf_counts = iou_counts(gt_dev, masks), iou_counts(gt_dev, refined)
    thr_ious, crf_ious = ious_from_counts(thr_counts), ious_from_counts(crf_counts)
    assert got == [{"threshold": th, "thr_iou": thr_ious[i], "crf_iou": crf_ious[i],
                    "thr_counts": tuple(thr_counts[i].tolist()),
                    "crf_counts": tuple(crf_counts[i].tolist())}
                   for i, th in enumerate(thresholds)]


@pytest.mark.card
def test_a_calls_arrays_survive_the_next_call(card):
    vae, critic = _nets(card)
    first = _episode(vae, critic, *generate_frames(300, seed=10), card, "device")
    kept = {f: np.copy(getattr(first, f)) for f in ("preds", "diff_u8", "thr_masks", "crf_masks")}
    second = _episode(vae, critic, *generate_frames(700, seed=11), card, "device")
    for field, want in kept.items():
        assert np.array_equal(getattr(first, field), want), field
        for other in ("preds", "diff_u8", "thr_masks", "crf_masks"):
            assert not np.shares_memory(getattr(first, field), getattr(second, other))


@pytest.mark.card
def test_uploads_come_through_the_staging_ring_intact(card):
    """Arrays larger and smaller than the ring, back to back on one stream:
    each slot is written again only after its copy to the card is done."""
    rng = np.random.default_rng(0)
    piece = pv._Staging.PIECE
    hosts = [rng.integers(0, 256, size, dtype=np.uint8)
             for size in (3 * piece + 5, 7 * piece + 1, piece - 3, 5 * piece)]
    ups = [pv._to_device(h, card) for h in hosts]
    for h, up in zip(hosts, ups):
        assert np.array_equal(up.cpu().numpy(), h)


@pytest.mark.card
@pytest.mark.parametrize("backend", [None, "device"])
def test_an_episode_copies_no_pageable_byte(card, backend):
    frames, gt = generate_frames(700, seed=12)
    vae, critic = _nets(card)
    _episode(vae, critic, frames, gt, card, backend)  # every shape, and the staging's slots
    pv.reset_copies()
    _episode(vae, critic, frames, gt, card, backend)
    n = frames.shape[0] * 64 * 64
    taps = pv._spatial_taps(PARAMS[4], 64, 64).nbytes if backend else 0
    counts = (2 if backend else 1) * 3 * 8
    up = frames.nbytes + gt.nbytes + taps
    down = n + n + frames.shape[0] * 4 + (n if backend else 0) + counts
    assert pv.COPIES["pageable"] == pv.COPIES["pageable_bytes"] == 0
    assert pv.COPIES["pinned_bytes"] == up + down


@pytest.mark.card
@pytest.mark.parametrize("backend", [None, "device"])
def test_every_copy_is_launched_inside_upload_or_readback(card, backend):
    frames, gt = generate_frames(700, seed=14)
    vae, critic = _nets(card)
    _episode(vae, critic, frames, gt, card, backend)
    with tracing.capture("video-copies") as box:
        _episode(vae, critic, frames, gt, card, backend)
    trace = box["trace"]

    def copies(found):
        return {d[4] for d in found if d[1] == "gpu_memcpy" and ("HtoD" in d[0] or "DtoH" in d[0])}

    every = copies(trace.device)
    assert every
    owned = set()
    for name in ("video.upload", "video.readback"):
        owned |= copies(d for found in spans.ops(trace, name) for d in found)
    assert owned == every
    for name in ("video.device_stage", "video.crf"):
        assert not copies(d for found in spans.ops(trace, name) or [] for d in found), name
    reader = core.metric_reader("pinned_copy_pct.video")
    assert reader.read(types.SimpleNamespace(trace=trace)) == 100.0
