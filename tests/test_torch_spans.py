"""The port's spans (utils/profiling.py::span): under ``torch.profiler``
``eval_episode`` and the device CRF emit the ``video.*`` and ``crf.*``
spans nested as the catalogue lists them, the ``--quality`` chain its
``saliency.*`` spans inside ``video.device_stage``, a train step emits its
four phases in turn, outside a profiler a span is the one
shared null context, and the outputs are bitwise the same with the
profiler on and off."""

import contextlib

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops import saliency
from critic_vae_tpu_torch.pipelines.video import eval_episode
from critic_vae_tpu_torch.train import step as tstep
from critic_vae_tpu_torch.utils.profiling import span

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
CPU = torch.device("cpu")

# each span of the catalogue and the span it nests in (None: a root)
VIDEO_PARENTS = {"video.episode": None, "video.upload": "video.episode",
                 "video.device_stage": "video.episode", "video.normalize": "video.episode",
                 "video.crf": "video.episode", "video.readback": "video.episode",
                 "video.score": "video.episode", "crf.build": "video.crf",
                 "crf.mean_field": "video.crf"}
TRAIN_PARENTS = {"train.forward": None, "train.loss": None, "train.backward": None,
                 "train.update": None}


def _critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


def _profiled(fn, on: bool):
    """``fn()``'s result, and with ``on`` the profiler's events over it."""
    if not on:
        return fn(), None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _span_parents(events, catalogue):
    """[(span, the nearest enclosing span of the catalogue)] in order."""
    found = []
    for e in events:
        if e.name not in catalogue:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in catalogue:
            p = p.cpu_parent
        found.append((e.name, None if p is None else p.name))
    return found


@pytest.fixture(scope="module")
def episodes():
    """One small CPU episode through the device CRF, with the profiler on
    and off."""
    frames, gt = generate_frames(3, seed=5)
    vae = weights.vae_from_params(*weights.numpy_vae_params(3, **NARROW))
    critic = _critic()

    def run():
        return eval_episode(vae, critic, frames, gt, device=CPU, run_crf=True,
                            crf_backend="device", batch_size=2,
                            crf_params=(22.0, 12.0, 3.1, 8.0, 1.8, 3))

    on, events = _profiled(run, True)
    off, _ = _profiled(run, False)
    return on, events, off


@pytest.fixture(scope="module")
def steps():
    """One train step from the same state on the same batch and noise,
    with the profiler on and off: (state, losses) each."""
    frames, _ = generate_frames(4, seed=9)
    batch = torch.from_numpy(frames)
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32), np.float32))
    critic = _critic()
    out = []
    for on in (True, False):
        state = tstep.init_train_state(*weights.numpy_vae_params(2, **NARROW), device="cpu")
        step = tstep.make_train_step(critic, learning_rate=5e-5)
        losses, events = _profiled(lambda: step(state, batch, eps), on)
        out.append((state, losses, events))
    return out


def test_eval_episode_emits_the_video_and_crf_spans_nested(episodes):
    _, events, _ = episodes
    found = _span_parents(events, VIDEO_PARENTS)
    assert set(VIDEO_PARENTS) == {name for name, _ in found}
    for name, parent in found:
        assert parent == VIDEO_PARENTS[name], (name, parent)
    counts = {name: sum(1 for n, _ in found if n == name) for name in VIDEO_PARENTS}
    # 3 frames: two chunks of the device stage and one of the CRF (one build,
    # one mean field); the frames go up before the device stage, the ground
    # truth and the CRF's taps after it; the maps, the threshold masks and
    # the scores read back before the CRF, its masks and the IoUs' counts
    # after it; two IoUs in one span
    assert counts == {**{name: 1 for name in VIDEO_PARENTS}, "video.device_stage": 2,
                      "video.upload": 2, "video.readback": 2}
    # the frames, the ground truth and the CRF's taps go to the device
    # inside video.upload
    uploads = [e for e in events if e.name == "aten::to" and e.cpu_parent is not None
               and e.cpu_parent.name == "video.upload"]
    assert len(uploads) == 3


def test_train_step_emits_its_four_phases(steps):
    found = _span_parents(steps[0][2], TRAIN_PARENTS)
    assert found == [("train.forward", None), ("train.loss", None), ("train.backward", None),
                     ("train.update", None)]


def test_span_outside_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("video.episode"), span("train.forward")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:  # reentrant: spans nest
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert span("video.episode") is not a


def test_outputs_bitwise_the_same_with_the_profiler_on_and_off(episodes, steps):
    on, _, off = episodes
    for field in ("preds", "diff_u8", "thr_masks", "crf_masks"):
        got, want = getattr(on, field), getattr(off, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert (on.thr_iou, on.crf_iou) == (off.thr_iou, off.crf_iou)
    (s_on, l_on, _), (s_off, l_off, _) = steps
    assert set(l_on) == set(l_off)
    for k in l_on:
        assert torch.equal(l_on[k], l_off[k]), k
    sd_on, sd_off = s_on.vae.state_dict(), s_off.vae.state_dict()
    for k in sd_off:
        assert torch.equal(sd_on[k], sd_off[k]), k
    for a, b in zip(list(s_on.mu) + list(s_on.nu), list(s_off.mu) + list(s_off.nu)):
        assert torch.equal(a, b)
    assert int(s_on.step) == int(s_off.step) == 1


QUALITY_PARENTS = {"video.device_stage": None, "saliency.view": "video.device_stage",
                   "saliency.upsample": "video.device_stage",
                   "saliency.combine": "video.device_stage"}


def test_quality_chain_emits_the_saliency_spans_and_counts_its_views():
    """``eval_episode`` on the ``--quality`` chain (LayerCAM, six views,
    CRF off) over 3 frames in two chunks: a view span and an upsample span a
    view, a combine span a view after the clean one, all in the chunk's
    device stage; 12 views, one backward each; outputs bitwise the same
    with the profiler off."""
    frames, gt = generate_frames(3, seed=7)
    opts = dict(method="layercam", cam_block=1, cam_upsample="lanczos3", tta_flip=True,
                tta_shift=2)
    results, views = [], []
    for on in (True, False):
        saliency.reset_views()
        out, events = _profiled(lambda: eval_episode(
            None, _critic(), frames, gt, device=CPU, threshold=64, run_crf=False, batch_size=2,
            mask_source="saliency", saliency_opts=opts), on)
        results.append(out)
        views.append(dict(saliency.VIEWS))
        if on:
            found = _span_parents(events, QUALITY_PARENTS)
    for name, parent in found:
        assert parent == QUALITY_PARENTS[name], (name, parent)
    counts = {name: sum(1 for n, _ in found if n == name) for name in QUALITY_PARENTS}
    assert counts == {"video.device_stage": 2, "saliency.view": 12, "saliency.upsample": 12,
                      "saliency.combine": 10}
    # each chunk: its six views, each view's upsample after it
    order = [n for n, _ in found if n != "saliency.combine"]
    chunk = ["video.device_stage"] + ["saliency.view", "saliency.upsample"] * 6
    assert order == chunk * 2
    assert views == [{"views": 12, "backward": 12}] * 2
    on, off = results
    for field in ("preds", "diff_u8", "thr_masks"):
        got, want = getattr(on, field), getattr(off, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert on.thr_iou == off.thr_iou
