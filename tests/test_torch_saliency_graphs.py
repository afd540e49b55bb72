"""The saliency stage replayed as CUDA graphs (ops/saliency.py): on a card
(marked ``card``, skipped without one) a signature's first call runs
eagerly, its second is captured and replayed, and every replay gives
bitwise what the eager parts give, for LayerCAM and the blurred gradient
with test-time views, over new frames, after the critic's weights change
in place, and for a second critic; ``eval_episode`` on the ``--quality``
chain is bitwise the eager stage's, counts its views and backward passes
in ``VIEWS`` as the eager stage does, and under a profiler each replayed
part's kernels lie inside its ``saliency.*`` span; a capture is a set-up
span keyed by the frames' shape, held by the episode's first call where
it falls in it. No JAX here: the
card's machine has none, so the file runs there without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_saliency_graphs.py -m card
"""

import sys
from pathlib import Path

import pytest
import torch

from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops import saliency
from critic_vae_tpu_torch.pipelines.video import eval_episode
from critic_vae_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import spans, tracing  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = str(ROOT / "saved-networks" / "critic-synthetic.npz")
QUALITY = dict(method="layercam", cam_block=1, cam_upsample="lanczos3", tta_flip=True,
               tta_shift=2)
GRADIENT = dict(method="gradient", smooth_sigma=1.5, tta_flip=True, tta_shift=2)
PARTS = ("saliency.view", "saliency.upsample", "saliency.combine")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the saliency stage replays as CUDA graphs only there")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same convs on both paths
    saliency._GRAPHS.__init__()
    try:
        yield torch.device("cuda")
    finally:
        saliency._GRAPHS.__init__()
        torch.backends.cudnn.deterministic = deterministic


def _critic(device):
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ)).to(device).eval()


def _frames(n, seed, device):
    frames, gt = generate_frames(n, seed=seed)
    return frames, gt, torch.from_numpy(frames).to(device).float().permute(0, 3, 1, 2) / 255.0


def _parts(critic, x, opts):
    """The stage's parts run eagerly, as a signature's first call runs them."""
    smooth = opts.get("smooth_sigma", 1.5 if opts["method"] == "gradient" else 0.0)
    options = dict(smooth_sigma=smooth, logits=False, noise=0.0, method=opts["method"],
                   cam_block=opts.get("cam_block", 1),
                   cam_upsample=opts.get("cam_upsample", "lanczos3"),
                   tta_flip=opts["tta_flip"], tta_shift=opts["tta_shift"])
    with torch.enable_grad(), saliency.no_tf32():
        preds, sal = saliency._eager(saliency._parts(critic, x.float(), None, **options))
    return preds.detach(), sal.detach()


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("opts", [QUALITY, GRADIENT], ids=["layercam", "gradient"])
def test_replays_are_bitwise_the_eager_parts(card, opts):
    critic = _critic(card)
    _, _, x = _frames(64, 3, card)
    _, _, y = _frames(64, 4, card)
    want_x, want_y = _parts(critic, x, opts), _parts(critic, y, opts)
    calls = [x, x, y, x]  # eager, captured and replayed, replayed, replayed
    for k, frames in enumerate(calls):
        got = saliency.critic_saliency(critic, frames, **opts)
        assert _equal(got, want_y if frames is y else want_x), k
        assert bool(saliency._GRAPHS.captured) == (k >= 1), k


@pytest.mark.card
def test_replay_follows_the_weights_changed_in_place_and_a_second_critic(card):
    critic, other = _critic(card), _critic(card)
    _, _, x = _frames(32, 5, card)
    for _ in range(2):
        saliency.critic_saliency(critic, x, **QUALITY)
    with torch.no_grad():
        critic.convs[2].weight.mul_(1.5)
        critic.fc1.bias.add_(0.25)
    assert _equal(saliency.critic_saliency(critic, x, **QUALITY), _parts(critic, x, QUALITY))
    # another critic's first call runs eagerly and leaves the captured graphs;
    # its second is captured beside them
    captured = dict(saliency._GRAPHS.captured)
    assert _equal(saliency.critic_saliency(other, x, **QUALITY), _parts(other, x, QUALITY))
    assert saliency._GRAPHS.captured == captured
    assert _equal(saliency.critic_saliency(other, x, **QUALITY), _parts(other, x, QUALITY))
    assert len(saliency._GRAPHS.captured) == 2
    assert all(saliency._GRAPHS.captured[k] is v for k, v in captured.items())
    assert _equal(saliency.critic_saliency(critic, x, **QUALITY), _parts(critic, x, QUALITY))


def test_an_episodes_chunks_and_its_tail_are_each_captured_once(monkeypatch):
    """The bookkeeping of ``_SaliencyGraphs`` on the CPU, the capture and the
    eager stage stood in for: over episodes of four full chunks and a
    shorter tail, each signature runs eagerly at its first call, is captured
    at its second and replays from then on, so that from the third episode
    on nothing but replays runs; beyond ``_KEPT`` signatures the oldest
    graphs go first."""
    events = []

    class Captured:
        def __init__(self, critic, x, options):
            events.append(("capture", x.shape[0]))

        def replay(self, x):
            events.append(("replay", x.shape[0]))
            return x

    monkeypatch.setattr(saliency, "_Captured", Captured)
    monkeypatch.setattr(saliency, "_parts", lambda critic, x, z, **options: x.shape[0])
    monkeypatch.setattr(saliency, "_eager", lambda n: events.append(("eager", n)))
    graphs, critic = saliency._SaliencyGraphs(), torch.nn.Linear(2, 2)

    def episode(*chunks):
        del events[:]
        for n in chunks:
            graphs(critic, torch.zeros(n, 3, 4, 4), dict(QUALITY))
        return list(events)

    full = (8, 8, 8, 8, 5)
    assert episode(*full) == [("eager", 8), ("capture", 8), ("replay", 8), ("replay", 8),
                              ("replay", 8), ("eager", 5)]
    assert episode(*full) == [("replay", 8)] * 4 + [("capture", 5), ("replay", 5)]
    assert episode(*full) == [("replay", 8)] * 4 + [("replay", 5)]
    for n in (1, 2, 3):  # three more signatures: the oldest, the full chunk's, goes
        episode(n, n)
    assert len(graphs.captured) == saliency._KEPT
    assert episode(5, 8, 8) == [("replay", 5), ("eager", 8), ("capture", 8), ("replay", 8)]


def _episode(critic, frames, gt, device, batch_size=128):
    return eval_episode(None, critic, frames, gt, device=device, threshold=64, run_crf=False,
                        batch_size=batch_size, mask_source="saliency", saliency_opts=QUALITY)


@pytest.mark.card
def test_eval_episode_is_bitwise_the_eager_stage_and_counts_its_views(card, monkeypatch):
    critic = _critic(card)
    frames, gt, _ = _frames(300, 6, card)  # three chunks of 128: eager, captured, replayed
    counts, results = [], []
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(saliency, "_GRAPHS",
                                lambda c, x, options: saliency._eager(
                                    saliency._parts(c, x, None, **options)))
        saliency.reset_views()
        results.append([_episode(critic, frames, gt, card) for _ in range(2)])
        counts.append(dict(saliency.VIEWS))
    assert counts[0] == counts[1] == {"views": 36, "backward": 36}
    for got, want in zip(*results):
        for field in ("preds", "diff_u8", "thr_masks"):
            assert torch.equal(torch.from_numpy(getattr(got, field)),
                               torch.from_numpy(getattr(want, field))), field
        assert got.thr_iou == want.thr_iou


@pytest.mark.card
def test_replayed_parts_launch_inside_their_spans(card):
    critic = _critic(card)
    frames, gt, _ = _frames(256, 7, card)
    _episode(critic, frames, gt, card)  # every chunk's signature captured
    assert saliency._GRAPHS.captured
    with tracing.capture("saliency-graphs") as box:
        _episode(critic, frames, gt, card)
    trace = box["trace"]
    per_part = {name: spans.ops(trace, name) for name in PARTS}
    # two chunks: six views and six upsamples each, five combines
    assert {k: len(v) for k, v in per_part.items()} == {
        "saliency.view": 12, "saliency.upsample": 12, "saliency.combine": 10}
    assert all(found for v in per_part.values() for found in v)
    inside = sum(len(found) for v in per_part.values() for found in v)
    stage = sum(len(found) for found in spans.ops(trace, "video.device_stage"))
    assert inside > 0.9 * stage


@pytest.mark.card
def test_the_first_capture_is_a_set_up_span_inside_the_first_call(card, monkeypatch):
    """In a process's first ``eval_episode`` the second chunk's capture is
    the set-up span ``setup.capture`` keyed by the frames' shape, its parent
    the call's ``setup.first_call``; a later call's capture of another
    shape (chunks of 64) is one too, inside nothing; a capture of a shape
    met before (a second critic's) records nothing."""
    monkeypatch.setattr(profiling, "SETUP_SPANS", [])
    monkeypatch.setattr(profiling, "_SEEN", set())
    # chunks of 128: eager, captured, and the tail padded to 128, replayed
    frames, gt, _ = _frames(300, 8, card)
    first, second = _critic(card), _critic(card)
    for critic, batch in ((first, 128), (first, 64), (second, 128)):
        _episode(critic, frames, gt, card, batch)
    assert len(saliency._GRAPHS.captured) == 3
    got = [(s.name, s.key.split("x")[0], s.parent) for s in profiling.SETUP_SPANS]
    assert got == [("setup.first_call", "video.episode", None),
                   ("setup.capture", "saliency:128", 0),
                   ("setup.capture", "saliency:64", None)]
    call, wide, narrow = profiling.SETUP_SPANS
    assert call.start_ns < wide.start_ns < wide.end_ns < call.end_ns < narrow.start_ns
    assert wide.key.split("x")[1:] == narrow.key.split("x")[1:]
