"""The train step's CUDA graph replay (critic_vae_tpu_torch/train/step.py):
what makes a replay compute what an eager step computes, on the CPU (the
state written in place, the decision to replay, MS-SSIM's constants built
once, losses that are the caller's own), and on the card (marked ``card``,
skipped without one) the replayed steps bitwise equal to eager ones under
cuDNN's deterministic algorithms, a resume in the middle of replays, a
new capture when TF32 is turned on, and the first step and each capture
recorded as set-up spans. No JAX here: the card's machine has
none, so the file runs there without tests/conftest.py, which imports it:

    python -m pytest --noconftest tests/test_torch_step_graphs.py -m card
"""

import contextlib

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.ops import msssim
from critic_vae_tpu_torch.parallel.mesh import Mesh
from critic_vae_tpu_torch.train import step as tstep
from critic_vae_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
LR = 5e-5
GUARD = ("notfinite_count", "last_finite", "total_notfinite", "step")


@pytest.fixture
def critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step replays as CUDA graphs only there")
    return torch.device("cuda")


def _state(device, seed=3, **widths):
    return tstep.init_train_state(*weights.numpy_vae_params(seed, **widths), device=device,
                                  seed=11)


def _frames(n, device, nan_row=None):
    data = torch.from_numpy(generate_frames(n, seed=1)[0]).to(device)
    if nan_row is None:
        return data
    data = data.float() / 255.0
    data[nan_row, 10, 10, 1] = float("nan")
    return data


def _tensors(state):
    """Every tensor of the state: parameters, BN statistics, Adam's moments
    and counts, the guard's counters and the step."""
    vae = state.vae
    return (list(vae.parameters()) + list(vae.buffers()) + state.mu + state.nu + state.counts
            + [getattr(state, k) for k in GUARD])


# ------------------------------------------------------------------ on the CPU


def test_guard_counters_and_step_keep_their_identity(critic):
    """The guard's counters and the step are written in place, on a finite
    step and on a skipped one: a graph holds their addresses."""
    state = _state("cpu", **NARROW)
    before = {k: (getattr(state, k), getattr(state, k).data_ptr()) for k in GUARD}
    step = tstep.make_train_step(critic, learning_rate=LR)
    good, bad = _frames(8, "cpu")[:4], _frames(8, "cpu", nan_row=1)[:4]
    step(state, good)
    step(state, bad)
    for k, (t, ptr) in before.items():
        assert getattr(state, k) is t and t.data_ptr() == ptr, k
    assert (int(state.notfinite_count), bool(state.last_finite), int(state.total_notfinite),
            int(state.step)) == (1, False, 1, 2)


def test_steps_stay_eager_on_the_cpu(critic):
    """No capture and no replay on the CPU, whatever the number of calls of
    one signature, for make_multi_step and make_train_step."""
    before = dict(tstep.GRAPHS)
    state = _state("cpu", **NARROW)
    data = _frames(12, "cpu")
    idx = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    multi = tstep.make_multi_step(critic, learning_rate=LR)
    step = tstep.make_train_step(critic, learning_rate=LR)
    for _ in range(2):
        multi(state, data, idx)
        step(state, data[:4])
    assert tstep.GRAPHS == before
    assert int(state.step) == 8


@pytest.mark.parametrize("device, group, replays", [
    ("cpu", None, False), ("cpu", "group", False), ("cuda", None, True),
    ("cuda", "group", False), ("cuda:0", "none-mesh", True)])
def test_graphed_only_on_cuda_without_a_process_group(device, group, replays):
    """A grouped mesh's collectives stay eager (NCCL is not captured); a
    mesh without a group and no mesh replay on CUDA."""
    mesh = {None: None, "group": Mesh(torch.device(device), 0, 2, group=object()),
            "none-mesh": Mesh(torch.device(device), 0, 1)}[group]
    assert tstep.graphed(device, mesh) is replays


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_msssim_builds_its_constants_once_per_device_and_dtype(dtype):
    """The window and the weights are built once for a (window, device,
    dtype) and equal what each call built before; the loss is bitwise the
    one from constants built afresh."""
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.random((4, 3, 64, 64))).to(dtype) for _ in range(2))
    msssim._constants.cache_clear()
    first = msssim.msssim_loss(a, b)
    k, w = msssim._constants(True, a.device, dtype)
    for _ in range(2):
        assert torch.equal(msssim.msssim_loss(a, b), first)
    assert msssim._constants(True, a.device, dtype)[0] is k
    info = msssim._constants.cache_info()
    assert info.misses == 1 and info.hits >= 3
    assert torch.equal(k, torch.from_numpy(msssim.window_1d(True)).to(dtype))
    assert torch.equal(w, torch.tensor(msssim.WEIGHTS, dtype=dtype))
    # the loss from constants built afresh, as each call built them before
    msssim._constants.cache_clear()
    assert torch.equal(msssim.msssim_loss(a, b), first)
    with torch.inference_mode():
        msssim._constants.cache_clear()
        msssim.msssim_loss(a, b)
    assert not msssim._constants(True, a.device, dtype)[0].is_inference()


@pytest.mark.parametrize("n, dtype", [(4, torch.float32), (4, torch.float64), (5, torch.float32)])
def test_msssim_product_is_torch_prod_bitwise(n, dtype):
    """MS-SSIM's product over its scales, value and gradient, is torch.prod's
    for positive terms (its backward reads nothing back to the host)."""
    x = torch.from_numpy(np.random.default_rng(n).uniform(0.05, 1.0, n)).to(dtype)
    x.requires_grad_(True)
    want = torch.prod(x)
    got = msssim._Prod.apply(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got * 1.7, x)[0], torch.autograd.grad(want * 1.7, x)[0])


def test_returned_losses_are_not_aliased_across_calls(critic):
    state = _state("cpu", **NARROW)
    step = tstep.make_train_step(critic, learning_rate=LR)
    data = _frames(8, "cpu")
    first = step(state, data[:4])
    kept = {k: v.clone() for k, v in first.items()}
    second = step(state, data[4:])
    for k in first:
        assert first[k].data_ptr() != second[k].data_ptr(), k
        assert torch.equal(first[k], kept[k]), k


def test_a_closure_keeps_one_signatures_graphs(monkeypatch):
    """Where steps replay: a signature's first call eager, its second
    captured and replayed, later ones replayed; another signature frees the
    captured graphs before its own capture, and a signature met again after
    it starts eager (the capture stood in for by a recorder, the CPU having
    no graphs)."""
    log = []

    class Captured:
        def __init__(self, phases, state, fixed, varying):
            log.append(("capture", varying["idx"].shape[0]))
            self.n = varying["idx"].shape[0]

        def replay(self, varying):
            log.append(("replay", self.n))

        def __del__(self):
            log.append(("free", self.n))

    def phases(state, source, idx, eps, masks):
        log.append(("eager", idx.shape[0]))
        yield from (None, None, None, {})

    monkeypatch.setattr(tstep, "graphed", lambda device, mesh: True)
    monkeypatch.setattr(tstep, "_Captured", Captured)
    steps = tstep._StepGraphs(phases, None)
    state = tstep.TrainState.__new__(tstep.TrainState)
    state.step = torch.zeros((), dtype=torch.int32)
    source = torch.zeros((8, 2))
    for n in (4, 4, 4, 2, 2, 4, 4):
        steps(state, dict(source=source, masks=None), dict(idx=torch.zeros(n), eps=None))
    assert log == [("eager", 4), ("capture", 4), ("replay", 4), ("replay", 4), ("eager", 2),
                   ("free", 4), ("capture", 2), ("replay", 2), ("eager", 4), ("free", 2),
                   ("capture", 4), ("replay", 4)]


# ------------------------------------------------------------------ on the card


@contextlib.contextmanager
def _deterministic(tf32=False):
    from critic_vae_tpu_torch.device import no_tf32

    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with no_tf32():
            if tf32:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            yield
    finally:
        torch.backends.cudnn.deterministic = flag


def _bits(t):
    """``t`` as its bit patterns, so that NaN equals the same NaN."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _assert_states_equal(a, b):
    for x, y in zip(_tensors(a), _tensors(b)):
        assert _same(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.card
@pytest.mark.parametrize("extra", ["plain", "distill"])
def test_replayed_steps_equal_eager_steps_bitwise(critic, card, extra):
    """Six steps of the graphed ``make_multi_step`` (eager, capture, four
    replays) against six eager steps from one state, a NaN frame in step 4's
    batch: losses, parameters, Adam's moments and counts, BN's statistics,
    the guard's counters and the generator's state bitwise equal; with the
    distillation term its masks gathered in the graph and given draws
    copied in."""
    critic = critic.to(card)
    data = _frames(64, card, nan_row=37)
    rows = [r for r in np.random.default_rng(0).permutation(64) if r != 37][:48]
    idx = torch.from_numpy(np.array(rows, np.int32).reshape(6, 8)).to(card)
    idx[3, 0] = 37  # step 4 alone meets the NaN frame
    options = dict(learning_rate=LR)
    eps = masks = None
    if extra == "distill":
        options["mask_distill"] = 0.5
        masks = (torch.rand((64, 64, 64), generator=torch.Generator(card).manual_seed(2),
                            device=card) > 0.5).float()
        eps = torch.randn((6, 8, 32), generator=torch.Generator(card).manual_seed(5), device=card)
    graphed, eager = _state(card), _state(card)
    phases = tstep._make_local_step(critic, None, **options)
    multi = tstep.make_multi_step(critic, **options)
    before = dict(tstep.GRAPHS)
    with _deterministic():
        got = multi(graphed, data, idx, eps=eps, masks=masks)
        want = [tstep._eager(phases, eager, source=data, idx=idx[k],
                             eps=None if eps is None else eps[k], masks=masks)
                for k in range(6)]
    assert tstep.GRAPHS["captures"] == before["captures"] + 1
    assert tstep.GRAPHS["replays"] == before["replays"] + 5
    for key in got:
        assert _same(got[key], torch.stack([w[key] for w in want])), key
    assert not torch.isfinite(got["total_loss"][3])
    assert int(graphed.total_notfinite) == 1 and int(graphed.step) == 6
    _assert_states_equal(graphed, eager)


@pytest.mark.card
def test_a_resume_between_replays_replays_to_the_same_state(critic, card):
    """state_tree after three steps, three replays, load_state_tree back,
    the same three replays: the same losses and state (the generator's
    ``set_state`` reaches the graph's draws)."""
    critic = critic.to(card)
    data = _frames(64, card)
    idx = torch.from_numpy(np.random.default_rng(1).permutation(64)[:48].reshape(6, 8)
                           .astype(np.int32)).to(card)
    state = _state(card)
    multi = tstep.make_multi_step(critic, learning_rate=LR)
    with _deterministic():
        multi(state, data, idx[:3])
        tree = tstep.state_tree(state)
        first = multi(state, data, idx[3:])
        end = [t.clone() for t in _tensors(state)]
        end_rng = state.generator.get_state()
        tstep.load_state_tree(state, tree)
        again = multi(state, data, idx[3:])
    for key in first:
        assert _same(first[key], again[key]), key
    for x, y in zip(end, _tensors(state)):
        assert _same(x, y)
    assert torch.equal(end_rng, state.generator.get_state())


@pytest.mark.card
def test_turning_tf32_on_between_calls_recaptures(critic, card):
    """A change of the precision flags is a new signature: its first call
    eager, its second captured; turning them back is the first signature
    again, captured anew (a closure keeps one signature's graphs)."""
    critic = critic.to(card)
    data = _frames(32, card)
    idx = torch.arange(32, dtype=torch.int32, device=card).reshape(4, 8)
    state = _state(card)
    step = tstep.make_multi_step(critic, learning_rate=LR)
    counts = []
    for tf32 in (False, True, False):
        with _deterministic(tf32):
            step(state, data, idx[:3] if tf32 else idx[:2])
        counts.append(dict(tstep.GRAPHS))
    assert counts[1]["captures"] == counts[0]["captures"] + 1
    assert counts[1]["replays"] == counts[0]["replays"] + 2
    assert counts[2]["captures"] == counts[1]["captures"] + 1
    assert counts[2]["replays"] == counts[1]["replays"] + 1


@pytest.mark.card
def test_each_capture_is_a_set_up_span_keyed_by_its_shapes(critic, card, monkeypatch):
    """The process's first step is ``setup.first_call`` (key ``train.step``),
    closed after the card ran it; each signature's capture is
    ``setup.capture`` keyed by its per-call inputs' shapes, after it; a
    capture of shapes met before records nothing."""
    monkeypatch.setattr(profiling, "SETUP_SPANS", [])
    monkeypatch.setattr(profiling, "_SEEN", set())
    critic = critic.to(card)
    data = _frames(64, card)
    idx = torch.arange(48, dtype=torch.int32, device=card).reshape(6, 8)
    multi = tstep.make_multi_step(critic, learning_rate=LR)
    state = _state(card)
    before = dict(tstep.GRAPHS)
    multi(state, data, idx[:3])  # eager, captured, replayed
    multi(state, data, idx[3:, :4])  # four rows a step: another signature
    multi(state, data, idx[:3])  # eight again, captured anew
    assert tstep.GRAPHS["captures"] == before["captures"] + 3
    got = [(s.name, s.key, s.parent) for s in profiling.SETUP_SPANS]
    assert got == [("setup.first_call", "train.step", None),
                   ("setup.capture", "train:idx=8", None),
                   ("setup.capture", "train:idx=4", None)]
    call, eight, four = profiling.SETUP_SPANS
    assert call.end_ns < eight.start_ns < eight.end_ns < four.start_ns < four.end_ns
