"""Kernel ``mean_field_step`` (crf/mean_field_step.py) on the CPU: its
plain version of one launch against the composition it replaces on a bf16 M
(crf/device.py::_mean_field_loop with ``_matrix_message``: M @ q + w2
``_spatial_message`` - the unaries, then the softmax), its lane groups, the
dispatch rule of ``_mean_field_q``, the plain version of kernel
``spatial_message`` against the composition's spatial message, and the
labels of the entry points when their mean fields take the kernel's
arithmetic. No JAX: the composition is the port's own, held to the JAX
package by tests/test_torch_crf*.py.

On the card (marked ``card``, skipped without one): on B2's M of a seeded
64-frame chunk, one 26-lane call bitwise 13 two-lane calls, for one
iteration and ten, reproducible, and the marginals the step gave when it
computed the spatial message in its own epilogue (their digests); kernel
``spatial_message`` against its plain version at the cell's frames, at
small, wide and edge-clamped ones. The card's machine has no JAX, so the
file runs there without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_mean_field_step.py -m card
"""

import hashlib
import types

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf import device as crf_device
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    _fused_step,
    _matrix_message,
    _mean_field_loop,
    _mean_field_q,
    _spatial_message,
    densecrf_device,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu_torch.crf.fused_build import build_bilateral
from critic_vae_tpu_torch.crf.mean_field_step import (
    MAX_CLASSES,
    lane_groups,
    mean_field_step_reference,
    mean_field_steps,
    spatial_message,
    spatial_message_reference,
)
from critic_vae_tpu_torch.crf.terms import _prologue, _spatial_norm, _spatial_taps
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.kernels import build as kb

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

W1, ALPHA, BETA, W2, GAMMA, ITERS = REFERENCE_CRF_PARAMS
C = 2
# q lies in [0, 1] and z = M @ q + w2 s - U in about [-30, 30] at these
# weights: float32 rounds z to ~2e-6, two summation orders of the 4,096-term
# product and of the 31-tap conv differ by a few such ulps, and the
# softmax's slope (at most 1/2) carries that to q
STEP_ATOL = 5e-6


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


def _inputs(lanes, classes, h, w, seed):
    """A seeded bf16 M of B2's scale (row sums ~ w1) and (C, N, T, L) q and
    unaries of random probabilities."""
    g = torch.Generator().manual_seed(seed)
    n = h * w
    mb = (torch.rand((C, n, n), generator=g) * (2.0 * W1 / n)).to(torch.bfloat16)
    unary, q = _prologue(torch.rand((C, n, lanes // classes, classes), generator=g))
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    return mb, q, unary, _spatial_norm(taps, h, w), taps


@pytest.mark.parametrize("h, w", [(64, 64), (16, 32), (8, 8)])
@pytest.mark.parametrize("lanes, classes", [(2, 2), (3, 3), (26, 2), (130, 2)])
def test_plain_step_is_the_composition(lanes, classes, h, w):
    """One launch's plain version against one iteration of the composition
    on the same bf16 M and q: 64x64 (the cell's frames), 16x32 (31 taps
    clamped to the 16 rows) and 8x8 (the taps cut to the frame); 130 lanes
    take three lane groups."""
    mb, q, unary, ns, taps = _inputs(lanes, classes, h, w, seed=lanes + h)
    n = h * w
    want = _mean_field_loop(_matrix_message(mb), q, unary, ns, taps, W2, h, w, 1)
    want = want.reshape(C, n, lanes)
    got = mean_field_step_reference(mb, q.reshape(C, n, lanes), unary.reshape(C, n, lanes), ns,
                                    taps, W2, h=h, w=w, classes=classes)
    torch.testing.assert_close(got, want, rtol=0.0, atol=STEP_ATOL)
    assert not torch.equal(q.reshape(C, n, lanes), got)  # the step moved q


@pytest.mark.parametrize("lanes, classes, groups", [
    (2, 2, [(0, 2)]),
    (3, 3, [(0, 3)]),
    (26, 2, [(0, 26)]),
    (130, 2, [(0, 64), (64, 128), (128, 130)]),
    (129, 3, [(0, 63), (63, 126), (126, 129)]),
    (128, 64, [(0, 64), (64, 128)]),
])
def test_lane_groups_hold_whole_softmax_groups(lanes, classes, groups):
    assert lane_groups(lanes, classes) == groups
    assert all((l1 - l0) % classes == 0 and l1 - l0 <= MAX_CLASSES for l0, l1 in groups)


def test_ten_plain_steps_follow_the_composition():
    """The whole mean field on the CPU through mean_field_steps (the plain
    version, no launch) against ten iterations of the composition: the
    same labels, marginals within a few float32 roundings a step."""
    h = w = 16
    mb, q, unary, ns, taps = _inputs(26, 2, h, w, seed=5)
    want = _mean_field_loop(_matrix_message(mb), q, unary, ns, taps, W2, h, w, ITERS)
    want = want.reshape(C, h * w, 26)
    kb.reset_launches()
    got = mean_field_steps(mb, q.reshape(C, h * w, 26), unary.reshape(C, h * w, 26), ns, taps,
                           W2, h=h, w=w, classes=2, iters=ITERS)
    assert kb.LAUNCHES["mean_field_step"] == 0
    torch.testing.assert_close(got, want, rtol=0.0, atol=ITERS * STEP_ATOL)
    torch.testing.assert_close(got.unflatten(-1, (13, 2)).argmax(-1),
                               want.unflatten(-1, (13, 2)).argmax(-1), rtol=0, atol=0)


def test_dispatch_follows_m_and_its_device():
    """A bf16 M on the card takes the kernel; a CPU tensor or a float32 M
    the composition (bmm), as does a bf16 M whose rows are no whole 16-byte
    chunks (N % 8 != 0), and B3's message, a function of q."""
    cpu = torch.zeros((1, 8, 8), dtype=torch.bfloat16)
    assert not _fused_step(cpu) and not _fused_step(cpu.float())
    assert not _fused_step(_matrix_message(cpu))

    def card(dtype, n):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(1, n, n))

    assert _fused_step(card(torch.bfloat16, 4096))
    assert not _fused_step(card(torch.float32, 4096))
    assert not _fused_step(card(torch.bfloat16, 625))
    assert kb.LAUNCHES.get("mean_field_step") is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, "message"])
def test_cpu_mean_field_is_the_composition(dtype):
    """On the CPU a bf16 or float32 M, or a message given as a function of q
    (as B3's is), runs the one loop from the prologue's q0."""
    h = w = 16
    mb, _, probs, ns, taps = _inputs(6, 3, h, w, seed=9)
    unary, q = _prologue(probs)
    bilateral = _matrix_message(mb) if dtype == "message" else mb.to(dtype)
    message = _matrix_message(mb if dtype == "message" else mb.to(dtype))
    kb.reset_launches()
    got = _mean_field_q(bilateral, probs, taps, W2, h, w, ITERS)
    assert torch.equal(got, _mean_field_loop(message, q, unary, ns, taps, W2, h, w, ITERS))
    assert kb.LAUNCHES["mean_field_step"] == 0


def test_mean_field_steps_validates():
    h = w = 8
    mb, q, unary, ns, taps = _inputs(4, 2, h, w, seed=1)
    q, unary = q.reshape(C, 64, 4), unary.reshape(C, 64, 4)
    with pytest.raises(ValueError, match="whole groups"):
        mean_field_steps(mb, q, unary, ns, taps, W2, h=h, w=w, classes=3, iters=1)
    with pytest.raises(ValueError, match="whole groups"):
        mean_field_steps(mb, q, unary, ns, taps, W2, h=h, w=w, classes=0, iters=1)
    with pytest.raises(ValueError, match="frames"):
        mean_field_steps(mb, q, unary, ns, taps, W2, h=h, w=4, classes=2, iters=1)
    with pytest.raises(ValueError, match="iters"):
        mean_field_steps(mb, q, unary, ns, taps, W2, h=h, w=w, classes=2, iters=-1)
    with pytest.raises(ValueError, match="q on meta"):
        mean_field_steps(mb, q.to("meta"), unary, ns, taps, W2, h=h, w=w, classes=2, iters=1)
    assert mean_field_steps(mb, q, unary, ns, taps, W2, h=h, w=w, classes=2, iters=0) is q


def _episode():
    frames, gt = generate_frames(5, size=16, seed=11)
    rng = np.random.default_rng(4)
    noisy = gt ^ (rng.random(gt.shape) < 0.1)
    return frames, gt, noisy


def _refine(frames, gt, noisy):
    return refine_masks_device(frames, noisy, build="pallas", frame_chunk=2, device="cpu")


def _multi(frames, gt, noisy):
    return refine_masks_multi_device(frames, np.stack([noisy, gt, noisy ^ gt]), build="pallas",
                                     frame_chunk=4, device="cpu")


def _densecrf(frames, gt, noisy):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(*gt.shape, 3)) + 2.0 * np.stack([~noisy, noisy, gt], axis=-1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return densecrf_device(frames, probs.astype(np.float32), REFERENCE_CRF_PARAMS,
                           build="pallas", compute_dtype="bfloat16", device="cpu")


@pytest.mark.parametrize("entry", [_refine, _multi, _densecrf])
def test_entry_point_labels_unchanged_by_the_kernels_arithmetic(entry, monkeypatch):
    """refine_masks_device, refine_masks_multi_device (3 mask sets) and
    densecrf_device (L = 3) on the CPU with B2's bf16 M: their labels, and
    the same with every mean field sent down the kernel's path (its plain
    version on the CPU), are equal."""
    episode = _episode()
    want = entry(*episode)
    monkeypatch.setattr(crf_device, "_fused_step", lambda mb: True)
    kb.reset_launches()
    got = entry(*episode)
    assert kb.LAUNCHES["mean_field_step"] == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h, w, lanes, gamma", [
    (64, 64, 26, GAMMA),  # the sweep's frames: 31 taps
    (16, 32, 2, GAMMA),   # the taps clamped to the 16 rows
    (8, 8, 3, GAMMA),     # the taps cut to the frame on both axes
    (12, 40, 2, 6.0),     # radius 39: every tap reaches out of the frame
])
def test_plain_spatial_message_is_the_compositions(h, w, lanes, gamma):
    """:func:`spatial_message_reference` on lane-major y = n_s * q against
    the composition's ``_spatial_message`` of the same q (cuDNN's depthwise
    conv on the CPU): the tap sums in another order, a few float32 roundings
    apart."""
    taps = torch.from_numpy(_spatial_taps(gamma, h, w))
    ns = _spatial_norm(taps, h, w)
    q = torch.rand((C, h * w, lanes), generator=torch.Generator().manual_seed(h + lanes))
    y = (ns.reshape(1, -1, 1) * q).transpose(1, 2).contiguous()
    got = spatial_message_reference(y, ns, taps, h, w).transpose(1, 2)
    torch.testing.assert_close(got, _spatial_message(q, ns, taps, h, w), rtol=0.0,
                               atol=STEP_ATOL)


def test_spatial_message_on_the_cpu_is_its_plain_version():
    h, w = 16, 32
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    ns = _spatial_norm(taps, h, w)
    y = torch.rand((C, 5, h * w), generator=torch.Generator().manual_seed(3))
    kb.reset_launches()
    got = spatial_message(y, ns, taps, h=h, w=w)
    assert torch.equal(got, spatial_message_reference(y, ns, taps, h, w))
    assert kb.LAUNCHES["spatial_message"] == 0
    with pytest.raises(ValueError, match="no 16x16 frames"):
        spatial_message(y, ns, taps, h=h, w=16)


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels mean_field_step and spatial_message run only "
                    "there")
    return torch.device("cuda")


def _chunk_on_card(dev, lanes, seed):
    """B2's bf16 M of a seeded 64-frame chunk of 64x64 frames, with the q0
    and unaries of ``lanes // 2`` noisy masks of each frame."""
    frames, gt = generate_frames(64, size=64, seed=seed)
    n = 64 * 64
    mb = build_bilateral(torch.from_numpy(frames.reshape(64, n, 3)).to(dev), W1, ALPHA, BETA,
                         h=64, w=64)
    rng = np.random.default_rng(seed)
    masks = np.stack([gt ^ (rng.random(gt.shape) < r) for r in np.linspace(0.02, 0.3,
                                                                           lanes // 2)], -1)
    m = torch.from_numpy(masks.reshape(64, n, lanes // 2).astype(np.float32)).to(dev)
    probs = torch.stack([1.0 - m, m], dim=-1).clamp(0.05, 0.95)
    unary, q = _prologue(probs)
    taps = torch.from_numpy(_spatial_taps(GAMMA, 64, 64)).to(dev)
    return mb, q.reshape(64, n, lanes), unary.reshape(64, n, lanes), taps


# sha256 of the marginals' bytes below, as the step gave them when it summed
# the spatial message in its own epilogue (4 staging rounds a block at 26
# lanes, one at 2)
_EPILOGUE_DIGESTS = {
    1: "76a441f48b5ec82f0609d3f43f08f6a3f1e005e279e1cfa6f829b7c06b58ad8e",
    ITERS: "ada1a5da19f912e7987886a8ae8a737dd37106db5da5fcc8a6997d26b5326c8a",
}


@pytest.mark.card
@pytest.mark.parametrize("iters", [1, ITERS])
def test_26_lanes_are_bitwise_13_pairs_and_the_epilogues_marginals(card, iters):
    """The sweep's 26 lanes and each of their 13 (neg, pos) pairs alone
    (P = 2, ``video-crf``'s lanes): the lanes do not mix, so the marginals
    are the same bits; two 26-lane runs too; and the same bits as when the
    step computed the spatial message in its epilogue. ``spatial_message``
    launches once an iteration a call."""
    mb, q, unary, taps = _chunk_on_card(card, 26, seed=24)
    ns = _spatial_norm(taps, 64, 64)

    def run(lanes):
        return mean_field_steps(mb, q[..., lanes], unary[..., lanes].contiguous(), ns, taps, W2,
                                h=64, w=64, classes=2, iters=iters)

    kb.reset_launches()
    got = run(slice(0, 26))
    assert kb.LAUNCHES["spatial_message"] == iters
    assert kb.LAUNCHES["mean_field_step"] == iters
    again = run(slice(0, 26))
    kb.reset_launches()
    pairs = torch.cat([run(slice(2 * t, 2 * t + 2)) for t in range(13)], dim=-1)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["spatial_message"] == 13 * iters
    assert kb.LAUNCHES["mean_field_step"] == 13 * iters
    assert torch.equal(got, pairs)
    assert torch.equal(got, again)
    assert not torch.equal(got, q)
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == _EPILOGUE_DIGESTS[iters]


@pytest.mark.card
@pytest.mark.parametrize("h, w, lanes, gamma", [
    (64, 64, 26, GAMMA),       # the sweep's chunk: one band a lane
    (20, 20, 3, GAMMA),        # taps clamped to the frame on both axes
    (32, 512, 2, GAMMA),       # bands of 16 rows
    (8, 5376, 2, GAMMA),       # a wide frame: bands of 5 rows
    (24, 40, 2, 6.0),          # radius 39 > the frame: every tap reaches out
])
def test_spatial_kernel_is_its_plain_version(card, h, w, lanes, gamma):
    """Kernel ``spatial_message`` against :func:`spatial_message_reference`:
    the kernel's FMAs against the plain version's products and adds differ
    by a few float32 roundings of the 2 (2 radius + 1) terms (STEP_ATOL);
    two launches are the same bits."""
    g = torch.Generator().manual_seed(h + w)
    taps = torch.from_numpy(_spatial_taps(gamma, h, w)).to(card)
    ns = _spatial_norm(taps, h, w)
    y = (torch.rand((3, lanes, h * w), generator=g) * 0.5).to(card) * ns.reshape(1, 1, -1)
    got = spatial_message(y, ns, taps, h=h, w=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, spatial_message_reference(y, ns, taps, h, w), rtol=0.0,
                               atol=STEP_ATOL)
    assert torch.equal(got, spatial_message(y, ns, taps, h=h, w=w))
