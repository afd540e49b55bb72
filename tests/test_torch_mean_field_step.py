"""Kernel ``mean_field_step`` (crf/mean_field_step.py) on the CPU: its
plain version of one launch against the composition it replaces on B2's
pair of a bf16 K and its normalizers g (crf/device.py::_mean_field_loop with
``_pair_message``: g * (K @ (g * q)) + w2 ``_spatial_message`` - the
unaries, then the softmax), its lane groups, the dispatch rule of
``_mean_field_q``, the plain version of kernel ``spatial_message`` against
the composition's spatial message, and the labels of the entry points when
their mean fields take the kernel's arithmetic. No JAX: the composition is
the port's own, held to the JAX package by tests/test_torch_crf*.py.

On the card (marked ``card``, skipped without one): on B2's pair of a
seeded 64-frame chunk, one 26-lane call bitwise 13 two-lane calls, for one
iteration and ten, reproducible, the digests of those marginals, and the
marginals within a stated bar of the float32 composition over the
normalized M; kernel ``spatial_message`` against its plain version at the
cell's frames, at small, wide and edge-clamped ones; the loop's spatial
message from that kernel, in float32, over B3 + B4's message and the
``xla`` build's M. The card's machine has
no JAX, so the file runs there without tests/conftest.py:

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
    _pair_message,
    _mean_field_q,
    _spatial_message,
    densecrf_device,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu_torch.crf.fused_build import BilateralPair, build_bilateral
from critic_vae_tpu_torch.crf.mean_field_step import (
    MAX_CLASSES,
    lane_groups,
    mean_field_step_reference,
    mean_field_steps,
    spatial_message,
    spatial_message_reference,
    spatial_message_takes,
)
from critic_vae_tpu_torch.crf.terms import _prologue, _spatial_norm, _spatial_taps
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.kernels import build as kb

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

W1, ALPHA, BETA, W2, GAMMA, ITERS = REFERENCE_CRF_PARAMS
C = 2
# q lies in [0, 1] and z = g (K @ g q) + w2 s - U in about [-30, 30] at these
# weights: float32 rounds z to ~2e-6, two summation orders of the 4,096-term
# product and of the 31-tap conv differ by a few such ulps, and the
# softmax's slope (at most 1/2) carries that to q
STEP_ATOL = 5e-6


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


def _inputs(lanes, classes, h, w, seed):
    """A seeded pair of a bf16 K in [0, 1) and its normalizers g, as B2's
    (M = g g^T K, row sums ~ w1), and (C, N, T, L) q and unaries of random
    probabilities."""
    gen = torch.Generator().manual_seed(seed)
    n = h * w
    k = torch.rand((C, n, n), generator=gen).to(torch.bfloat16)
    g = torch.sqrt(torch.tensor(W1)) * torch.rsqrt(k.float().sum(dim=2))
    unary, q = _prologue(torch.rand((C, n, lanes // classes, classes), generator=gen))
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    return BilateralPair(k, g), q, unary, _spatial_norm(taps, h, w), taps


@pytest.mark.parametrize("h, w", [(64, 64), (16, 32), (8, 8)])
@pytest.mark.parametrize("lanes, classes", [(2, 2), (3, 3), (26, 2), (130, 2)])
def test_plain_step_is_the_composition(lanes, classes, h, w):
    """One launch's plain version against one iteration of the composition
    on the same bf16 M and q: 64x64 (the cell's frames), 16x32 (31 taps
    clamped to the 16 rows) and 8x8 (the taps cut to the frame); 130 lanes
    take three lane groups."""
    pair, q, unary, ns, taps = _inputs(lanes, classes, h, w, seed=lanes + h)
    n = h * w
    want = _mean_field_loop(_pair_message(pair), q, unary, ns, taps, W2, h, w, 1)
    want = want.reshape(C, n, lanes)
    got = mean_field_step_reference(pair, q.reshape(C, n, lanes), unary.reshape(C, n, lanes),
                                    ns, taps, W2, h=h, w=w, classes=classes)
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
    pair, q, unary, ns, taps = _inputs(26, 2, h, w, seed=5)
    want = _mean_field_loop(_pair_message(pair), q, unary, ns, taps, W2, h, w, ITERS)
    want = want.reshape(C, h * w, 26)
    kb.reset_launches()
    got = mean_field_steps(pair, q.reshape(C, h * w, 26), unary.reshape(C, h * w, 26), ns,
                           taps, W2, h=h, w=w, classes=2, iters=ITERS)
    assert kb.LAUNCHES["mean_field_step"] == 0
    torch.testing.assert_close(got, want, rtol=0.0, atol=ITERS * STEP_ATOL)
    torch.testing.assert_close(got.unflatten(-1, (13, 2)).argmax(-1),
                               want.unflatten(-1, (13, 2)).argmax(-1), rtol=0, atol=0)


def test_dispatch_follows_m_and_its_device():
    """B2's bf16 K on the card, or a bf16 M there, takes the kernel; a CPU
    tensor or a float32 K or M the composition (bmm), as does a bf16 one
    whose rows are no whole 16-byte chunks (N % 8 != 0), and B3's message,
    a function of q."""
    cpu = torch.zeros((1, 8, 8), dtype=torch.bfloat16)
    g = torch.ones((1, 8))
    assert not _fused_step(cpu) and not _fused_step(cpu.float())
    assert not _fused_step(BilateralPair(cpu, g)) and not _fused_step(BilateralPair(cpu.float(), g))
    assert not _fused_step(_matrix_message(cpu))
    assert not _fused_step(_pair_message(BilateralPair(cpu, g)))

    def card(dtype, n):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(1, n, n))

    for wrap in (lambda m: m, lambda m: BilateralPair(m, None)):
        assert _fused_step(wrap(card(torch.bfloat16, 4096)))
        assert not _fused_step(wrap(card(torch.float32, 4096)))
        assert not _fused_step(wrap(card(torch.bfloat16, 625)))
    assert kb.LAUNCHES.get("mean_field_step") is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, "message", "pair"])
def test_cpu_mean_field_is_the_composition(dtype):
    """On the CPU a bf16 or float32 M, a message given as a function of q
    (as B3's is) or B2's pair runs the one loop from the prologue's q0."""
    h = w = 16
    pair, _, probs, ns, taps = _inputs(6, 3, h, w, seed=9)
    unary, q = _prologue(probs)
    mb = (pair.g[:, :, None] * pair.g[:, None, :] * pair.k.float()).to(torch.bfloat16)
    if dtype == "pair":
        bilateral, message = pair, _pair_message(pair)
    else:
        bilateral = _matrix_message(mb) if dtype == "message" else mb.to(dtype)
        message = _matrix_message(mb if dtype == "message" else mb.to(dtype))
    kb.reset_launches()
    got = _mean_field_q(bilateral, probs, taps, W2, h, w, ITERS)
    assert torch.equal(got, _mean_field_loop(message, q, unary, ns, taps, W2, h, w, ITERS))
    assert kb.LAUNCHES["mean_field_step"] == 0


def test_mean_field_steps_validates():
    h = w = 8
    pair, q, unary, ns, taps = _inputs(4, 2, h, w, seed=1)
    q, unary = q.reshape(C, 64, 4), unary.reshape(C, 64, 4)
    with pytest.raises(ValueError, match="whole groups"):
        mean_field_steps(pair, q, unary, ns, taps, W2, h=h, w=w, classes=3, iters=1)
    with pytest.raises(ValueError, match="whole groups"):
        mean_field_steps(pair, q, unary, ns, taps, W2, h=h, w=w, classes=0, iters=1)
    with pytest.raises(ValueError, match="frames"):
        mean_field_steps(pair, q, unary, ns, taps, W2, h=h, w=4, classes=2, iters=1)
    with pytest.raises(ValueError, match="normalizers g"):
        mean_field_steps(BilateralPair(pair.k, pair.g[:, :8]), q, unary, ns, taps, W2, h=h, w=w,
                         classes=2, iters=1)
    with pytest.raises(ValueError, match="iters"):
        mean_field_steps(pair, q, unary, ns, taps, W2, h=h, w=w, classes=2, iters=-1)
    with pytest.raises(ValueError, match="q on meta"):
        mean_field_steps(pair, q.to("meta"), unary, ns, taps, W2, h=h, w=w, classes=2, iters=1)
    assert mean_field_steps(pair, q, unary, ns, taps, W2, h=h, w=w, classes=2, iters=0) is q


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
    densecrf_device (L = 3) on the CPU with B2's bf16 pair: their labels, and
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


@pytest.mark.parametrize("frames, lanes, w, radius, takes", [
    (64, 26, 64, 15, True),      # the cells' chunks
    (3, 2, 5376, 15, True),      # the card test's wide frame: bands of 5 rows
    (1, 2, 30000, 15, False),    # a row of column and row sums past a block's shared memory
    (65536, 2, 64, 15, False),   # frames past the grid's z axis
    (1, 65536, 64, 15, False),   # lanes past its y axis
])
def test_spatial_message_takes_the_shapes_its_entry_checks(frames, lanes, w, radius, takes):
    """``spatial_message_takes``, which decides where the loop's spatial
    message leaves cuDNN's conv for the kernel, says what the C entry of
    csrc/spatial_message.cu accepts."""
    assert spatial_message_takes(frames, lanes, w, radius) is takes


def test_loop_spatial_message_on_the_cpu_is_the_compositions():
    """CPU tensors keep the composition's conv in the loop, so its numbers
    are those it gave before the card's took the kernel."""
    h, w = 16, 32
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    ns = _spatial_norm(taps, h, w)
    q = torch.rand((C, h * w, 6), generator=torch.Generator().manual_seed(4))
    kb.reset_launches()
    assert torch.equal(crf_device._spatial(q, ns, taps, h, w), _spatial_message(q, ns, taps, h, w))
    assert kb.LAUNCHES["spatial_message"] == 0


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels mean_field_step and spatial_message run only "
                    "there")
    return torch.device("cuda")


def _chunk_on_card(dev, lanes, seed):
    """B2's bf16 pair of a seeded 64-frame chunk of 64x64 frames, with the q0
    and unaries of ``lanes // 2`` noisy masks of each frame."""
    frames, gt = generate_frames(64, size=64, seed=seed)
    n = 64 * 64
    pair = build_bilateral(torch.from_numpy(frames.reshape(64, n, 3)).to(dev), W1, ALPHA, BETA,
                           h=64, w=64)
    rng = np.random.default_rng(seed)
    masks = np.stack([gt ^ (rng.random(gt.shape) < r) for r in np.linspace(0.02, 0.3,
                                                                           lanes // 2)], -1)
    m = torch.from_numpy(masks.reshape(64, n, lanes // 2).astype(np.float32)).to(dev)
    probs = torch.stack([1.0 - m, m], dim=-1).clamp(0.05, 0.95)
    unary, q = _prologue(probs)
    taps = torch.from_numpy(_spatial_taps(GAMMA, 64, 64)).to(dev)
    return pair, q.reshape(64, n, lanes), unary.reshape(64, n, lanes), taps


# sha256 of the marginals' bytes below, as the step gives them on B2's pair
# (K and g; M's rounding moved from bf16(g_i g_j K) and bf16(q) to bf16(K)
# and bf16(g q))
_PAIR_DIGESTS = {
    1: "29f1460fe6715f201c8c0dc06a41724a8e4f519c92b94ed71af01e4636080920",
    ITERS: "fae3a7a487bd90f436dce3e4261f70c791e6e0686692db7b26acf85afe93d744",
}
# The marginals against the float32 composition over the normalized M = g
# g^T K (K's bf16 values widened, q never rounded, TF32 off): they differ by
# the bf16 rounding of g q, 2^-9 of each product's weight, which the softmax
# (slope at most 1/2) carries to q; the iterations then draw both towards
# one fixed point. Measured on the card (H100 80GB HBM3): 4.75e-3 after one
# iteration, 1.07e-6 after ten, labels equal at 0.999998 and 1.
COMPOSITION_ATOL = 1e-2
COMPOSITION_LABELS = 0.999


@pytest.mark.card
@pytest.mark.parametrize("iters", [1, ITERS])
def test_26_lanes_are_bitwise_13_pairs_and_the_epilogues_marginals(card, iters):
    """The sweep's 26 lanes and each of their 13 (neg, pos) pairs alone
    (P = 2, ``video-crf``'s lanes): the lanes do not mix, so the marginals
    are the same bits; two 26-lane runs too; their digests; and within
    COMPOSITION_ATOL of the float32 composition over the normalized M, with
    COMPOSITION_LABELS of the labels equal. ``spatial_message`` launches once
    an iteration a call."""
    pair, q, unary, taps = _chunk_on_card(card, 26, seed=24)
    ns = _spatial_norm(taps, 64, 64)

    def run(lanes):
        return mean_field_steps(pair, q[..., lanes], unary[..., lanes].contiguous(), ns, taps,
                                W2, h=64, w=64, classes=2, iters=iters)

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
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == _PAIR_DIGESTS[iters]
    m = pair.g[:, :, None] * pair.g[:, None, :] * pair.k.float()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = _mean_field_loop(_matrix_message(m), q.view(64, -1, 13, 2),
                                unary.view(64, -1, 13, 2), ns, taps, W2, 64, 64, iters)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = want.reshape(got.shape)
    assert (got - want).abs().max().item() <= COMPOSITION_ATOL
    labels = (got[..., 1::2] > got[..., 0::2]) == (want[..., 1::2] > want[..., 0::2])
    assert labels.double().mean().item() >= COMPOSITION_LABELS


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


@pytest.mark.card
@pytest.mark.parametrize("term, size", [("int8", 64), ("float32", 64), ("ragged", 18)])
def test_loop_takes_the_float32_spatial_kernel_on_the_card(card, term, size, monkeypatch):
    """``_mean_field_loop`` on the card, over B3 + B4's message, the ``xla``
    build's float32 M and its bf16 M at N = 324 (N % 8 != 0, no fused
    step): its spatial message comes from kernel ``spatial_message``, one
    launch an iteration, and its marginals hold the plain composition in
    float32 (cuDNN's depthwise conv with TF32 off) to ITERS * STEP_ATOL, the
    spatial sums in two orders a few float32 roundings apart an iteration,
    as ten plain steps hold the composition on the CPU. A TF32 conv (~5e-4
    of each of s's terms) would miss it by an order of magnitude."""
    frames, gt = generate_frames(8, size=size, seed=size + len(term))
    n = size * size
    imgs = torch.from_numpy(frames.reshape(8, n, 3)).to(card)
    if term == "int8":
        message = crf_device._i8_message(imgs, W1, ALPHA, BETA, h=size, w=size)
    else:
        m = crf_device.build_bilateral_xla(imgs, W1, ALPHA, BETA, h=size, w=size,
                                           out_dtype="float32" if term == "float32"
                                           else "bfloat16")
        message = _matrix_message(m)
    rng = np.random.default_rng(size)
    noisy = torch.from_numpy((gt ^ (rng.random(gt.shape) < 0.1)).reshape(8, n, 1, 1)).to(card)
    unary, q = _prologue(torch.cat([1.0 - noisy.float(), noisy.float()], -1).clamp(0.05, 0.95))
    taps = torch.from_numpy(_spatial_taps(GAMMA, size, size)).to(card)
    ns = _spatial_norm(taps, size, size)
    kb.reset_launches()
    got = _mean_field_loop(message, q, unary, ns, taps, W2, size, size, ITERS)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["spatial_message"] == ITERS
    monkeypatch.setattr(crf_device, "_spatial", _spatial_message)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want = _mean_field_loop(message, q, unary, ns, taps, W2, size, size, ITERS)
    assert (got - want).abs().max().item() <= ITERS * STEP_ATOL
