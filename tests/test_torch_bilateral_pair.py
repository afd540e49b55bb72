"""Kernel B2's pair (crf/fused_build.py::BilateralPair): the unnormalized
bilateral kernel K and its normalizers g, whose product M = g g^T K is the
normalized matrix that B2 stored before, and whose message g * (K @ (g q))
is M @ q.

On the CPU: the plain pair against the normalized M's formula, bitwise in
float32; the pair's message against the matrix's, to bf16 rounding; a
normalized M run as the pair (M, 1) is the step it was. On the card (marked
``card``, skipped without one): B2's K and g against the plain pair at B2's
bars and bitwise from one launch to the next; g bitwise the nb of B5's
row-sum and norm passes at bf16 (the same sums in the same order); a
``bilateral_build`` span holding three kernels, none of them
``tile_rowsum``; and B5's marginals bitwise those of the build before B2's
passes were merged (their digests). The file imports no JAX, so it runs on
the card's machine without tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_bilateral_pair.py -m card
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf import fused_resident
from critic_vae_tpu_torch.crf.device import _matrix_message, _pair_message
from critic_vae_tpu_torch.crf.fused_build import (
    BilateralPair,
    bilateral_k,
    build_bilateral,
    build_bilateral_reference,
)
from critic_vae_tpu_torch.crf.fused_resident import mean_field_resident
from critic_vae_tpu_torch.crf.mean_field_step import (
    lane_groups,
    mean_field_step_reference,
    spatial_message_reference,
)
from critic_vae_tpu_torch.crf.terms import _EPS_NORM, _prologue, _spatial_norm, _spatial_taps
from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.kernels import build as kb

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import tracing  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

W1, ALPHA, BETA, W2, GAMMA, ITERS = REFERENCE_CRF_PARAMS
SHAPES = [(16, 16), (12, 20)]  # whole 64-pixel tiles, and a ragged 240


def _frames(c, h, w, seed):
    """(c, h*w, 3) uint8 frames of random colours."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (c, h * w, 3), dtype=np.uint8))


def _normalized(pair):
    """M = g g^T K of a pair, in float32."""
    return pair.g[:, :, None] * pair.g[:, None, :] * pair.k.float()


@pytest.mark.parametrize("h, w", SHAPES)
def test_plain_pair_is_the_normalized_matrix(h, w):
    """g is sqrt(w1) rsqrt(rowsum + eps) of bilateral_k, K its kernel with
    the diagonal 0 (in bf16, its values rounded), and g g^T K in float32 is
    bitwise the normalized M that the plain version of B2 stored."""
    imgs = _frames(2, h, w, 1)
    f32 = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=h, w=w, out_dtype="float32")
    bf16 = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=h, w=w, out_dtype="bfloat16")
    sqrt_w1 = torch.sqrt(torch.tensor(W1, dtype=torch.float32))
    for ci, k in bilateral_k(imgs, ALPHA, BETA, h=h, w=w):
        nvec = sqrt_w1 * torch.rsqrt(k.sum(dim=1) + _EPS_NORM)
        m = (nvec[:, None] * nvec[None, :]) * k
        assert torch.equal(f32.g[ci], nvec) and torch.equal(bf16.g[ci], nvec)
        assert torch.equal(f32.k[ci], k) and torch.equal(bf16.k[ci], k.to(torch.bfloat16))
        assert torch.equal(_normalized(f32)[ci], m)
    assert (torch.diagonal(bf16.k, dim1=1, dim2=2) == 0).all()
    assert bf16.g.dtype == torch.float32 and bf16.g.shape == (2, h * w)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_pair_message_is_the_matrix_message(out_dtype):
    """g * (K @ (g q)) against M @ q of the float32 M = g g^T K: float32
    rounding for a float32 K; for a bf16 K the product takes bf16(g q),
    within 2^-8 of g q relative, so the message is within 2^-8 of |M| @ |q|
    (plus float32 rounding)."""
    h, w = 12, 20
    pair = build_bilateral_reference(_frames(2, h, w, 3), W1, ALPHA, BETA, h=h, w=w,
                                     out_dtype=out_dtype)
    q = torch.rand((2, h * w, 6), generator=torch.Generator().manual_seed(3))
    m = _normalized(pair)
    got, want = _pair_message(pair)(q), _matrix_message(m)(q)
    scale = torch.bmm(m.abs(), q.abs())
    rel = 2.0 ** -8 if out_dtype == "bfloat16" else 0.0
    assert ((got - want).abs() <= rel * scale + 1e-5 * scale + 1e-30).all()
    if out_dtype == "bfloat16":
        assert not torch.equal(got, want)  # the rounding of g q shows


def test_a_normalized_matrix_runs_as_the_pair_with_unit_normalizers():
    """The ``xla`` build's M takes the step as the pair (M, 1): g q and g
    times the product are exact, so one launch's plain version is the old
    formula's bits, bf16(q) in the product."""
    h = w = 8
    n = h * w
    gen = torch.Generator().manual_seed(4)
    mb = (torch.rand((2, n, n), generator=gen) * (2.0 * W1 / n)).to(torch.bfloat16)
    unary, q = _prologue(torch.rand((2, n, 3, 2), generator=gen))
    q, unary = q.reshape(2, n, 6), unary.reshape(2, n, 6)
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    ns = _spatial_norm(taps, h, w)
    got = mean_field_step_reference(BilateralPair(mb, torch.ones((2, n))), q, unary, ns, taps,
                                    W2, h=h, w=w, classes=2)
    y = (ns.reshape(1, n, 1) * q).transpose(1, 2)
    sp = spatial_message_reference(y, ns, taps, h, w).transpose(1, 2)
    want = torch.empty_like(q)
    for l0, l1 in lane_groups(6, 2):
        z = (torch.bmm(mb.float(), q.to(torch.bfloat16).float()[..., l0:l1])
             + W2 * sp[..., l0:l1] - unary[..., l0:l1])
        want[..., l0:l1] = torch.softmax(z.unflatten(-1, (-1, 2)), dim=-1).flatten(-2)
    assert torch.equal(got, want)


def test_cpu_build_is_the_plain_pair_and_launches_nothing():
    imgs = _frames(3, 12, 20, 5)
    kb.reset_launches()
    got = build_bilateral(imgs, W1, ALPHA, BETA, h=12, w=20)
    want = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=12, w=20)
    assert isinstance(got, BilateralPair)
    assert torch.equal(got.k, want.k) and torch.equal(got.g, want.g)
    assert got.k.dtype == torch.bfloat16 and got.g.dtype == torch.float32
    assert kb.LAUNCHES["bilateral_build"] == 0


# --- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels B2 and B5 run only there")
    return torch.device("cuda")


def _synthetic(c, side, seed, dev):
    frames, _ = generate_frames(c, size=side, seed=seed)
    return torch.from_numpy(frames.reshape(c, side * side, 3)).to(dev)


def _bf16_ulps(x, y) -> int:
    return (x.view(torch.int16).int() - y.view(torch.int16).int()).abs().max().item()


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [64, 50])  # N = 4096, and a ragged 2500
def test_b2_pair_is_its_plain_version(card, side, out_dtype):
    """B2's K and g against the plain pair at B2's bars: a float32 K within
    1e-5 relative on entries > 1e-3, a bf16 K within one ulp, g within 1e-5
    relative (the row sums in another order); the diagonal exactly 0, K
    bitwise symmetric, and two launches the same bits."""
    imgs = _synthetic(4, side, 1, card)
    kw = dict(h=side, w=side, out_dtype=out_dtype)
    got = build_bilateral(imgs, W1, ALPHA, BETA, **kw)
    want = build_bilateral_reference(imgs, W1, ALPHA, BETA, **kw)
    again = build_bilateral(imgs, W1, ALPHA, BETA, **kw)
    torch.cuda.synchronize()
    if out_dtype == "float32":
        sig = want.k.abs() > 1e-3
        assert sig.sum() > 1000
        assert ((got.k - want.k).abs()[sig] / want.k.abs()[sig]).max().item() <= 1e-5
    else:
        assert _bf16_ulps(got.k, want.k) <= 1
    assert ((got.g - want.g).abs() / want.g).max().item() <= 1e-5
    assert torch.diagonal(got.k, dim1=1, dim2=2).abs().max().item() == 0.0
    assert torch.equal(got.k, got.k.transpose(1, 2))
    assert torch.equal(got.k, again.k) and torch.equal(got.g, again.g)


@pytest.mark.card
@pytest.mark.parametrize("side", [64, 20])  # N = 4096, and a ragged 400
def test_b2_g_is_bitwise_the_nb_of_b5s_row_sum_pass(card, side, monkeypatch):
    """At bf16 B2's summing store adds each entry into its partials in the
    order of the row-sum pass that B5 keeps, and reduces them alike, so its
    g is bitwise the nb plane that B5's build leaves in its workspace."""
    imgs = _synthetic(4, side, 2, card)
    n = side * side
    spaces = []
    workspace = fused_resident._workspace

    def spy(*args):
        spaces.append(workspace(*args))
        return spaces[-1]

    monkeypatch.setattr(fused_resident, "_workspace", spy)
    probs = torch.full((4, n, 2), 0.5, device=card)
    taps = torch.from_numpy(_spatial_taps(GAMMA, side, side)).to(card)
    mean_field_resident(imgs, probs, taps, W1, W2, ALPHA, BETA, GAMMA, h=side, w=side, iters=0)
    pair = build_bilateral(imgs, W1, ALPHA, BETA, h=side, w=side, out_dtype="bfloat16")
    torch.cuda.synchronize()
    nb = spaces[0]["feat"][:, 5, :n]  # the plane after x, y, r, g, b
    assert torch.equal(pair.g, nb)


B2_KERNELS = ("tile_feats_kernel", "tile_store_kernel", "tile_norm_kernel")


@pytest.mark.card
def test_a_bilateral_build_span_holds_three_kernels(card):
    """Launches of B2 under the profiler: each ``bilateral_build`` span holds
    the features, the summing store and the norm, once each, and no row-sum
    pass. The profiler drops a kernel's record now and then (device.py's
    device_ms says so; one card run here kept only the norm of a launch), so
    of five launches every span holds no kernel but these three and one
    holds all three."""
    imgs = _synthetic(8, 64, 3, card)
    build_bilateral(imgs, W1, ALPHA, BETA, h=64, w=64)  # the library loaded
    torch.cuda.synchronize()
    with tracing.capture("b2-pair") as box:
        for _ in range(5):
            build_bilateral(imgs, W1, ALPHA, BETA, h=64, w=64)
    launches = box["trace"].span_kernels("bilateral_build")
    assert len(launches) == 5
    kinds = [sorted(next((k for k in B2_KERNELS if k in d[0]), d[0]) for d in ops)
             for ops in launches]
    assert all(set(k) <= set(B2_KERNELS) and len(k) == len(set(k)) for k in kinds), kinds
    assert sorted(B2_KERNELS) in kinds, kinds
    assert not any("tile_rowsum" in d[0] for ops in launches for d in ops)


def _b5_marginals(dev, t):
    """B5's C = 2 marginals of 64x64 seeded frames with T noisy masks."""
    frames, gt = generate_frames(2, size=64, seed=5)
    n = 64 * 64
    imgs = torch.from_numpy(frames.reshape(2, n, 3)).to(dev)
    rng = np.random.default_rng(5)
    masks = np.stack([gt ^ (rng.random(gt.shape) < r) for r in np.linspace(0.02, 0.3, t)], -1)
    m = torch.from_numpy(masks.reshape(2, n, t).astype(np.float32)).to(dev)
    probs = torch.stack([1.0 - m, m], dim=-1).clamp(0.05, 0.95).reshape(2, n, 2 * t)
    taps = torch.from_numpy(_spatial_taps(GAMMA, 64, 64)).to(dev)
    return mean_field_resident(imgs, probs, taps, W1, W2, ALPHA, BETA, GAMMA, h=64, w=64,
                               iters=ITERS)


# sha256 of _b5_marginals's bytes on the build before B2's passes were merged
# (its four passes, which B5 keeps), read on the card (H100 80GB HBM3)
_B5_DIGESTS = {
    1: "a1695c50afdce6c793cacfb8131efbcb7ac333bb1e0d2e82f3e69527182998f4",
    13: "0934aa58ab8438c19085cf5dd3a63520a834ecabe52f803b8f8f247ac747b75b",
}


@pytest.mark.card
@pytest.mark.parametrize("t", [1, 13])
def test_b5_marginals_are_bitwise_the_parents(card, t):
    got = _b5_marginals(card, t)
    torch.cuda.synchronize()
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == _B5_DIGESTS[t]
