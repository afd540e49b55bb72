"""Premises of the symmetric-tile build that kernels B2, B3 and B5 share
(csrc/bilateral_tile.cuh), checked on their plain versions on the CPU: K
and the stored matrices are bitwise symmetric, so one exp serves M[i, j] and
M[j, i]; row sums taken as 64-column tile partials, summed in slot order
(B2, B5) or in any order (B3's integers), stand in for the plain row sums;
and the wrappers' scratch is what their byte counts say. The kernels
themselves are held to the same bars on the card by chip_smoke.py (phases
4, 5 and 7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.crf.fused_build import build_kernel_i8 as jax_build_i8

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.device import _EPS_NORM, _spatial_taps
from critic_vae_tpu_torch.crf.fused_build import (
    B2_PLANES,
    TILE,
    bilateral_k,
    build_bilateral,
    build_bilateral_reference,
    build_kernel_i8,
    build_kernel_i8_reference,
    build_scratch,
    feature_planes,
    row_sum_slots,
)
from critic_vae_tpu_torch.crf.fused_resident import (
    B5_PLANES,
    _q_lanes,
    _workspace,
    mean_field_resident_reference,
    resident_matrix_reference,
    workspace_bytes,
)

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

W1, ALPHA, BETA, W2, GAMMA, ITERS = REFERENCE_CRF_PARAMS
SHAPES = [(64, 64), (12, 20)]  # a whole number of 64-pixel tiles, and a ragged 240


def _frames(c, h, w, seed):
    """(c, h*w, 3) uint8 frames of random colours: every colour difference
    occurs, so no entry is symmetric by accident of a flat image."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (c, h * w, 3), dtype=np.uint8))


def _bf16_ulps(x, y) -> int:
    return (x.view(torch.int16).int() - y.view(torch.int16).int()).abs().max().item()


@pytest.mark.parametrize("h, w", SHAPES)
def test_bilateral_k_is_bitwise_symmetric(h, w):
    for _, k in bilateral_k(_frames(2, h, w, 1), ALPHA, BETA, h=h, w=w):
        assert torch.equal(k, k.T)
        assert (torch.diagonal(k) == 0).all() and k.sum() > 0


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h, w", SHAPES)
def test_plain_b2_matrix_is_bitwise_symmetric(h, w, out_dtype):
    m = build_bilateral_reference(_frames(2, h, w, 2), W1, ALPHA, BETA, h=h, w=w,
                                  out_dtype=out_dtype)
    assert torch.equal(m, m.transpose(1, 2))
    assert torch.equal(m, build_bilateral(_frames(2, h, w, 2), W1, ALPHA, BETA, h=h, w=w,
                                          out_dtype=out_dtype))  # CPU: the plain version


@pytest.mark.parametrize("h, w", SHAPES)
def test_plain_b5_matrix_is_bitwise_symmetric(h, w):
    taps = torch.from_numpy(_spatial_taps(GAMMA, h, w))
    for _, m in resident_matrix_reference(_frames(2, h, w, 3), taps, W1, W2, ALPHA, BETA, GAMMA,
                                          h=h, w=w):
        assert torch.equal(m, m.T)
        assert (torch.diagonal(m) == 0).all()
        assert torch.equal(m, m.to(torch.bfloat16).float())  # bf16 values


def test_resident_matrix_is_what_the_mean_field_iterates():
    h = w = 12
    imgs, taps = _frames(1, h, w, 4), torch.from_numpy(_spatial_taps(GAMMA, h, w))
    p = np.random.default_rng(4).random((1, h * w, 1)).astype(np.float32)
    probs = torch.from_numpy(np.concatenate([1.0 - p, p], axis=-1))
    (_, m), = resident_matrix_reference(imgs, taps, W1, W2, ALPHA, BETA, GAMMA, h=h, w=w)
    unary = -torch.log(torch.clamp_min(probs[0], 1e-8))
    q = torch.sigmoid(-unary + unary.flip(-1))
    q = torch.sigmoid((m @ q.to(torch.bfloat16).float() - unary)
                      - (m @ q.to(torch.bfloat16).float() - unary).flip(-1))
    got = mean_field_resident_reference(imgs, probs, taps, W1, W2, ALPHA, BETA, GAMMA, h=h,
                                        w=w, iters=1)
    assert torch.equal(got[0], q)


def _tiled_row_sums(k):
    """Row sums as the kernel's scratch holds them: one partial a 64-column
    tile (slot), the slots then summed in order."""
    n = k.shape[1]
    total = torch.zeros(n, dtype=torch.float32)
    for s in range(row_sum_slots(n)):
        total = total + k[:, s * TILE:(s + 1) * TILE].sum(dim=1)
    return total


@pytest.mark.parametrize("h, w", SHAPES)
def test_tiled_row_sums_stand_in_for_the_plain_ones(h, w):
    imgs = _frames(2, h, w, 5)
    want = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=h, w=w, out_dtype="bfloat16")
    sqrt_w1 = torch.sqrt(torch.tensor(W1, dtype=torch.float32))
    for ci, k in bilateral_k(imgs, ALPHA, BETA, h=h, w=w):
        tiled, plain = _tiled_row_sums(k), k.sum(dim=1)
        # a row whose every entry underflows sums to 0 both ways
        assert ((tiled - plain).abs() <= 1e-6 * plain).all()
        nb = sqrt_w1 * torch.rsqrt(tiled + _EPS_NORM)
        m = ((nb[:, None] * nb[None, :]) * k).to(torch.bfloat16)
        assert _bf16_ulps(m, want[ci]) <= 1


@pytest.mark.parametrize("n, planes", [(4096, B2_PLANES), (2500, B2_PLANES), (400, B5_PLANES)])
def test_build_scratch_is_per_tile(n, planes):
    feat, part = build_scratch(3, n, planes, "meta")
    slots = -(-n // 64)
    assert row_sum_slots(n) == slots and TILE == 64
    assert feat.shape == (3, planes, slots * 64) and feat.dtype == torch.float32
    assert part.shape == (3, slots, n) and part.dtype == torch.float32


@pytest.mark.parametrize("n, lanes", [(4096, 2), (4096, 26), (1024, 130), (400, 6)])
def test_resident_workspace_matches_its_byte_count(n, lanes):
    ws = _workspace(3, n, lanes, "meta")
    total = sum(t.numel() * t.element_size() for t in ws.values())
    assert total + 3 * n * lanes * 4 == workspace_bytes(3, n, lanes)  # + the f32 probs
    # q padded to whole n-tiles of 8 lanes: 2 -> 8, 26 -> 32
    assert ws["qb"].shape == (2, 3, _q_lanes(lanes), n) and _q_lanes(lanes) % 8 == 0
    assert _q_lanes(lanes) - lanes < 8
    assert (_q_lanes(2), _q_lanes(26)) == (8, 32)


@pytest.mark.parametrize("h, w", SHAPES)
def test_plain_b3_k8_is_symmetric_with_exact_tile_sums(h, w):
    """B3's int8 K8 is bitwise symmetric with a zero diagonal, so its row
    partials over the columns of I are the column partials of K8[I, J]; the
    partials are integers, so the 64-column tile partials summed in any order
    give the row sums exactly, and so do the column sums."""
    n = h * w
    k8, rowsum = build_kernel_i8_reference(_frames(2, h, w, 6), ALPHA, BETA, h=h, w=w)
    rng = np.random.default_rng(6)
    for ci in range(2):
        k = k8[ci * n:(ci + 1) * n]
        assert torch.equal(k, k.T) and (torch.diagonal(k) == 0).all() and k.sum() > 0
        parts = [k[:, s * TILE:(s + 1) * TILE].sum(dim=1, dtype=torch.int32).float()
                 for s in range(row_sum_slots(n))]
        want = rowsum[ci * n:(ci + 1) * n, 0]
        assert torch.equal(k.sum(dim=0, dtype=torch.int32).float(), want)  # columns
        for order in (range(len(parts)), reversed(range(len(parts))),
                      rng.permutation(len(parts))):
            total = torch.zeros(n)
            for s in order:
                total = total + parts[s]
            assert torch.equal(total, want)


def test_plain_b3_matches_jax_build_kernel_i8():
    h = w = 16
    imgs = _frames(2, h, w, 7)
    k8_j, rowsum_j = jax_build_i8(jnp.asarray(imgs.numpy()), jnp.float32(ALPHA),
                                  jnp.float32(BETA), h=h, w=w)
    k8, rowsum = build_kernel_i8(imgs, ALPHA, BETA, h=h, w=w)  # CPU: the plain version
    # the JAX package's bar (tests/test_crf_device.py): <= 1 level on < 0.1%
    diff = np.abs(k8.numpy().astype(np.int32) - np.asarray(k8_j).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(rowsum.numpy(), np.asarray(rowsum_j),
                               atol=float(diff.sum(axis=1).max()))


@pytest.mark.parametrize("c, n", [(64, 4096), (4, 400), (4, 1024)])
def test_b3_scratch_is_the_feature_planes(c, n):
    """B3's only scratch: (C, 6, N padded to 64) f32 planes, 1.6 MB a
    64-frame chunk of 64x64 frames."""
    feat = feature_planes(c, n, B2_PLANES, "meta")
    assert feat.shape == (c, 6, -(-n // 64) * 64) and feat.dtype == torch.float32
    assert feat.numel() * feat.element_size() == c * 6 * -(-n // 64) * 64 * 4
    assert build_scratch(c, n, B2_PLANES, "meta")[0].shape == feat.shape  # B2's planes too
