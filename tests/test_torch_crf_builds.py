"""The port's int8 and resident CRF builds against the JAX package: the
plain versions of kernels B3 (build_kernel_i8), B4 (matvec_i8) and B5
(mean_field_resident) against the Pallas kernels in interpret mode on the
CPU, the refinements that run them, the multi-mask refinement of the
threshold sweep, and the build selection. 16x16 frames (N = 256) unless a
case says 32x32 (N = 1024)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.crf.device import _sep_conv as jax_sep_conv
from critic_vae_tpu.crf.device import refine_masks_device as jax_refine
from critic_vae_tpu.crf.device import refine_masks_multi_device as jax_refine_multi
from critic_vae_tpu.crf.fused_build import build_kernel_i8 as jax_build_i8
from critic_vae_tpu.crf.fused_build import matvec_i8 as jax_matvec_i8
from critic_vae_tpu.crf.fused_resident import mean_field_resident as jax_resident
from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf import device as crf_device
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    _chunk_frames,
    _resolve_build,
    _spatial_norm,
    _spatial_taps,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu_torch.crf.fused_build import (
    QUANT_SCALE,
    build_kernel_i8,
    build_kernel_i8_reference,
    matvec_i8,
)
from critic_vae_tpu_torch.crf.fused_resident import (
    MAX_RESIDENT_N,
    mean_field_resident,
    workspace_bytes,
)
from critic_vae_tpu_torch.kernels import build as kb

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

H = W = 16
W1, ALPHA, BETA, W2, GAMMA, ITERS = REFERENCE_CRF_PARAMS
NEW_KERNELS = ("kernel_i8_build", "matvec_i8", "mean_field_resident")


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


@pytest.fixture(scope="module")
def episode():
    frames, gt = generate_frames(6, size=H, seed=7)
    noisy = gt ^ (np.random.default_rng(2).random(gt.shape) < 0.08)
    return frames, gt, noisy


def _imgs(c, size, seed):
    frames, _ = generate_frames(c, size=size, seed=seed)
    return frames.reshape(c, size * size, 3)


@pytest.mark.parametrize("h, w", [(16, 16), (32, 16), (8, 24), (64, 64)])
def test_spatial_norm_closed_form_matches_jax_conv(h, w):
    # ns as the JAX resident kernel builds it (fused_resident.py): rsqrt of
    # the separable conv of ones, less the centre tap
    taps = _spatial_taps(GAMMA, h, w)
    conv = np.asarray(jax_sep_conv(jnp.ones((h, w, 1)), jnp.asarray(taps))).reshape(-1, 1)
    want = 1.0 / np.sqrt(conv.astype(np.float64) - 1.0 + 1e-20)
    got = _spatial_norm(torch.from_numpy(taps), h, w)
    assert got.shape == (h * w, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("size", [16, 32])
def test_i8_build_plain_matches_pallas(size):
    imgs = _imgs(2, size, 11)
    n = size * size
    k8_j, rowsum_j = jax_build_i8(jnp.asarray(imgs), jnp.float32(ALPHA), jnp.float32(BETA),
                                  h=size, w=size)
    k8, rowsum = build_kernel_i8(torch.from_numpy(imgs), ALPHA, BETA, h=size, w=size)
    assert k8.shape == (2 * n, n) and k8.dtype == torch.int8
    assert rowsum.shape == (2 * n, 1) and rowsum.dtype == torch.float32
    # exp may round differently across libms at a .5 boundary: the JAX
    # package's own bar (tests/test_crf_device.py) is <= 1 level on < 0.1%
    diff = np.abs(k8.numpy().astype(np.int32) - np.asarray(k8_j).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert torch.equal(rowsum, k8.sum(dim=1, keepdim=True, dtype=torch.int32).float())
    np.testing.assert_allclose(rowsum.numpy(), np.asarray(rowsum_j),
                               atol=float(diff.sum(axis=1).max()))
    assert (torch.diagonal(k8.view(2, n, n), dim1=1, dim2=2) == 0).all()
    assert int(k8.max()) <= QUANT_SCALE and int(k8.min()) >= 0


def test_i8_build_rounds_half_to_even_and_row_blocks_do_not_matter():
    imgs = torch.from_numpy(_imgs(2, H, 3))
    a = build_kernel_i8_reference(imgs, ALPHA, BETA, h=H, w=W)
    b = build_kernel_i8_reference(imgs, ALPHA, BETA, h=H, w=W, row_block=37)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # torch.round, like jnp.round and the kernel's rintf, is half-to-even
    assert torch.round(torch.tensor([0.5, 1.5, 2.5])).tolist() == [0.0, 2.0, 2.0]


@pytest.mark.parametrize("lanes", [2, 3])
def test_matvec_i8_plain_matches_pallas(lanes):
    k8, _ = build_kernel_i8(torch.from_numpy(_imgs(3, H, 5)), ALPHA, BETA, h=H, w=W)
    y = np.random.default_rng(lanes).random((3 * H * W, lanes)).astype(np.float32)
    want = np.asarray(jax_matvec_i8(jnp.asarray(k8.numpy()), jnp.asarray(y), n=H * W))
    got = matvec_i8(k8, torch.from_numpy(y), n=H * W)
    assert got.shape == (3 * H * W, lanes) and got.dtype == torch.float32
    # the same products, summed in another f32 order
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5
    # y is rounded to bf16 first, as the JAX package does
    yb = torch.from_numpy(y).to(torch.bfloat16).float()
    assert torch.equal(got, matvec_i8(k8, yb, n=H * W))


def _pair_probs(c, n, t, seed):
    p = np.random.default_rng(seed).random((c, n, t)).astype(np.float32)
    return np.stack([1.0 - p, p], axis=-1).reshape(c, n, 2 * t)


@pytest.mark.parametrize("t,iters,size", [(1, 0, 16), (1, 10, 16), (3, 0, 16), (3, 10, 16),
                                          (1, 10, 32)])
def test_resident_plain_matches_pallas(t, iters, size):
    """Soft random probabilities, so the marginals are far from saturated.
    Measured here: marginals within 1e-6 of the JAX kernel's (the row sums
    stand in for its column sums, and sums run in another order); held to
    1e-4."""
    n = size * size
    imgs, probs = _imgs(2, size, 9), _pair_probs(2, n, t, 4)
    taps = _spatial_taps(GAMMA, size, size)
    want = np.asarray(jax_resident(jnp.asarray(imgs), jnp.asarray(probs), jnp.asarray(taps),
                                   W1, W2, ALPHA, BETA, GAMMA, h=size, w=size, iters=iters))
    got = mean_field_resident(torch.from_numpy(imgs), torch.from_numpy(probs),
                              torch.from_numpy(taps), W1, W2, ALPHA, BETA, GAMMA,
                              h=size, w=size, iters=iters).numpy()
    assert got.shape == (2, n, 2 * t) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4
    labels, labels_j = got[..., 1::2] > got[..., 0::2], want[..., 1::2] > want[..., 0::2]
    assert np.mean(labels == labels_j) >= 0.999
    if iters == 0:  # the clipped input distribution, renormalized per pair
        pc = np.maximum(probs, 1e-8).reshape(2, n, t, 2)
        np.testing.assert_allclose(got.reshape(2, n, t, 2), pc / pc.sum(-1, keepdims=True),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("build", ["int8", "vmem"])
def test_refine_build_agrees_with_jax_and_b2(episode, build):
    frames, _, noisy = episode
    want = jax_refine(frames, noisy, REFERENCE_CRF_PARAMS, build=build)
    got = refine_masks_device(frames, noisy, build=build, device="cpu")
    f32 = refine_masks_device(frames, noisy, build="pallas", compute_dtype="float32",
                              device="cpu")
    assert got.shape == (6, H, W) and got.dtype == bool
    assert np.mean(got == want) >= 0.999
    assert np.mean(got == f32) >= 0.999
    assert np.mean(got == noisy) < 1.0  # the CRF changed something


@pytest.mark.parametrize("build", ["auto", "int8", "vmem"])
def test_refine_multi_agrees_with_jax_and_sequential(episode, build):
    frames, gt, noisy = episode
    rng = np.random.default_rng(7)
    sets = np.stack([noisy, gt ^ (rng.random(gt.shape) < 0.15), np.zeros_like(gt)])
    want = jax_refine_multi(frames, sets, REFERENCE_CRF_PARAMS, build=build)
    got = refine_masks_multi_device(frames, sets, build=build, device="cpu")
    assert got.shape == sets.shape and got.dtype == bool
    for t in range(len(sets)):
        single = refine_masks_device(frames, sets[t], device="cpu")
        assert np.mean(got[t] == want[t]) >= 0.999, t
        assert np.mean(got[t] == single) >= 0.999, t


def test_refine_multi_device_result_chunks_and_shapes(episode):
    frames, gt, noisy = episode
    sets = np.stack([noisy, gt]).astype(np.uint8)
    host = refine_masks_multi_device(frames, sets, device="cpu")
    dev = refine_masks_multi_device(torch.from_numpy(frames), torch.from_numpy(sets),
                                    frame_chunk=4, fetch=False)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.bool
    np.testing.assert_array_equal(dev.numpy(), host)
    empty = refine_masks_multi_device(frames[:0], sets[:, :0], device="cpu")
    assert empty.shape == (2, 0, H, W)
    with pytest.raises(ValueError):
        refine_masks_multi_device(frames, sets[:, :3], device="cpu")
    if not torch.cuda.is_available():  # numpy without a device goes to the card
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            refine_masks_multi_device(frames, sets, device=None)


@pytest.mark.parametrize("build,h,w,match", [
    ("int8", 10, 10, "divisible by 128"),
    ("vmem", 10, 10, "divisible by 128"),
    ("vmem", 128, 128, "vmem"),
    ("bilateral", 64, 64, "unknown build"),
])
def test_build_validation(build, h, w, match):
    with pytest.raises(ValueError, match=match):
        _resolve_build(build, h, w, "cuda")


def test_build_limits_are_the_jax_packages():
    assert MAX_RESIDENT_N == 4096
    assert _resolve_build("vmem", 64, 64, "cuda") == "vmem"
    assert _resolve_build("int8", 128, 128, "cuda") == "int8"
    with pytest.raises(ValueError, match="divisible by 128"):  # as the JAX package's
        _resolve_build("pallas", 10, 10, "cuda")


def test_build_env_override(episode, monkeypatch):
    frames, _, noisy = episode
    explicit = refine_masks_device(frames[:2], noisy[:2], build="int8", device="cpu")
    monkeypatch.setenv(BUILD_ENV, "int8")
    assert _resolve_build("auto", H, W, "cpu") == "int8"
    kb.reset_launches()
    via_env = refine_masks_device(frames[:2], noisy[:2], device="cpu")
    np.testing.assert_array_equal(via_env, explicit)
    assert all(kb.LAUNCHES[k] == 0 for k in NEW_KERNELS)
    monkeypatch.setenv(BUILD_ENV, "vmem")
    assert _resolve_build("pallas", H, W, "cuda") == "vmem"
    monkeypatch.setenv(BUILD_ENV, "xla")
    np.testing.assert_array_equal(
        refine_masks_device(frames[:2], noisy[:2], device="cpu", build="pallas"),
        refine_masks_device(frames[:2], noisy[:2], device="cpu", build="xla"))


def test_new_kernels_never_launch_on_cpu(episode):
    frames, gt, noisy = episode
    kb.reset_launches()
    for build in ("int8", "vmem"):
        refine_masks_device(frames, noisy, build=build, device="cpu")
        refine_masks_multi_device(frames, np.stack([noisy, gt]), build=build, device="cpu")
    assert kb.LAUNCHES == dict.fromkeys(kb.LAUNCHES, 0)


def test_chunk_caps_follow_the_workspace(monkeypatch):
    n = 64 * 64
    # the 6 GiB budget leaves the default chunk of 64 alone at 64x64
    for fused, multi, dt in [("pallas", False, "float32"), ("int8", False, "float32"),
                             ("int8", True, "float32"), ("vmem", True, "float32")]:
        assert _chunk_frames(64, fused, multi, dt, n, 26) == 64
    monkeypatch.setattr(crf_device, "_MEM_BUDGET", 12 * n * n)
    assert _chunk_frames(64, "pallas", False, "float32", n, 2) == 3
    assert _chunk_frames(64, "pallas", False, "bfloat16", n, 2) == 6
    assert _chunk_frames(64, "int8", False, "float32", n, 2) == 12  # 1 byte an entry
    assert _chunk_frames(64, "int8", True, "float32", n, 26) == 6   # B2 in bf16
    vmem = _chunk_frames(64, "vmem", False, "float32", n, 2)
    assert workspace_bytes(vmem, n, 2) <= 12 * n * n < workspace_bytes(vmem + 1, n, 2)
    monkeypatch.setattr(crf_device, "_MEM_BUDGET", 0)
    assert _chunk_frames(64, "pallas", False, "float32", n, 2) == 1
