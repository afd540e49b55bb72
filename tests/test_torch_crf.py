"""The port's device CRF (critic_vae_tpu_torch.crf) against the JAX package:
kernel B2's plain version against the Pallas build (interpret mode on the
CPU), and the refinement against both JAX builds. 16x16 frames (N = 256)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic_vae_tpu.crf.device import _resolve_build as jax_resolve_build
from critic_vae_tpu.crf.device import refine_masks_device as jax_refine
from critic_vae_tpu.crf.fused_build import build_bilateral as jax_build
from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf import device as crf_device
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    MEM_ENV,
    _mask_probs,
    _mean_field_iterate_multi,
    _resolve_build,
    _spatial_taps,
    refine_masks_device,
)
from critic_vae_tpu_torch.crf.fused_build import build_bilateral, build_bilateral_reference
from critic_vae_tpu_torch.crf.policy import resolve_crf_backend
from critic_vae_tpu_torch.kernels import build as kb

H = W = 16
W1, ALPHA, BETA = REFERENCE_CRF_PARAMS[:3]


@pytest.fixture(scope="module")
def episode():
    frames, gt = generate_frames(6, size=H, seed=7)
    noisy = gt ^ (np.random.default_rng(2).random(gt.shape) < 0.08)
    return frames, gt, noisy


def _jax_m(imgs, out_dtype):
    return np.asarray(jax_build(jnp.asarray(imgs), jnp.float32(W1), jnp.float32(ALPHA),
                                jnp.float32(BETA), h=H, w=W, out_dtype=out_dtype)
                      .astype(jnp.float32))


def test_build_plain_matches_pallas_f32(episode):
    imgs = episode[0][:3].reshape(3, H * W, 3)
    want = _jax_m(imgs, "float32")
    got = build_bilateral(torch.from_numpy(imgs), W1, ALPHA, BETA, h=H, w=W,
                          out_dtype="float32").numpy()
    assert got.shape == (3, H * W, H * W) and got.dtype == np.float32
    assert np.abs(np.diagonal(got, axis1=1, axis2=2)).max() == 0.0
    sig = np.abs(want) > 1e-3
    assert sig.sum() > 1000
    assert (np.abs(got - want)[sig] / np.abs(want)[sig]).max() <= 1e-5


def test_build_plain_bf16_within_one_ulp_of_pallas(episode):
    imgs = episode[0][:3].reshape(3, H * W, 3)
    want = jnp.asarray(_jax_m(imgs, "bfloat16")).astype(jnp.bfloat16)
    got = build_bilateral(torch.from_numpy(imgs), W1, ALPHA, BETA, h=H, w=W,
                          out_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    bits_t = got.view(torch.int16).numpy().astype(np.int64)
    bits_j = np.asarray(want).view(np.int16).astype(np.int64)
    assert np.abs(bits_t - bits_j).max() <= 1  # M >= 0: bit distance = ulps


def test_build_row_blocks_do_not_change_the_result(episode):
    imgs = torch.from_numpy(episode[0][:2].reshape(2, H * W, 3))
    a = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=H, w=W, out_dtype="float32")
    b = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=H, w=W, out_dtype="float32",
                                  row_block=37)
    assert torch.equal(a, b)


# the reference tuple, and a spatial-heavy one whose smoothing a wrong
# j != i spatial message (the conv's centre tap) would visibly change
SPATIAL_HEAVY = (1.0, 12.0, 3.1, 60.0, 1.8, 5)


@pytest.mark.parametrize("params", [REFERENCE_CRF_PARAMS, SPATIAL_HEAVY],
                         ids=["reference", "spatial_heavy"])
@pytest.mark.parametrize("jax_build_mode", ["pallas", "xla"])
def test_refine_f32_agrees_with_jax(episode, jax_build_mode, params):
    frames, gt, noisy = episode
    want = jax_refine(frames, noisy, params, build=jax_build_mode,
                      compute_dtype="float32")
    got = refine_masks_device(frames, noisy, params, device=torch.device("cpu"))
    assert got.shape == want.shape == (6, H, W) and got.dtype == bool
    assert np.mean(got == want) >= 0.999
    assert np.mean(got == noisy) < 1.0  # the CRF changed something


def test_refine_bf16_matrix_agrees_with_f32(episode):
    frames, _, noisy = episode
    f32 = refine_masks_device(frames, noisy, device="cpu", compute_dtype="float32")
    bf16 = refine_masks_device(frames, noisy, device="cpu", compute_dtype="bfloat16")
    assert np.mean(f32 == bf16) >= 0.999


def test_refine_chunking_padding_and_device_result(episode):
    frames, _, noisy = episode
    whole = refine_masks_device(frames, noisy, device="cpu")
    kb.reset_launches()
    chunked = refine_masks_device(torch.from_numpy(frames), torch.from_numpy(noisy),
                                  frame_chunk=4, fetch=False)
    assert isinstance(chunked, torch.Tensor) and chunked.dtype == torch.bool
    np.testing.assert_array_equal(chunked.numpy(), whole)
    assert kb.LAUNCHES["bilateral_build"] == 0  # CPU tensors never reach the kernel


def test_refine_validates_inputs(episode):
    frames, _, noisy = episode
    with pytest.raises(ValueError):
        refine_masks_device(frames, noisy)  # numpy without a device
    with pytest.raises(ValueError):
        refine_masks_device(frames, noisy[:, :8], device="cpu")
    with pytest.raises(ValueError):
        build_bilateral(torch.zeros((1, 10, 3), dtype=torch.uint8), W1, ALPHA, BETA, h=4, w=4)


@pytest.mark.parametrize("build", ["xla", "int8", "vmem", "pallas"])
def test_unported_builds_raise(build, monkeypatch):
    """Only the Gram-form ``xla`` build is unported; ``pallas`` is B2's
    explicit name, the same as ``auto``."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    if build == "xla":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _resolve_build(build, 64, 64)
    else:
        assert _resolve_build(build, 64, 64) == build
    assert _resolve_build("auto", 64, 64) == "pallas"
    with pytest.raises(ValueError):
        _resolve_build("lattice", 64, 64)


def test_mem_env_caps_the_chunk_without_changing_masks(monkeypatch):
    """``CRITIC_VAE_TPU_CRF_MEM`` is the per-chunk byte budget, as in the JAX
    package (its tests/test_crf_device.py): a budget of one float32 64x64
    matrix gives chunks of one frame and the same masks."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    monkeypatch.delenv(MEM_ENV, raising=False)
    frames, gt = generate_frames(3, seed=5)
    noisy = gt ^ (np.random.default_rng(4).random(gt.shape) < 0.08)
    chunks = []
    chunk_frames = crf_device._chunk_frames

    def spy(*args):
        chunks.append(chunk_frames(*args))
        return chunks[-1]

    monkeypatch.setattr(crf_device, "_chunk_frames", spy)
    whole = refine_masks_device(frames, noisy, device="cpu")
    monkeypatch.setenv(MEM_ENV, str((64 * 64) ** 2 * 4))
    capped = refine_masks_device(frames, noisy, device="cpu")
    assert chunks == [3, 1]
    np.testing.assert_array_equal(capped, whole)


def test_ragged_sizes_take_b2_where_jax_does_not(monkeypatch):
    """ROADMAP C.3, pinned until the ``xla`` build is ported (A.7): at H*W %
    128 != 0 the JAX package raises for ``pallas`` and runs ``xla`` for
    ``auto``; the port accepts ``pallas``, and ``auto`` runs B2 (its plain
    version on the CPU) with the mean field."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    side = 20
    with pytest.raises(ValueError, match="divisible by 128"):
        jax_resolve_build("pallas", side, side)
    assert jax_resolve_build("auto", side, side) == "xla"
    assert _resolve_build("pallas", side, side) == _resolve_build("auto", side, side) == "pallas"
    frames, gt = generate_frames(2, size=side, seed=3)
    noisy = gt ^ (np.random.default_rng(1).random(gt.shape) < 0.08)
    got = refine_masks_device(frames, noisy, build="auto", device="cpu")
    np.testing.assert_array_equal(
        refine_masks_device(frames, noisy, build="pallas", device="cpu"), got)
    w1, alpha, beta, w2, gamma, iters = REFERENCE_CRF_PARAMS
    n = side * side
    mb = build_bilateral_reference(torch.from_numpy(frames.reshape(2, n, 3)), w1, alpha, beta,
                                   h=side, w=side, out_dtype="float32")
    probs = _mask_probs(torch.from_numpy(noisy.reshape(2, n, 1).astype(np.uint8)))
    taps = torch.from_numpy(_spatial_taps(gamma, side, side))
    want = _mean_field_iterate_multi(mb, probs, taps, w2, side, side, iters)[:, 0]
    np.testing.assert_array_equal(got.reshape(2, n), want.bool().numpy())


def test_crf_backend_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_crf_backend("auto", 64, 64, device=cuda) == "device"
    assert resolve_crf_backend("device", 64, 64, device=cpu) == "device"
    assert resolve_crf_backend("device", 256, 256, device=cuda) == "device"
    with pytest.raises(NotImplementedError):
        resolve_crf_backend("auto", 64, 64, device=cpu)
    with pytest.raises(NotImplementedError):
        resolve_crf_backend("auto", 256, 256, device=cuda)
    with pytest.raises(NotImplementedError):
        resolve_crf_backend("host", 64, 64, device=cuda)
    with pytest.raises(ValueError):
        resolve_crf_backend("device", 512, 512, device=cuda)
    with pytest.raises(ValueError):
        resolve_crf_backend("lattice", 64, 64, device=cuda)
