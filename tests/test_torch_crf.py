"""The port's device CRF (critic_vae_tpu_torch.crf) against the JAX package:
kernel B2's plain version (the pair of K and g, M = g g^T K) against the
Pallas build's normalized M (interpret mode on the CPU), and the refinement
against both JAX builds. 16x16 frames (N = 256)."""

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
    _resolve_build,
    refine_masks_device,
)
from critic_vae_tpu_torch.crf.fused_build import build_bilateral, build_bilateral_reference
from critic_vae_tpu_torch.crf.policy import resolve_crf_backend
from critic_vae_tpu_torch.kernels import build as kb

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

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


def _normalized(pair):
    """M = g g^T K of B2's pair, in float32."""
    return pair.g[:, :, None] * pair.g[:, None, :] * pair.k.float()


def test_build_plain_matches_pallas_f32(episode):
    imgs = episode[0][:3].reshape(3, H * W, 3)
    want = _jax_m(imgs, "float32")
    pair = build_bilateral(torch.from_numpy(imgs), W1, ALPHA, BETA, h=H, w=W,
                           out_dtype="float32")
    assert pair.k.shape == (3, H * W, H * W) and pair.k.dtype == torch.float32
    assert pair.g.shape == (3, H * W) and pair.g.dtype == torch.float32
    assert torch.diagonal(pair.k, dim1=1, dim2=2).abs().max().item() == 0.0
    got = _normalized(pair).numpy()
    sig = np.abs(want) > 1e-3
    assert sig.sum() > 1000
    assert (np.abs(got - want)[sig] / np.abs(want)[sig]).max() <= 1e-5


def test_build_plain_bf16_within_one_ulp_of_pallas(episode):
    """The pair's bf16 K, normalized in float32 and rounded to bf16, within
    one bf16 ulp of the Pallas build's bf16 M (K's rounding and M's lie on
    either side of the products)."""
    imgs = episode[0][:3].reshape(3, H * W, 3)
    want = jnp.asarray(_jax_m(imgs, "bfloat16")).astype(jnp.bfloat16)
    pair = build_bilateral(torch.from_numpy(imgs), W1, ALPHA, BETA, h=H, w=W,
                           out_dtype="bfloat16")
    assert pair.k.dtype == torch.bfloat16
    got = _normalized(pair).to(torch.bfloat16)
    bits_t = got.view(torch.int16).numpy().astype(np.int64)
    bits_j = np.asarray(want).view(np.int16).astype(np.int64)
    assert np.abs(bits_t - bits_j).max() <= 1  # M >= 0: bit distance = ulps


def test_build_row_blocks_do_not_change_the_result(episode):
    imgs = torch.from_numpy(episode[0][:2].reshape(2, H * W, 3))
    a = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=H, w=W, out_dtype="float32")
    b = build_bilateral_reference(imgs, W1, ALPHA, BETA, h=H, w=W, out_dtype="float32",
                                  row_block=37)
    assert torch.equal(a.k, b.k) and torch.equal(a.g, b.g)


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
    if not torch.cuda.is_available():  # numpy without a device goes to the card
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            refine_masks_device(frames, noisy)
    with pytest.raises(ValueError):
        refine_masks_device(frames, noisy[:, :8], device="cpu")
    with pytest.raises(ValueError):
        build_bilateral(torch.zeros((1, 10, 3), dtype=torch.uint8), W1, ALPHA, BETA, h=4, w=4)


@pytest.mark.parametrize("build", ["xla", "int8", "vmem", "pallas"])
def test_unported_builds_raise(build, monkeypatch):
    """Every build of the JAX package is ported, the Gram-form ``xla`` too:
    each named build resolves to itself, ``auto`` to B2 on CUDA and to
    ``xla`` on the CPU, and only an unknown name raises."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert _resolve_build(build, 64, 64, cpu) == _resolve_build(build, 64, 64, cuda) == build
    assert _resolve_build("auto", 64, 64, cuda) == "pallas"
    assert _resolve_build("auto", 64, 64, cpu) == "xla" == jax_resolve_build("auto", 64, 64)
    with pytest.raises(ValueError):
        _resolve_build("lattice", 64, 64, cpu)


def test_mem_env_caps_the_chunk_without_changing_masks(monkeypatch):
    """``CRITIC_VAE_TPU_CRF_MEM`` is the per-chunk byte budget, as in the JAX
    package (its tests/test_crf_device.py): a budget of one float32 64x64
    matrix gives chunks of one frame and the same masks."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    monkeypatch.delenv(MEM_ENV, raising=False)
    frames, gt = generate_frames(3, seed=5)
    noisy = gt ^ (np.random.default_rng(4).random(gt.shape) < 0.08)
    chunks = []
    body = crf_device._chunk_marginals

    def spy(plan, imgs_u8, *args):
        chunks.append(imgs_u8.shape[0])
        return body(plan, imgs_u8, *args)

    monkeypatch.setattr(crf_device, "_chunk_marginals", spy)
    whole = refine_masks_device(frames, noisy, device="cpu")
    monkeypatch.setenv(MEM_ENV, str((64 * 64) ** 2 * 4))
    capped = refine_masks_device(frames, noisy, device="cpu")
    assert chunks == [3, 1, 1, 1]
    np.testing.assert_array_equal(capped, whole)


def test_ragged_sizes_take_b2_where_jax_does_not(monkeypatch):
    """ROADMAP C.3, repaired: at H*W % 128 != 0 the port resolves as the JAX
    package does. ``pallas`` raises in both, and ``auto`` runs the float32
    ``xla`` build, on the CPU and on CUDA alike; its masks are the explicit
    ``xla`` build's and agree with the JAX package's ``auto``."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    side = 20
    for resolve in (jax_resolve_build, lambda b, h, w: _resolve_build(b, h, w, "cuda")):
        with pytest.raises(ValueError, match="divisible by 128"):
            resolve("pallas", side, side)
        assert resolve("auto", side, side) == "xla"
    assert _resolve_build("auto", side, side, "cpu") == "xla"
    frames, gt = generate_frames(2, size=side, seed=3)
    noisy = gt ^ (np.random.default_rng(1).random(gt.shape) < 0.08)
    got = refine_masks_device(frames, noisy, build="auto", device="cpu")
    np.testing.assert_array_equal(
        refine_masks_device(frames, noisy, build="xla", compute_dtype="float32",
                            device="cpu"), got)
    want = jax_refine(frames, noisy, REFERENCE_CRF_PARAMS)
    assert np.mean(got == want) >= 0.999


def test_crf_backend_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_crf_backend("auto", 64, 64, device=cuda) == "device"
    assert resolve_crf_backend("device", 64, 64, device=cpu) == "device"
    assert resolve_crf_backend("device", 256, 256, device=cuda) == "device"
    assert resolve_crf_backend("auto", 64, 64, device=cpu) == "host"
    assert resolve_crf_backend("auto", 256, 256, device=cuda) == "host"
    assert resolve_crf_backend("host", 64, 64, device=cuda) == "host"
    with pytest.raises(ValueError):
        resolve_crf_backend("device", 512, 512, device=cuda)
    with pytest.raises(ValueError):
        resolve_crf_backend("lattice", 64, 64, device=cuda)
