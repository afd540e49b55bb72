"""The rest of the port's device CRF against the JAX package's:
``densecrf_device`` through every build at L = 2 and 3 (labels and
``soft`` marginals), ``crf_param_search`` with its grid errors,
``DEFAULT_PARAM_GRID``, the host ``crf_reference_scaffold``, ``video``'s
grid parser, and numpy inputs going to the card by default. 16x16 frames
(N = 256); JAX's Pallas builds run in interpret mode."""

import re

import numpy as np
import pytest
import torch

from critic_vae_tpu.cli import _parse_crf_grid as jax_parse_crf_grid
from critic_vae_tpu.crf import DEFAULT_PARAM_GRID as JAX_GRID
from critic_vae_tpu.crf import crf_reference_scaffold as jax_scaffold
from critic_vae_tpu.crf.device import crf_param_search as jax_search
from critic_vae_tpu.crf.device import densecrf_device as jax_densecrf
from critic_vae_tpu.data.synthetic import generate_frames
from critic_vae_tpu_torch.cli import _parse_crf_grid
from critic_vae_tpu_torch.crf import DEFAULT_PARAM_GRID, REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf import crf_reference_scaffold
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    crf_param_search,
    densecrf_device,
    refine_masks_device,
)

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

H = W = 16


@pytest.fixture(scope="module")
def episode():
    frames, gt = generate_frames(4, size=H, seed=7)
    noisy = gt ^ (np.random.default_rng(2).random(gt.shape) < 0.08)
    return frames, gt, noisy


def _probs(noisy, labels):
    """The JAX package's own test probabilities (tests/test_crf_device.py):
    (1 - m, m), and for three labels (1 - m, 0.6 m, 0.4 m)."""
    m = noisy.astype(np.float32)
    return np.stack([1 - m, m] if labels == 2 else [1 - m, 0.6 * m, 0.4 * m], -1)


# (build, compute dtype, the bar): marginals within 1e-5 of JAX's, or labels
# at least 99.9% equal
BUILDS = {
    "xla": ("xla", "float32", "marginals"),
    "pallas_f32": ("pallas", "float32", "marginals"),
    "pallas_bf16": ("pallas", "bfloat16", "labels"),
    "int8": ("int8", "float32", "labels"),
    "vmem": ("vmem", "float32", "labels"),
}


@pytest.mark.parametrize("labels", [2, 3])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_densecrf_device_matches_jax(episode, monkeypatch, name, labels):
    """Labels and ``soft`` through every build (``vmem`` at L = 3 is B2's
    path in both packages). On these mask-derived probabilities the float32
    marginals lie within 1e-6; uniformly random ones would sit near ties,
    where 10 mean-field iterations grow any float reordering to ~1e-4."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    frames, _, noisy = episode
    build, dt, bar = BUILDS[name]
    probs = _probs(noisy[:2], labels)
    kw = dict(build=build, compute_dtype=dt)
    q_want = jax_densecrf(frames[:2], probs, REFERENCE_CRF_PARAMS, soft=True, **kw)
    want = jax_densecrf(frames[:2], probs, REFERENCE_CRF_PARAMS, **kw)
    q = densecrf_device(frames[:2], probs, REFERENCE_CRF_PARAMS, soft=True, device="cpu", **kw)
    got = densecrf_device(frames[:2], probs, REFERENCE_CRF_PARAMS, device="cpu", **kw)
    assert q.shape == (2, H, W, labels) and q.dtype == np.float32
    assert got.shape == (2, H, W) and got.dtype == np.uint8
    np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-5)
    if bar == "marginals":
        assert np.abs(q - q_want).max() <= 1e-5
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean(got == want) >= 0.999
        assert np.mean(q.argmax(-1) == q_want.argmax(-1)) >= 0.999


def test_densecrf_device_defaults_single_frame_and_errors(episode):
    """JAX's defaults (``xla``, float32), one (H, W, 3) frame squeezed, zero
    iterations giving the clamped input, and JAX's shape error."""
    frames, _, noisy = episode
    probs = _probs(noisy[:1], 2)
    one = densecrf_device(frames[0], probs[0], REFERENCE_CRF_PARAMS, device="cpu")
    np.testing.assert_array_equal(
        one, jax_densecrf(frames[0], probs[0], REFERENCE_CRF_PARAMS))
    q0 = densecrf_device(frames[:1], probs, (22, 12, 3.1, 8, 1.8, 0), soft=True, device="cpu")
    np.testing.assert_allclose(q0, np.clip(probs, 1e-8, None), atol=1e-6)
    with pytest.raises(ValueError) as want:
        jax_densecrf(frames[:2], probs, REFERENCE_CRF_PARAMS)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        densecrf_device(frames[:2], probs, REFERENCE_CRF_PARAMS, device="cpu")


GRID = {"w1": [11.0, 22.0], "beta": [1.55, 3.1]}


def test_crf_param_search_matches_jax(episode, monkeypatch):
    """A 2x2 grid: JAX's scores within 1e-6 in JAX's order, and its best
    masks."""
    monkeypatch.delenv(BUILD_ENV, raising=False)
    frames, gt, noisy = episode
    best_want, want = jax_search(frames, noisy, gt, GRID)
    best, got = crf_param_search(frames, noisy, gt, GRID, device="cpu")
    assert [p for _, p in got] == [p for _, p in want] and len(got) == 4
    assert max(abs(a - b) for (a, _), (b, _) in zip(got, want)) <= 1e-6
    assert [s for s, _ in got] == sorted((s for s, _ in got), reverse=True)
    assert best.dtype == bool and best.shape == noisy.shape
    np.testing.assert_array_equal(best, best_want)
    # each combination refines the original masks, not the previous output
    first = refine_masks_device(frames, noisy, got[0][1], device="cpu")
    np.testing.assert_array_equal(best, first)


GRID_ERRORS = {"unknown_key": {"w3": [1.0]}, "empty": {"w1": []}}


@pytest.mark.parametrize("case", sorted(GRID_ERRORS))
def test_crf_param_search_grid_errors_are_jax_s(episode, case):
    frames, gt, noisy = episode
    with pytest.raises(ValueError) as want:
        jax_search(frames, noisy, gt, GRID_ERRORS[case])
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        crf_param_search(frames, noisy, gt, GRID_ERRORS[case], device="cpu")


def test_default_param_grid_is_jax_s():
    assert DEFAULT_PARAM_GRID == JAX_GRID


def test_crf_reference_scaffold_is_bit_identical(episode):
    """The reference's quirks: ``mask[::skip]`` refined in place, each
    combination re-refining the previous one's output."""
    frames, gt, noisy = episode
    mask = noisy[:, None].astype(np.float32)
    grid = {**DEFAULT_PARAM_GRID, "w1": [11.0, 44.0], "iters": [3, 5]}
    for skip, g in ((1, None), (2, grid)):
        want = jax_scaffold(frames, mask, gt, skip=skip, param_grid=g)
        got = crf_reference_scaffold(frames, mask, gt, skip=skip, param_grid=g)
        assert got[1] == want[1]
        assert got[0].dtype == want[0].dtype and got[0].shape == mask.shape
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(mask, noisy[:, None])  # the caller's masks untouched


@pytest.mark.parametrize("spec", ["", "w1=11,22;beta=1.55,3.1", "iters=3,5;gamma=1.8",
                                  "w9=1", "w1=", "iters=1.5"])
def test_parse_crf_grid_is_jax_s(spec):
    try:
        want = jax_parse_crf_grid(spec)
    except SystemExit as e:
        with pytest.raises(SystemExit, match=re.escape(str(e))):
            _parse_crf_grid(spec)
    else:
        assert _parse_crf_grid(spec) == want


def test_numpy_inputs_default_to_the_card(episode):
    """Entry points run on the card unless asked for the CPU: numpy inputs
    without ``device`` go to CUDA (here: its error), not to the CPU."""
    frames, gt, noisy = episode
    probs = _probs(noisy, 2)
    calls = (lambda: refine_masks_device(frames, noisy),
             lambda: densecrf_device(frames, probs, REFERENCE_CRF_PARAMS),
             lambda: crf_param_search(frames, noisy, gt))
    if not torch.cuda.is_available():
        for call in calls:
            with pytest.raises(RuntimeError, match="device 'cuda' requested"):
                call()
    t = torch.from_numpy(frames)  # a tensor stays where it lies
    assert refine_masks_device(t, torch.from_numpy(noisy)).shape == noisy.shape
