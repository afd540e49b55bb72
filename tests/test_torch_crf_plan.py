"""The device CRF's one decision of what a build runs (crf/device.py::_plan),
its one chunk body, and the direction of the imports between the CRF's
modules. No JAX: the entry points are held to the JAX package by
tests/test_torch_crf*.py; here every entry point and every chunking must
give the same labels through the one body. 16x16 frames (N = 256)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    MEM_ENV,
    _i8_message,
    _plan,
    build_bilateral_xla,
    densecrf_device,
    refine_masks_device,
    refine_masks_multi_device,
)
from critic_vae_tpu_torch.crf.fused_build import build_bilateral
from critic_vae_tpu_torch.crf.fused_resident import mean_field_resident, workspace_bytes
from critic_vae_tpu_torch.data.synthetic import generate_frames

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

REPO = pathlib.Path(__file__).resolve().parents[1]
CRF = REPO / "critic_vae_tpu_torch" / "crf"
N = 16 * 16


@pytest.fixture(scope="module")
def episode():
    frames, gt = generate_frames(6, size=16, seed=7)
    noisy = gt ^ (np.random.default_rng(2).random(gt.shape) < 0.1)
    return frames, np.stack([noisy, gt, noisy ^ gt])


@pytest.mark.parametrize("build", ["xla", "pallas", "int8", "vmem"])
def test_every_entry_point_gives_the_same_labels(episode, build, monkeypatch):
    """With the build forced through CRITIC_VAE_TPU_CRF_BUILD: each mask
    set by refine_masks_device, its row of refine_masks_multi_device, its
    (1 - m, m) probabilities by densecrf_device (labels, and the argmax of
    its marginals) and the same refinement in chunks of one frame, all
    bitwise equal. ``int8`` keeps its rule for many sets, B2 in bf16, so its
    rows are held to ``pallas``'s instead."""
    frames, sets = episode
    monkeypatch.delenv(MEM_ENV, raising=False)
    monkeypatch.setenv(BUILD_ENV, build)
    single = [refine_masks_device(frames, s, frame_chunk=4, device="cpu") for s in sets]
    multi = refine_masks_multi_device(frames, sets, frame_chunk=4, device="cpu")
    probs = np.stack([1.0 - sets[0], sets[0]], axis=-1).astype(np.float32)
    kw = dict(frame_chunk=4, compute_dtype="auto", device="cpu")
    dense = densecrf_device(frames, probs, REFERENCE_CRF_PARAMS, **kw)
    soft = densecrf_device(frames, probs, REFERENCE_CRF_PARAMS, soft=True, **kw)
    monkeypatch.setenv(MEM_ENV, "1")
    one_frame = refine_masks_device(frames, sets[0], frame_chunk=4, device="cpu")
    np.testing.assert_array_equal(dense.astype(bool), single[0])
    np.testing.assert_array_equal(soft.argmax(-1), dense)
    np.testing.assert_array_equal(soft[..., 1] > soft[..., 0], single[0])
    np.testing.assert_array_equal(one_frame, single[0])
    assert np.mean(single[0] == sets[0]) < 1.0  # the CRF changed something
    if build == "int8":
        monkeypatch.delenv(MEM_ENV)
        monkeypatch.setenv(BUILD_ENV, "pallas")
        single = refine_masks_multi_device(frames, sets, frame_chunk=4, device="cpu")
    for t in range(len(sets)):
        np.testing.assert_array_equal(multi[t], single[t])


MASK = torch.zeros((1, N), dtype=torch.uint8)
SETS = torch.zeros((1, N, 13), dtype=torch.uint8)
PAIRS, CLASSES3 = torch.zeros((1, N, 2)), torch.zeros((1, N, 3))


@pytest.mark.parametrize("build, second, compute_dtype, want", [
    ("xla", MASK, "auto", (build_bilateral_xla, "float32", 4 * N * N)),
    ("xla", SETS, "bfloat16", (build_bilateral_xla, "bfloat16", 2 * N * N)),
    ("pallas", MASK, "auto", (build_bilateral, "bfloat16", 2 * N * N)),
    ("pallas", CLASSES3, "float32", (build_bilateral, "float32", 4 * N * N)),
    ("int8", CLASSES3, "auto", (_i8_message, "int8", N * N)),
    ("vmem", PAIRS, "float32", (mean_field_resident, "bfloat16", workspace_bytes(1, N, 2))),
    ("vmem", CLASSES3, "auto", (build_bilateral, "bfloat16", 2 * N * N)),
    ("vmem", CLASSES3, "float32", (build_bilateral, "float32", 4 * N * N)),
])
def test_plan_says_what_each_build_runs(build, second, compute_dtype, want):
    """``auto`` stores B2's M in bf16 and the ``xla`` build's in float32;
    B5 takes only class pairs, so ``vmem`` at L = 3 runs B2 in
    ``compute_dtype``; B3 + B4 take any L."""
    assert _plan(build, second, compute_dtype) == want


def test_kernel_wrappers_do_not_import_the_orchestrator():
    """The kernel wrappers and the terms sit below crf/device.py: importing
    them leaves it unloaded, and no function under crf/ imports a crf
    module in its body."""
    code = ("import sys, critic_vae_tpu_torch.crf.fused_build, "
            "critic_vae_tpu_torch.crf.fused_resident, critic_vae_tpu_torch.crf.mean_field_step; "
            "print('critic_vae_tpu_torch.crf.device' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.split() == ["False"]
    for path in sorted(CRF.glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    if isinstance(node, ast.ImportFrom):
                        assert not (node.module or "").startswith("critic_vae_tpu_torch.crf"), (
                            path.name, fn.name, node.module)
