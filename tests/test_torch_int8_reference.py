"""The device CRF's ``int8`` build (``CRITIC_VAE_TPU_CRF_BUILD=int8``: B3's
8-bit K, B4's product) against the benchmark's plain reference of the
8-bit model, bench_torch/reference/crf_int8.py, on the CPU, where B3 and B4
run their plain versions; ``crf/device.py::BUILDS``, which counts the
chunks each build refined; and the cell ``video-crf-int8`` rehearsed at its
tiny size.

Tolerances, on seeded 16x16 frames and noisy masks. The port takes the
message as g · (K8 @ bf16(g · q)), the reference as M q in float32: the
bf16 rounding of g · q (2^-9 of each term) moves a message of up to ~w1 =
22 by up to ~2^-9 of itself, ~4e-2 of the softmax's input, whose slope (at
most 1/2) carries it to q (measured over seeds 5, 9 and 27 of the frames:
1.1e-3 to 6.2e-3 after ten iterations, where the float32 model lies
2.7e-2 to 5.9e-2 from the 8-bit one); labels flip only where q_1 - q_0
lies within that of 0 (none of 4,608 there). K8 is quantised from two
computations of k (B3's plain version's per-coordinate differences, the
reference's dense ones), which may round an entry across a half of 127's
step, a change far below the bf16 rounding's. The faults planted in the
8-bit message flip 0.8% to 5.5% of those labels.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.crf import REFERENCE_CRF_PARAMS
from critic_vae_tpu_torch.crf.device import (
    BUILD_ENV,
    BUILDS,
    densecrf_device,
    refine_masks_device,
    refine_masks_multi_device,
    reset_builds,
)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import core, traffic  # noqa: E402
from bench_torch.reference import crf as ref_f32  # noqa: E402
from bench_torch.reference import crf_int8 as ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CELL = "video-crf-int8"
CPU = torch.device("cpu")
SIZE, FRAMES = 16, 6
MARGINALS_ATOL = 1e-2   # the bf16 rounding of g · q through the softmax (see above)
LABELS_SHARE = 1e-3     # labels that may flip where q_1 - q_0 lies within that of 0


@pytest.fixture(autouse=True)
def no_build_override(monkeypatch):
    monkeypatch.delenv(BUILD_ENV, raising=False)


@pytest.fixture(scope="module")
def episode():
    """Seeded 16x16 frames of the cell's traffic and their ground truth
    with a tenth of the pixels flipped, as threshold masks."""
    tr = {**core.load_json(ROOT / "bench_torch" / "traffic" / "episodes-2450-crf.json"),
          "frame_size": SIZE}
    frames, gt = traffic.frames(FRAMES, 27, tr, CPU)
    gen = torch.Generator().manual_seed(28)
    masks = gt ^ (torch.rand(gt.shape, generator=gen) < 0.1)
    return frames, masks


def test_reference_imports_no_jax_and_nothing_of_the_port():
    code = ("import sys; import bench_torch.reference.crf_int8; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'critic_vae_tpu', 'critic_vae_tpu_torch')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_unquantised_reference_is_the_float32_reference(episode):
    """With K8/127 replaced by k the 8-bit reference is reference/crf.py's
    mean field, so the two differ only by the quantisation."""
    frames, masks = episode
    same = ref.refine(frames, masks, REFERENCE_CRF_PARAMS, quantise=lambda k: k)
    assert torch.equal(same, ref_f32.refine(frames, masks, REFERENCE_CRF_PARAMS))


def test_quantised_values_are_the_nearest_of_127_levels():
    k = torch.rand(4096, generator=torch.Generator().manual_seed(3))
    levels = ref.quantised(k) * 127.0
    assert torch.equal(levels, torch.round(levels)) and levels.max() <= 127.0
    assert (levels - 127.0 * k).abs().max() <= 0.5 + 1e-4
    assert ref.quantised(torch.zeros(3)).eq(0).all()


def test_port_labels_and_marginals_follow_the_8bit_reference(episode, monkeypatch):
    """``refine_masks_device`` under ``CRITIC_VAE_TPU_CRF_BUILD=int8`` (B3 +
    B4's plain versions) against the 8-bit reference: labels within
    LABELS_SHARE, and ``densecrf_device``'s ``int8`` marginals of the same
    masks within MARGINALS_ATOL; the float32 reference lies farther from
    the int8 model than the port does."""
    frames, masks = episode
    params = REFERENCE_CRF_PARAMS
    monkeypatch.setenv(BUILD_ENV, "int8")
    got = refine_masks_device(frames, masks, params, frame_chunk=4, fetch=False)
    want = ref.refine(frames, masks, params)
    assert (got != want).double().mean().item() <= LABELS_SHARE
    probs = torch.stack([1.0 - masks.float(), masks.float()], dim=-1)
    q = densecrf_device(frames, probs, params, build="int8", soft=True, frame_chunk=4)
    q_ref = ref.marginals(frames, masks, params).view(q.shape)
    gap = np.abs(q - q_ref.numpy()).max()
    assert 0 < gap <= MARGINALS_ATOL
    f32 = ref.marginals(frames, masks, params, quantise=lambda k: k).view(q.shape)
    assert np.abs(f32.numpy() - q_ref.numpy()).max() > gap


def test_builds_count_the_build_each_chunk_ran(episode, monkeypatch):
    """One mask set under ``int8`` counts its chunks and frames (padding
    left out) as ``int8``; many mask sets under ``int8`` run B2 in bf16 and
    count as ``pallas``; ``auto`` on the CPU as ``xla``; ``reset_builds``
    zeroes every count."""
    frames, masks = episode
    params = (*REFERENCE_CRF_PARAMS[:5], 1)
    reset_builds()
    monkeypatch.setenv(BUILD_ENV, "int8")
    refine_masks_device(frames, masks, params, frame_chunk=4)
    assert BUILDS["int8"] == {"chunks": 2, "frames": FRAMES}
    refine_masks_multi_device(frames[:3], torch.stack([masks[:3], ~masks[:3]]), params,
                              frame_chunk=4)
    assert BUILDS["pallas"] == {"chunks": 1, "frames": 3}
    monkeypatch.delenv(BUILD_ENV)
    refine_masks_device(frames[:1], masks[:1], params)
    assert BUILDS == {"xla": {"chunks": 1, "frames": 1}, "pallas": {"chunks": 1, "frames": 3},
                      "int8": {"chunks": 2, "frames": FRAMES},
                      "vmem": {"chunks": 0, "frames": 0}}
    reset_builds()
    assert all(c == {"chunks": 0, "frames": 0} for c in BUILDS.values())


@pytest.fixture(scope="module")
def driver():
    return core.driver("video_int8")


@pytest.mark.parametrize("mode", ["program", "k8_frames_rolled", "diagonal_in_rowsum"])
def test_planted_8bit_faults_fail_the_cells_crf_limit(driver, episode, mode, monkeypatch):
    """The cell's CRF-alone number (``crf_own_masks_mismatch``: the port's
    labels against the 8-bit reference's of the same masks) passes its limit
    for the port as it is, and fails it with each fault the driver plants in
    the 8-bit message."""
    frames, masks = episode
    limit = core.load_cell(CELL, rehearsal=True).workload["limits"]["crf_own_masks_mismatch"]
    monkeypatch.setenv(BUILD_ENV, "int8")
    with driver._planted(mode):
        got = refine_masks_device(frames, masks, REFERENCE_CRF_PARAMS, frame_chunk=FRAMES,
                                  fetch=False)
    share = (got != ref.refine(frames, masks, REFERENCE_CRF_PARAMS)).double().mean().item()
    assert (share <= limit) == (mode == "program"), share


def test_wrong_build_chunks_counts_other_and_missing_chunks(driver):
    cell = core.load_cell(CELL)
    zero = {b: {"chunks": 0, "frames": 0} for b in BUILDS}
    per_episode = -(-int(cell.traffic["episode_frames"]) // 64)
    ran = {**zero, "int8": {"chunks": 2 * per_episode, "frames": 0}}
    assert driver._wrong_chunks(ran, 2, cell) == 0.0
    assert driver._wrong_chunks({**ran, "pallas": {"chunks": 3, "frames": 0}}, 2, cell) == 3.0
    assert driver._wrong_chunks(zero, 2, cell) == 2.0 * per_episode


def test_cell_rehearsal_on_the_cpu_is_correct():
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELL, "--device",
                           "cpu", "--seed", "3000000027", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "correct True" in proc.stdout, proc.stdout[-2000:]
    assert "'int8': {'chunks': 1, 'frames': 4}" in proc.stdout, proc.stdout[-2000:]
