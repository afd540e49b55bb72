"""The threshold sweep (pipelines/video.py::threshold_sweep) against the
benchmark's plain reference, bench_torch/reference/sweep.py, on the CPU:
seeded, standardised weights as the cell ``video-sweep`` makes them, 2
frames of 64x64 with ground truth in chunks of one frame, the 13 thresholds
of ``ref64-sweep-f32``, the CRF on the device path, whose CPU build is
``xla`` (a float32 M).

Tolerances, each a share of the reference's tp + fn + fp at a threshold:
the maps' levels are computed in float32 by both, the port's convs adding
their biases after the conv and summing in other orders, so a map pixel
that lies within rounding of a level boundary may fall one level apart and
cross a threshold (the worst seen, weight seeds 5-7 here and the
rehearsal's seed 77: 2.7e-4 of the union); the CRF's labels then start
from those masks, and the port's Gram-form M rounds otherwise than the
reference's dense differences (2.8e-4). Both stay under 1e-3, which a fault
of the thresholds' lanes passes by three orders of magnitude. The spans,
the counter and the unrounded counts are checked on the same call; the cell's CPU rehearsal exits 3, correct."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.pipelines import video as pv

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import core, traffic  # noqa: E402
from bench_torch.reference import sweep as ref  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CELL = "video-sweep"
CPU = torch.device("cpu")
COUNT_TOL = 1e-3
# the spans of one sweep and the span each nests in, as threshold_sweep opens them
SWEEP_PARENTS = {"video.sweep": None, "video.upload": "video.sweep",
                 "video.device_stage": "video.sweep", "sweep.threshold": "video.sweep",
                 "video.crf": "video.sweep", "video.readback": "video.sweep",
                 "video.score": "video.sweep", "crf.build": "video.crf",
                 "crf.mean_field": "video.crf"}


@pytest.fixture(scope="module", autouse=True)
def flushed_denormals():
    """Denormal floats flushed to zero for the file: the spatial kernel's
    far entries are denormal, and the CPU's matrix products over them run
    about twice as slow; flushed, the reference's counts here are the same."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def driver():
    return core.driver("sweep")


@pytest.fixture(scope="module")
def setup(driver):
    """The cell at its rehearsal size, its seeded nets (modules and state
    dicts) standardised on 64 frames, and 2 frames with their ground
    truth."""
    cell = core.load_cell(CELL, rehearsal=True)
    cfg = {**cell.config, "calibration_frames": 64}
    critic, vae, critic_sd, vae_sd = driver._video._models(cfg, cell.traffic, 5, CPU)
    frames, gt = traffic.frames(2, 105, cell.traffic, CPU)
    return cell, critic, vae, critic_sd, vae_sd, frames.numpy(), gt.numpy()


def _sweep(driver, setup, mode: str = "program"):
    """The cell's sweep of the frames with ``mode`` planted, a frame a
    chunk (the cell's chunk of 512 would pad them to 512 frames)."""
    cell, critic, vae, _, _, frames, gt = setup
    with driver._planted(mode):
        return pv.threshold_sweep(vae, critic, frames, gt, cell.config["thresholds"],
                                  **{**driver._sweep_kwargs(cell, CPU, mode), "batch_size": 1})


@pytest.fixture(scope="module")
def swept(driver, setup):
    """One sweep under the profiler (its results, the spans found in
    order with their parents, the counter after it) and the reference's
    counts of the same frames."""
    cell, _, _, critic_sd, vae_sd, frames, gt = setup
    pv.reset_sweeps()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _sweep(driver, setup)
    counter = dict(pv.SWEEPS)
    found = []
    for e in prof.events():
        if e.name in SWEEP_PARENTS:
            p = e.cpu_parent
            while p is not None and p.name not in SWEEP_PARENTS:
                p = p.cpu_parent
            found.append((e.name, None if p is None else p.name))
    want = ref.episode(critic_sd, vae_sd, torch.from_numpy(frames), torch.from_numpy(gt),
                       cell.config["thresholds"], tuple(cell.config["crf_params"]),
                       crf_block=int(cell.workload["reference_crf_block"]))
    return got, found, counter, {k: v.tolist() for k, v in want.items()}


@pytest.mark.parametrize("kind", ["thr", "crf"])
def test_counts_match_the_reference(driver, swept, kind):
    got, _, _, want = swept
    assert [r["threshold"] for r in got] == list(range(0, 130, 10))
    for r, w in zip(got, want[f"{kind}_counts"]):
        counts = r[f"{kind}_counts"]
        assert sum(w) > 0 and all(isinstance(c, int) for c in counts)
        assert driver._mismatch(counts, w) <= COUNT_TOL, (r["threshold"], counts, w)
        assert abs(driver._iou(counts) - driver._iou(w)) <= COUNT_TOL, (r["threshold"], counts, w)
    # the masks thin as the threshold rises
    tps = [r[f"{kind}_counts"][0] + r[f"{kind}_counts"][2] for r in got]
    assert tps[0] > tps[-1]


def test_rounded_ious_are_the_unrounded_counts_divided(driver, swept):
    got, _, _, _ = swept
    for r in got:
        assert round(driver._iou(r["thr_counts"]), 3) == r["thr_iou"]
        assert round(driver._iou(r["crf_counts"]), 3) == r["crf_iou"]


def test_sweep_opens_its_spans_once_a_chunk_and_the_crf_once(swept):
    """2 frames a frame a chunk: two ``video.device_stage`` and two
    ``sweep.threshold``; ``video.crf`` once a call, the CRF's own spans (one
    chunk of frames) inside it."""
    _, found, _, _ = swept
    for name, parent in found:
        assert parent == SWEEP_PARENTS[name], (name, parent)
    counts = {name: sum(1 for n, _ in found if n == name) for name in SWEEP_PARENTS}
    assert counts == {"video.sweep": 1, "video.upload": 1, "video.device_stage": 2,
                      "sweep.threshold": 2, "video.crf": 1, "video.readback": 2,
                      "video.score": 1, "crf.build": 1, "crf.mean_field": 1}


def test_sweeps_counter_counts_calls_thresholds_and_refined_sets(swept):
    _, _, counter, _ = swept
    assert counter == {"calls": 1, "thresholds": 13, "mask_sets_refined": 13}
    pv.reset_sweeps()
    assert pv.SWEEPS == {"calls": 0, "thresholds": 0, "mask_sets_refined": 0}


def test_sweep_opens_a_threshold_span_a_chunk_and_counts_without_the_crf(driver, setup):
    """3 frames in chunks of 2, CRF off: two ``sweep.threshold`` spans, no
    ``video.crf``; no mask set refined; ``crf_counts`` None."""
    cell, critic, vae, _, _, frames, gt = setup
    frames, gt = (np.concatenate([a, a[:1]]) for a in (frames, gt))
    pv.reset_sweeps()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = pv.threshold_sweep(vae, critic, frames, gt, (0, 60), device=CPU,
                                 run_crf=False, batch_size=2)
    names = [e.name for e in prof.events()]
    assert names.count("sweep.threshold") == 2 and names.count("video.device_stage") == 2
    assert "video.crf" not in names
    assert pv.SWEEPS == {"calls": 1, "thresholds": 2, "mask_sets_refined": 0}
    assert [r["crf_counts"] for r in got] == [None, None]
    assert [r["crf_iou"] for r in got] == [None, None]


@pytest.mark.parametrize("mode", ["program", "lanes_shifted"])
def test_lanes_shifted_fault_fails_the_cells_limits(driver, setup, swept, mode):
    """The cell's numbers (drivers/sweep.py::_compare, against the same
    reference counts) pass its limits for the sweep as it is, and fail
    them with mask set t refined in the lanes of set t + 1."""
    cell = setup[0]
    res = swept[0] if mode == "program" else _sweep(driver, setup, mode)
    numbers = driver._compare(res, swept[3], cell.config["thresholds"], ("thr", "crf"))
    correct, _ = core.judge(numbers, cell.workload["limits"])
    assert correct == (mode == "program"), numbers
    assert numbers["thr_count_mismatch"] <= COUNT_TOL  # the fault is in the CRF's lanes alone


def _misprinted(res):
    """The results with the first threshold's printed IoU a rounding step
    off its counts' rounded IoU (the masks and counts as they were)."""
    return [{**res[0], "thr_iou": round(res[0]["thr_iou"] + 1e-3, 3)}, *res[1:]]


@pytest.mark.parametrize("fault,faults", [
    ("none", 0),
    ("dropped", 1),             # the last threshold missing
    ("reordered", 2),           # the first two swapped, counts and all: 2 and their IoUs
    ("misprinted", 1),          # a printed IoU that its own counts do not give
])
def test_result_faults_counts_missing_reordered_and_misprinted_results(driver, setup, swept,
                                                                       fault, faults):
    """``result_faults`` sees what the counts' numbers cannot: a sweep
    that drops or reorders thresholds, or prints an IoU its counts do not
    give; the cell's limits then fail."""
    cell = setup[0]
    res = swept[0]
    res = {"none": res, "dropped": res[:-1], "reordered": [res[1], res[0], *res[2:]],
           "misprinted": _misprinted(res)}[fault]
    numbers = driver._compare(res, swept[3], cell.config["thresholds"], ("thr", "crf"))
    if fault == "reordered":  # their IoUs may also lie a step off the reference's
        assert numbers["result_faults"] >= faults
    else:
        assert numbers["result_faults"] == faults
    correct, _ = core.judge(numbers, cell.workload["limits"])
    assert correct == (faults == 0), numbers


def test_cell_rehearsal_on_the_cpu_is_correct():
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELL, "--device",
                           "cpu", "--seed", "3000000021", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "correct True" in proc.stdout, proc.stdout[-2000:]
