"""The check that decides ``correct``, shown to pass sound runs and to fail
its control and the faults planted under the timed path.

Run with ``python -m pytest bench_torch/tests -q`` (about ten minutes on
a CPU). Each case drives a cell's driver past the harness's look for a
card, at the tiny size of the workload's ``rehearsal`` entries, on the CPU
(or the card where one is present), and judges its numbers against the
cell's own limits. The training control (TF32) exists only on the card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import calibrate, core, faults  # noqa: E402
from bench_torch.run import RunContext  # noqa: E402

torch.set_num_threads(4)


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _readings(workload: str, mode: str, seed: int = 31) -> dict:
    dev = _device()
    cell = core.load_cell(workload, rehearsal=dev == "cpu", listed=False)
    ctx = RunContext(device=torch.device(dev), seed=seed, seconds=0.0, trace=False)
    return core.driver(cell.workload["driver"]).readings(cell, ctx, mode), cell


def _correct(workload: str, mode: str) -> bool:
    numbers, cell = _readings(workload, mode)
    return core.judge(numbers, cell.workload["limits"])[0]


@pytest.mark.parametrize("workload", ["video-crf", "video-nocrf", "train-b128"])
def test_sound_run_is_correct(workload):
    assert _correct(workload, "program")


@pytest.mark.parametrize("workload", ["video-crf", "video-nocrf"])
def test_video_control_is_not_correct(workload):
    assert not _correct(workload, "control")


def test_train_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("the training control is TF32, which exists only on a CUDA card")
    assert not _correct("train-b128", "control")


@pytest.mark.parametrize("workload", ["video-crf", "video-nocrf"])
@pytest.mark.parametrize("fault", faults.VIDEO)
def test_video_fault_is_not_correct(workload, fault):
    assert not _correct(workload, fault)


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_fault_is_not_correct(fault):
    assert not _correct("train-b128", fault)


def test_train_ranks_faults_are_not_correct(tmp_path):
    """train-dp4 over four ranks (gloo on the CPU): sound, then each fault."""
    if _device() == "cuda" and torch.cuda.device_count() < 4:
        pytest.skip("train-dp4 needs four cards, or none (gloo ranks on the CPU)")
    out = tmp_path / "readings.jsonl"
    assert calibrate.main(["--workload", "train-dp4", "--device", _device(), "--seeds", "1",
                           "--first-seed", "31", "--modes", "program", "--faults",
                           "--out", str(out)]) == 0
    records = [json.loads(line) for line in out.read_text().splitlines()]
    cell = core.load_cell("train-dp4", rehearsal=_device() == "cpu", listed=False)
    verdict = {r["mode"]: core.judge(r["numbers"], cell.workload["limits"])[0] for r in records}
    assert verdict == {"program": True, **{f: False for f in faults.TRAIN_RANKS}}
