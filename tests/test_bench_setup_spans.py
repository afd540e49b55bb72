"""The benchmark's set-up readers (bench_torch/metrics/setup_*.py) on records
of the port's set-up spans built by hand: each reads its spans in seconds,
the first calls' self time leaves out the spans they hold, and each is
silent on an empty record and on a program that keeps none (an older
port's)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import critic_vae_tpu_torch  # noqa: E402
from bench_torch import core  # noqa: E402
from critic_vae_tpu_torch.utils import profiling  # noqa: E402
from critic_vae_tpu_torch.utils.profiling import SetupSpan  # noqa: E402

SPAN_READERS = ["setup_library_s", "setup_first_call_s", "setup_capture_s"]
S = 1_000_000_000  # ns a second


def _read(metric):
    return core.metric_reader(metric).read(None)


# a video cell's process: the episode's first call loads the library; a
# quality cell's: its first call captures the saliency stage's chunks, its
# second the tail's; a train cell's: the first step, then the capture in
# the second; a span still open
RECORD = [SetupSpan("setup.first_call", "video.episode", 10 * S, 14 * S, None),
          SetupSpan("setup.library", "load", 10 * S + S // 4, 11 * S, 0),
          SetupSpan("setup.capture", "saliency:128x64x64x3", 12 * S, 12 * S + S // 2, 0),
          SetupSpan("setup.capture", "saliency:18x64x64x3", 15 * S, 15 * S + S // 5, None),
          SetupSpan("setup.first_call", "train.step", 20 * S, 23 * S, None),
          SetupSpan("setup.capture", "train:source=128x64x64x3", 24 * S, 24 * S + S // 10, None),
          SetupSpan("setup.first_call", "video.sweep", 30 * S, None, None)]


@pytest.mark.parametrize("metric, want", [
    ("setup_library_s", 0.75),
    ("setup_capture_s", 0.5 + 0.2 + 0.1),
    # 4 s less the library's 0.75 and the capture's 0.5 it holds, and 3 s
    ("setup_first_call_s", 2.75 + 3.0),
])
def test_span_readers_on_a_hand_built_record(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "SETUP_SPANS", RECORD)
    assert _read(metric) == pytest.approx(want)


def test_first_call_self_time_leaves_out_each_span_it_holds_directly(monkeypatch):
    """A first call nested in another is the outer one's child: each
    counts its own time once."""
    record = [SetupSpan("setup.first_call", "video.episode", 0, 10 * S, None),
              SetupSpan("setup.first_call", "train.step", S, 5 * S, 0),
              SetupSpan("setup.library", "build", 2 * S, 3 * S, 1)]
    monkeypatch.setattr(profiling, "SETUP_SPANS", record)
    assert _read("setup_first_call_s") == pytest.approx(6.0 + 3.0)
    assert _read("setup_library_s") == pytest.approx(1.0)
    assert _read("setup_capture_s") is None


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_span_readers_are_silent_on_an_empty_record_and_without_one(monkeypatch, metric):
    monkeypatch.setattr(profiling, "SETUP_SPANS", [])
    assert _read(metric) is None
    monkeypatch.delattr(profiling, "SETUP_SPANS")
    assert _read(metric) is None


def test_before_port_is_the_import_stamp_less_the_process_start(monkeypatch):
    monkeypatch.setattr(core, "process_start_wall", lambda: 100.0)
    monkeypatch.setattr(critic_vae_tpu_torch, "IMPORT_START_NS", 102 * S + S // 4)
    assert _read("setup_before_port_s") == pytest.approx(2.25)
    monkeypatch.delattr(critic_vae_tpu_torch, "IMPORT_START_NS")
    assert _read("setup_before_port_s") is None


def test_before_port_reads_this_process():
    """The real stamp lies after the process's start and before now."""
    import time

    got = _read("setup_before_port_s")
    assert got is not None and 0.0 <= got <= time.time() - core.process_start_wall() + 0.05
