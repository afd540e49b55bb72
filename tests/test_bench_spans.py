"""The benchmark's span readers (bench_torch/spans.py and the per-layer
metrics that use it) on traces built by hand from Chrome trace events: a
launch from another thread inside a span counts, idle time inside a span
is the span less the card's busy intervals, the mean
field's bound at the video configuration, and every reader's silence when
its span is missing (the parent commit's program has none)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import core, spans  # noqa: E402
from bench_torch.tracing import Trace  # noqa: E402

SPAN_METRICS = ["device_stage_ms_per_kframe", "crf_ms_per_kframe", "mean_field_roofline_pct",
                "upload_idle_pct.video", "readback_idle_pct.video", "score_idle_pct.video",
                "launches_per_step.forward", "launches_per_step.loss",
                "launches_per_step.backward", "launches_per_step.update"]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1, dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _traced(events, cell="train-b128", window_s=1e-3, units=1, frames=1000):
    return core.Traced(Trace(events), window_s, units, frames, core.load_cell(cell))


def test_launch_from_another_thread_inside_the_span_counts():
    """Autograd's device thread (tid 2) launches the backward's kernels
    while the main thread (tid 1) holds train.backward: both count, the
    kernel launched after the span and the copy do not."""
    events = [_span("train.backward", 100.0, 100.0, tid=1),
              _launch(1, 110.0, tid=1), _kernel(1, 115.0, 5.0),
              _launch(2, 150.0, tid=2), _kernel(2, 155.0, 5.0),
              _launch(3, 160.0, tid=2), _kernel(3, 165.0, 5.0, cat="gpu_memcpy", name="Memcpy"),
              _launch(4, 250.0, tid=2), _kernel(4, 255.0, 5.0)]
    t = _traced(events)
    assert [len(found) for found in spans.ops(t.trace, "train.backward")] == [3]
    assert spans.kernels_per_unit(t, "train.backward") == 2
    assert core.metric_reader("launches_per_step.backward").read(t) == 2
    # the thread-matched reader of the parent's benchmark misses tid 2's launches
    assert [len(found) for found in t.trace.span_kernels("train.backward")] == [1]


def test_launches_per_step_divides_by_the_steps():
    events = []
    for step in range(4):
        t0 = 1000.0 * step
        events.append(_span("train.update", t0, 500.0))
        for k in range(3):
            corr = 10 * step + k
            events += [_launch(corr, t0 + 10 + 100 * k), _kernel(corr, t0 + 20 + 100 * k, 50.0)]
    assert core.metric_reader("launches_per_step.update").read(_traced(events, units=4)) == 3


def test_idle_inside_upload_is_the_span_less_busy_time():
    # the card is busy over [0, 20], [50, 70] and [90, 130]; video.upload
    # spans [10, 100]: idle inside it [20, 50] and [70, 90], 50 µs
    events = [_span("video.upload", 10.0, 90.0),
              _launch(1, 0.0), _kernel(1, 0.0, 20.0, cat="gpu_memcpy"),
              _launch(2, 40.0), _kernel(2, 50.0, 20.0),
              _launch(3, 80.0), _kernel(3, 90.0, 40.0)]
    t = _traced(events, cell="video-nocrf", window_s=200e-6)
    assert spans.idle_s(t.trace, "video.upload") == pytest.approx(50e-6)
    got = core.metric_reader("upload_idle_pct.video").read(t)
    assert got == pytest.approx(100.0 * 50e-6 / 200e-6)
    # a part of device_idle_pct.video, on its denominator
    assert got <= core.metric_reader("device_idle_pct.video").read(t)


def test_idle_counts_overlapping_spans_once_and_the_gap_before_the_first_operation():
    events = [_span("video.readback", 0.0, 40.0), _span("video.readback", 20.0, 40.0),
              _launch(1, 5.0), _kernel(1, 30.0, 10.0)]
    t = _traced(events, cell="video-nocrf")
    # the union [0, 60] less the busy [30, 40]
    assert spans.idle_s(t.trace, "video.readback") == pytest.approx(50e-6)


def test_device_stage_ms_per_kframe():
    events = [_span("video.device_stage", 0.0, 1000.0),
              _launch(1, 10.0), _kernel(1, 20.0, 300.0),
              _launch(2, 20.0, tid=3), _kernel(2, 400.0, 200.0),
              _launch(3, 2000.0), _kernel(3, 2000.0, 900.0)]
    t = _traced(events, cell="video-nocrf", frames=2000)
    # 0.5 ms of device time over 2,000 frames
    assert core.metric_reader("device_stage_ms_per_kframe").read(t) == pytest.approx(0.25)


def test_mean_field_bound_at_the_video_configuration():
    reader = core.metric_reader("mean_field_roofline_pct")
    cfg = core.load_cell("video-crf").config
    # 10 iterations x 64 frames x 4,096^2 bf16 entries = 21.47 GB at 3.35 TB/s
    assert reader.bound_s(cfg) == pytest.approx(10 * 64 * 4096**2 * 2 / 3.35e12)
    assert reader.bound_s(cfg) == pytest.approx(6.41e-3, abs=5e-6)
    # two chunks of 12.82 ms each: half the roofline
    events = []
    for chunk in range(2):
        t0 = 20000.0 * chunk
        events += [_span("crf.mean_field", t0, 100.0),
                   _launch(2 * chunk, t0 + 10), _kernel(2 * chunk, t0 + 200, 10000.0),
                   _launch(2 * chunk + 1, t0 + 20), _kernel(2 * chunk + 1, t0 + 10200, 2820.0)]
    t = _traced(events, cell="video-crf")
    assert reader.read(t) == pytest.approx(100.0 * reader.bound_s(cfg) / 12.82e-3)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_every_reader_is_silent_without_its_span(metric):
    """A trace of a program without the port's spans (the kernels' spans
    and work alone, as the parent commit's) gives no value."""
    events = [_span("bilateral_build", 0.0, 100.0), _span("aten::mm", 0.0, 50.0),
              _launch(1, 10.0), _kernel(1, 20.0, 30.0)]
    for cell in ("video-crf", "train-b128"):
        assert core.metric_reader(metric).read(_traced(events, cell=cell)) is None
