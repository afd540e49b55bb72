"""The benchmark's span readers (bench_torch/spans.py and the per-layer
metrics that use it) on traces built by hand from Chrome trace events: a
launch from another thread inside a span counts, idle time inside a span
is the span less the card's busy intervals, the mean
field's bound at the video configuration, the saliency stage's readers and
its operation count, the threshold sweep's readers and its operation count,
and every reader's silence when its span is missing (the parent commit's
program has none)."""

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
                "launches_per_step.backward", "launches_per_step.update", "graph_replay_pct.train",
                "mean_field_fused_pct", "saliency_ms_per_kframe", "saliency_idle_pct.video",
                "launches_per_kframe.saliency", "epilogue_ms_per_kframe",
                "epilogue_fused_pct.video", "sweep_threshold_ms_per_kframe",
                "mean_field_hoisted_pct"]


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


def _mean_field_chunks(kernel_names):
    """Two crf.mean_field spans, each launching ``kernel_names`` in turn."""
    events, corr = [], 0
    for chunk in range(2):
        t0 = 20000.0 * chunk
        events.append(_span("crf.mean_field", t0, 1000.0))
        for k, name in enumerate(kernel_names):
            corr += 1
            events += [_launch(corr, t0 + 10 + 50 * k),
                       _kernel(corr, t0 + 20 + 900 * k, 800.0, name=name)]
    return events


STEP = "void (anonymous namespace)::mean_field_step_kernel<1>(__nv_bfloat16 const*)"


@pytest.mark.parametrize("kernel_names, want", [
    ([STEP] * 10, 100.0),                                     # one launch an iteration
    (["cutlass_80_tensorop_s16816gemm_bf16_64x256", "sm90_xmma_fprop_implicit_gemm_tf32",
      "softmax_warp_forward"] * 10, 0.0),                     # the library's mean field
    ([STEP] * 5 + ["Memcpy"], 50.0),                          # half the iterations
])
def test_mean_field_fused_pct_counts_the_kernels_launches(kernel_names, want):
    t = _traced(_mean_field_chunks(kernel_names), cell="video-crf")
    assert core.metric_reader("mean_field_fused_pct").read(t) == pytest.approx(want)


EPILOGUE = "void (anonymous namespace)::block_epilogue_pool(float const*, unsigned int)"


def _epilogue_blocks(kernel_lists):
    """A ``block.epilogue`` span a block, each launching its list of kernels
    (100 µs each) in turn."""
    events, corr = [], 0
    for block, names in enumerate(kernel_lists):
        t0 = 1000.0 * block
        events.append(_span("block.epilogue", t0, 500.0))
        for k, name in enumerate(names):
            corr += 1
            events += [_launch(corr, t0 + 10 + 50 * k),
                       _kernel(corr, t0 + 100 + 100 * k, 100.0, name=name)]
    return events


@pytest.mark.parametrize("kernel_lists, want", [
    ([[EPILOGUE]] * 4, 100.0),                                  # one launch a block
    ([[EPILOGUE, "void at::native::vectorized_elementwise_kernel<4> tanh"]] + [[EPILOGUE]] * 3,
     100.0),                                                    # another kernel beside it
    ([["void at::native::elementwise_kernel<128, 2> add"] * 4
      + ["void at::native::max_pool_forward_nchw<float, float>"]] * 2 + [[EPILOGUE]] * 2,
     50.0),                                                     # the ATen chain in two blocks
])
def test_epilogue_fused_pct_counts_the_kernels_launches(kernel_lists, want):
    t = _traced(_epilogue_blocks(kernel_lists), cell="video-nocrf")
    assert core.metric_reader("epilogue_fused_pct.video").read(t) == pytest.approx(want)


def test_epilogue_ms_per_kframe_sums_the_spans_device_time():
    t = _traced(_epilogue_blocks([[EPILOGUE]] * 3 + [[EPILOGUE, "tanh"]]), cell="video-crf",
                frames=500)
    # five kernels of 100 µs over 500 frames: 1 ms a 1,000 frames
    assert core.metric_reader("epilogue_ms_per_kframe").read(t) == pytest.approx(1.0)


SPATIAL = "void (anonymous namespace)::spatial_message_kernel(float const*, float const*)"


@pytest.mark.parametrize("kernel_names, want", [
    ([SPATIAL, STEP] * 10, 100.0),                   # the sweep: each step after its message
    ([STEP] * 10, 0.0),                              # every step's message in its own tail
    ([SPATIAL, STEP] * 5 + [STEP] * 5, 50.0),        # half the steps
    (["cutlass_80_tensorop_s16816gemm_bf16_64x256", "softmax_warp_forward"] * 10, None),
])
def test_mean_field_hoisted_pct_counts_the_spatial_kernels_over_the_steps(kernel_names, want):
    """The spatial kernels over the step kernels in ``crf.mean_field``
    spans; nothing where no step ran there (the library's mean field)."""
    t = _traced(_mean_field_chunks(kernel_names), cell="video-sweep")
    got = core.metric_reader("mean_field_hoisted_pct").read(t)
    assert got == (None if want is None else pytest.approx(want))
    # the spatial kernel's name holds no "mean_field_step": the fused share stays 100
    if want:
        assert core.metric_reader("mean_field_fused_pct").read(t) == pytest.approx(100.0)


def test_mean_field_fused_pct_is_silent_without_the_span():
    events = [e for e in _mean_field_chunks([STEP] * 10) if e["name"] != "crf.mean_field"]
    t = _traced(events, cell="video-crf")
    assert core.metric_reader("mean_field_fused_pct").read(t) is None


def _graph_launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts, "dur": 5.0,
            "tid": tid, "args": {"correlation": corr}}


def test_graph_replays_are_counted_a_step_and_their_kernels_belong_to_the_phases():
    """Four steps, the first eager (its phases' spans alone), three replayed:
    a ``train.replay`` span around the four phase spans, each phase one
    graph launch whose kernels all carry its correlation id."""
    events, corr = [], 0
    for step in range(4):
        t0 = 1000.0 * step
        if step:
            events.append(_span("train.replay", t0, 800.0))
        for p, phase in enumerate(("train.forward", "train.loss", "train.backward",
                                   "train.update")):
            ts = t0 + 10.0 + 200.0 * p
            events.append(_span(phase, ts, 150.0))
            corr += 1
            if step:
                events.append(_graph_launch(corr, ts + 5.0))
                events += [_kernel(corr, ts + 20.0 + 10.0 * k, 5.0) for k in range(p + 2)]
            else:
                for k in range(p + 2):
                    events += [_launch(100 * corr + k, ts + 5.0 + 10.0 * k),
                               _kernel(100 * corr + k, ts + 20.0 + 10.0 * k, 5.0)]
    t = _traced(events, units=4)
    assert core.metric_reader("graph_replay_pct.train").read(t) == pytest.approx(75.0)
    assert core.metric_reader("launches_per_step.forward").read(t) == 2
    assert core.metric_reader("launches_per_step.update").read(t) == 5
    assert core.metric_reader("launches_per_step.train").read(t) == 2 + 3 + 4 + 5
    # a slice of replays alone reads 100
    replayed = [e for e in events if e["ts"] >= 1000.0]
    assert core.metric_reader("graph_replay_pct.train").read(_traced(replayed, units=3)) == 100.0


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_every_reader_is_silent_without_its_span(metric):
    """A trace of a program without the port's spans (the kernels' spans
    and work alone, as the parent commit's) gives no value."""
    events = [_span("bilateral_build", 0.0, 100.0), _span("aten::mm", 0.0, 50.0),
              _launch(1, 10.0), _kernel(1, 20.0, 30.0)]
    for cell in ("video-crf", "train-b128"):
        assert core.metric_reader(metric).read(_traced(events, cell=cell)) is None


PINNED_UP, PAGEABLE_UP = "Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pageable -> Device)"
PINNED_DOWN, PAGEABLE_DOWN = "Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH (Device -> Pageable)"


@pytest.mark.parametrize("copies, want", [
    # pinned 30 + 10 µs of 100: the card's own DtoD copy and the kernel left out
    ([(PINNED_UP, 30.0), (PAGEABLE_UP, 40.0), (PINNED_DOWN, 10.0), (PAGEABLE_DOWN, 20.0),
      ("Memcpy DtoD (Device -> Device)", 500.0)], 40.0),
    ([(PAGEABLE_UP, 11.7), (PAGEABLE_DOWN, 21.2)], 0.0),       # every copy from pageable memory
    ([(PINNED_UP, 5.0), (PINNED_DOWN, 7.0)], 100.0),            # every copy through pinned memory
    ([("Memcpy DtoD (Device -> Device)", 5.0)], None),          # no copy between host and card
    ([], None),
])
def test_pinned_copy_pct_is_the_pinned_share_of_the_copies_device_time(copies, want):
    events, ts = [_launch(0, 0.0), _kernel(0, 0.0, 50.0)], 100.0
    for corr, (name, dur) in enumerate(copies, start=1):
        events += [_launch(corr, ts), _kernel(corr, ts + 5.0, dur, cat="gpu_memcpy", name=name)]
        ts += 1000.0
    got = core.metric_reader("pinned_copy_pct.video").read(_traced(events, cell="video-nocrf"))
    assert got == (None if want is None else pytest.approx(want))


def _saliency_trace():
    """One chunk's three saliency spans back to back over [0, 200] µs: the
    view launches a kernel (300 µs), a kernel from autograd's thread (100
    µs) and a copy (50 µs), the upsample a kernel (40 µs), the combine a
    kernel (10 µs); the card is busy over [20, 520] and, for a kernel
    launched after the spans, [900, 1900]."""
    return [_span("saliency.view", 0.0, 100.0), _span("saliency.upsample", 100.0, 50.0),
            _span("saliency.combine", 150.0, 50.0),
            _launch(1, 10.0), _kernel(1, 20.0, 300.0),
            _launch(2, 50.0, tid=2), _kernel(2, 320.0, 100.0),
            _launch(3, 60.0), _kernel(3, 420.0, 50.0, cat="gpu_memcpy", name="Memcpy"),
            _launch(4, 110.0), _kernel(4, 470.0, 40.0),
            _launch(5, 160.0), _kernel(5, 510.0, 10.0),
            _launch(6, 900.0), _kernel(6, 900.0, 1000.0)]


def test_saliency_readers_on_a_hand_built_trace():
    t = _traced(_saliency_trace(), cell="video-quality-nocrf", window_s=2000e-6, frames=2000)
    # 300 + 100 + 50 + 40 + 10 µs of device time over 2,000 frames
    assert core.metric_reader("saliency_ms_per_kframe").read(t) == pytest.approx(0.25)
    # four kernels (the copy is no kernel) over 2,000 frames
    assert core.metric_reader("launches_per_kframe.saliency").read(t) == pytest.approx(2.0)
    # idle inside the spans: [0, 20] of the 2,000 µs slice
    got = core.metric_reader("saliency_idle_pct.video").read(t)
    assert got == pytest.approx(1.0)
    assert got <= core.metric_reader("device_idle_pct.video").read(t)


def test_saliency_readers_sum_the_spans_present():
    """A trace that holds the view spans alone (no upsample, as the
    gradient method runs) reads their part."""
    events = [e for e in _saliency_trace()
              if e["name"] not in ("saliency.upsample", "saliency.combine")]
    t = _traced(events, cell="video-quality-nocrf", window_s=2000e-6, frames=2000)
    assert core.metric_reader("saliency_ms_per_kframe").read(t) == pytest.approx(0.225)
    assert core.metric_reader("launches_per_kframe.saliency").read(t) == pytest.approx(1.0)


def test_saliency_count_at_the_quality_configuration():
    """At ref64-quality-f32, a view of a frame is, by hand: the critic's
    forward, its convs 2·64²·3·8·9 = 1,769,472, 2·32²·8·8·9 = 1,179,648,
    2·16²·8·8·9 = 294,912 and 2·8²·8·16·9 = 147,456, the head 2·16·4·4·32 =
    16,384 and the linears 2·32·32 + 2·32 = 2,112, together 3,409,984; the
    backward to block 1's output, the input gradients of blocks 2 and 3,
    the head and the linears, 294,912 + 147,456 + 16,384 + 2,112 = 460,864;
    the upsample of the 16x16 map, 2·64·16·16 + 2·64·16·64 = 163,840: 4,034,688
    a view, 24,208,128 for six views."""
    from bench_torch.counts import peaks, saliency

    cell = core.load_cell("video-quality-nocrf")
    assert saliency.views(cell.config) == 6
    assert saliency.frame(cell.config) == 24_208_128
    t = _traced(_saliency_trace(), cell="video-quality-nocrf", window_s=1e-3, frames=2000)
    want = 100.0 * 2000 * 24_208_128 / peaks.FLOPS["float32"] / 1e-3
    assert core.metric_reader("mfu_pct.quality").read(t) == pytest.approx(want)


def test_sweep_threshold_ms_per_kframe_sums_its_spans_device_time():
    """Two chunks' ``sweep.threshold`` spans, each launching a kernel (one
    from another thread); a kernel launched outside them is left out."""
    events = [_span("sweep.threshold", 0.0, 100.0), _span("sweep.threshold", 1000.0, 100.0),
              _launch(1, 10.0), _kernel(1, 20.0, 300.0),
              _launch(2, 1010.0, tid=2), _kernel(2, 1020.0, 200.0),
              _launch(3, 500.0), _kernel(3, 500.0, 400.0)]
    t = _traced(events, cell="video-sweep", frames=2450)
    # 0.5 ms of device time over 2,450 frames
    got = core.metric_reader("sweep_threshold_ms_per_kframe").read(t)
    assert got == pytest.approx(0.5 / 2.45)
    bare = [e for e in events if e["name"] != "sweep.threshold"]
    assert core.metric_reader("sweep_threshold_ms_per_kframe").read(
        _traced(bare, cell="video-sweep")) is None


def test_mfu_pct_sweep_counts_the_nets_and_the_26_lane_mean_field():
    from bench_torch.counts import flops, peaks, sweep

    cfg = core.load_cell("video-sweep").config
    stages = sweep.stages(cfg, True)
    # the nets as eval_episode counts them, then 10 passes of M @ Q over 2 x 13 lanes
    assert stages[:-1] == flops.video_stages(cfg, False)
    assert stages[-1] == (10 * 2 * 4096**2 * 26, "bfloat16")
    assert sweep.stages(cfg, False) == flops.video_stages(cfg, False)
    per_frame = peaks.seconds_at_peak(stages)
    assert per_frame == pytest.approx(9.8e-6, abs=0.1e-6)
    # 4,900 frames in a 0.98 s slice: 4.9% of the peak
    t = _traced([_launch(1, 0.0), _kernel(1, 0.0, 10.0)], cell="video-sweep", window_s=0.98,
                frames=4900)
    assert core.metric_reader("mfu_pct.sweep").read(t) == pytest.approx(
        100.0 * 4900 * per_frame / 0.98)
