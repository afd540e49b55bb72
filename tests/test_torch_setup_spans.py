"""The port's set-up spans (utils/profiling.py::setup_span): each entry
point's first call in the process is recorded once, a later call records
nothing and returns the same outputs bitwise, set-up spans name the one
open around them as their parent, a set-up span under ``torch.profiler``
lies inside its own ``record_function`` event on the trace's clock, and
``profile_trace`` writes the set-up spans closed before it began into its
trace."""

import json
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from critic_vae_tpu_torch.data.synthetic import generate_frames
from critic_vae_tpu_torch.io import weights
from critic_vae_tpu_torch.kernels import build as kb
from critic_vae_tpu_torch.pipelines.video import eval_episode, threshold_sweep
from critic_vae_tpu_torch.train import step as tstep
from critic_vae_tpu_torch.utils import profiling
from critic_vae_tpu_torch.utils.profiling import profile_trace, setup_span, span

torch.set_num_threads(1)  # one intra-op thread a test process: xdist runs several at once

CRITIC_NPZ = "saved-networks/critic-synthetic.npz"
NARROW = dict(dims=(4, 8, 8, 16), bottleneck=256)
CPU = torch.device("cpu")


@pytest.fixture
def record(monkeypatch):
    """A fresh record, as a new process starts with; the process's own is
    put back afterwards."""
    monkeypatch.setattr(profiling, "SETUP_SPANS", [])
    monkeypatch.setattr(profiling, "_SEEN", set())
    return profiling


def _critic():
    return weights.critic_from_params(weights.load_critic_npz(CRITIC_NPZ))


def _episode():
    frames, gt = generate_frames(3, seed=5)
    vae = weights.vae_from_params(*weights.numpy_vae_params(3, **NARROW))
    critic = _critic()
    return lambda: eval_episode(vae, critic, frames, gt, device=CPU, run_crf=False, batch_size=2)


def _sweep():
    frames, gt = generate_frames(3, seed=6)
    vae = weights.vae_from_params(*weights.numpy_vae_params(3, **NARROW))
    critic = _critic()
    return lambda: threshold_sweep(vae, critic, frames, gt, (40, 60), device=CPU, run_crf=False,
                                   batch_size=2)


def _train():
    """Two steps from one state on the same batch and noise, against two
    steps from a copy of that state: a call returns the (losses, state)."""
    frames, _ = generate_frames(4, seed=9)
    batch = torch.from_numpy(frames)
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32), np.float32))
    critic = _critic()
    params = weights.numpy_vae_params(2, **NARROW)

    def run():
        state = tstep.init_train_state(*params, device="cpu")
        step = tstep.make_train_step(critic, learning_rate=5e-5)
        losses = [step(state, batch, eps) for _ in range(2)]
        return losses, {k: v.clone() for k, v in state.vae.state_dict().items()}

    return run


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    return a == b


@pytest.mark.parametrize("key, make", [("video.episode", _episode), ("video.sweep", _sweep),
                                       ("train.step", _train)])
def test_first_call_is_recorded_once_and_outputs_stay_bitwise(record, key, make):
    run = make()
    first = run()
    spans = list(record.SETUP_SPANS)
    assert [(s.name, s.key, s.parent) for s in spans] == [("setup.first_call", key, None)]
    assert 0 < spans[0].start_ns < spans[0].end_ns <= time.time_ns()
    second = run()
    assert record.SETUP_SPANS == spans  # the second call records nothing
    assert _same(first, second)


def test_later_entries_are_the_shared_null_context(record):
    with setup_span("setup.first_call", "test.entry") as opened:
        pass
    assert opened is None and len(record.SETUP_SPANS) == 1
    again = setup_span("setup.first_call", "test.entry")
    assert again is span("test.any")  # the one null context, off the profiler
    with again:
        pass
    assert len(record.SETUP_SPANS) == 1


def test_set_up_spans_name_the_one_open_around_them(record):
    """A capture and the library's load inside a first call name it; the
    library's load on another thread, inside nothing of its own, names
    none; a span that raises still closes."""
    with setup_span("setup.first_call", "test.outer"):
        with setup_span("setup.capture", "test.inner"):
            with setup_span("setup.library", "test.innermost"):
                pass

        def load():
            with setup_span("setup.library", "test.thread"):
                pass

        thread = threading.Thread(target=load)
        thread.start()
        thread.join()
    with pytest.raises(RuntimeError):
        with setup_span("setup.first_call", "test.raises"):
            raise RuntimeError("the body failed")
    got = [(s.name, s.key, s.parent) for s in record.SETUP_SPANS]
    assert got == [("setup.first_call", "test.outer", None), ("setup.capture", "test.inner", 0),
                   ("setup.library", "test.innermost", 1), ("setup.library", "test.thread", None),
                   ("setup.first_call", "test.raises", None)]
    outer, inner, innermost = record.SETUP_SPANS[:3]
    assert outer.start_ns <= inner.start_ns <= innermost.start_ns
    assert innermost.end_ns <= inner.end_ns <= outer.end_ns
    assert all(s.end_ns is not None for s in record.SETUP_SPANS)


def test_set_up_span_under_the_profiler_lies_in_its_own_event(record, tmp_path):
    """After mapping by the trace's ``baseTimeNanoseconds``, the recorded
    span lies inside its ``record_function`` event, within 1 ms."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with setup_span("setup.test_clock", "profiled"):
            torch.zeros(64).add_(1)
            time.sleep(0.01)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"]
              if e.get("name") == "setup.test_clock" and e.get("ph") == "X"]
    assert len(events) == 1
    (s,) = record.SETUP_SPANS
    base = trace["baseTimeNanoseconds"]
    start_us, end_us = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
    ts, dur = events[0]["ts"], events[0]["dur"]
    assert ts - 1000.0 <= start_us and end_us <= ts + dur + 1000.0
    assert dur >= 10_000.0 and end_us - start_us >= 10_000.0


def test_profile_trace_writes_the_earlier_set_up_spans(record, tmp_path):
    with setup_span("setup.first_call", "test.before"):
        with setup_span("setup.library", "test.before"):
            time.sleep(0.002)
    with profile_trace(str(tmp_path / "trace")):
        with span("unit.block"), setup_span("setup.first_call", "test.during"):
            torch.zeros(2).add_(1)
    (path,) = sorted((tmp_path / "trace").rglob("*.pt.trace.json"))
    trace = json.loads(path.read_text())
    setup = [e for e in trace["traceEvents"] if e.get("cat") == "setup"]
    assert [(e["name"], e["args"]["key"], e["args"]["parent"]) for e in setup] == [
        ("setup.first_call", "test.before", None), ("setup.library", "test.before", 0)]
    base = trace["baseTimeNanoseconds"]
    for e, s in zip(setup, record.SETUP_SPANS):
        assert e["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3, abs=1e-3)
    # before the traced work, which names the span opened during it itself
    block = [e for e in trace["traceEvents"] if e.get("name") == "unit.block"]
    during = [e for e in trace["traceEvents"] if e.get("name") == "setup.first_call"
              and e.get("cat") != "setup"]
    assert len(block) == 1 and len(during) == 1
    assert max(e["ts"] + e["dur"] for e in setup) <= block[0]["ts"]


def test_library_span_is_keyed_by_whether_the_library_was_built(record, monkeypatch, tmp_path):
    """The library's load is ``setup.library`` keyed ``build`` where the
    process compiled the library (nvcc stood in for, no card here) and
    ``load`` where a later process finds it."""
    lib = tmp_path / "libcvt_kernels-test.so"
    commands = []

    class Compile:
        returncode = 0

        def __init__(self, command, **kwargs):
            commands.append(command)

        def communicate(self):
            return "", None

    def link(command, **kwargs):
        commands.append(command)
        open(command[command.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(command, 0, "", "")

    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kb, "library_path", lambda: lib)
    monkeypatch.setattr(kb.subprocess, "Popen", Compile)
    monkeypatch.setattr(kb.subprocess, "run", link)
    monkeypatch.setattr(kb.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(kb, "_declare", lambda loaded: loaded)
    monkeypatch.setattr(kb, "_LIB", None)
    assert kb.library() == str(lib) and lib.exists()
    assert len(commands) == len(kb.sources()) + 1  # a compile a source, one link
    monkeypatch.setattr(kb, "_LIB", None)  # a later process: the library is there
    assert kb.library() == str(lib)
    assert len(commands) == len(kb.sources()) + 1
    assert [(s.name, s.key, s.parent) for s in record.SETUP_SPANS] == [
        ("setup.library", "build", None), ("setup.library", "load", None)]


def _setup_trace(record):
    with setup_span("setup.first_call", "test.before"):
        with setup_span("setup.library", "load"):
            time.sleep(0.001)
    return list(enumerate(record.SETUP_SPANS))


def test_set_up_events_are_appended_without_reading_the_trace_back(record, tmp_path,
                                                                   monkeypatch):
    """On the profiler's own layout the events go in before the close of
    ``traceEvents`` with no read of the whole trace; a trace laid out
    otherwise is read and written whole. Both stay JSON, with every event
    they had."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.zeros(2).add_(1)
    kineto = tmp_path / "kineto.json"
    prof.export_chrome_trace(str(kineto))
    before = json.loads(kineto.read_text())
    spans = _setup_trace(record)
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"traceEvents": before["traceEvents"], "traceName": "x]}",
                                 "baseTimeNanoseconds": before["baseTimeNanoseconds"]}))

    def whole(*args, **kwargs):
        raise AssertionError("the whole trace was read back")

    with monkeypatch.context() as m:
        m.setattr(profiling.json, "load", whole)
        profiling._add_setup_events(str(kineto), spans)
    profiling._add_setup_events(str(other), spans)
    for path in (kineto, other):
        trace = json.loads(path.read_text())
        assert trace["traceEvents"][:-2] == before["traceEvents"]
        assert [(e["cat"], e["name"], e["args"]["key"]) for e in trace["traceEvents"][-2:]] == [
            ("setup", "setup.first_call", "test.before"), ("setup", "setup.library", "load")]
        assert trace["traceEvents"][-1]["ts"] == pytest.approx(
            (spans[1][1].start_ns - before["baseTimeNanoseconds"]) / 1e3, abs=1e-3)
