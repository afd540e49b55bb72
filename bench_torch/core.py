"""What every cell shares: the specs read by name, the set-up clock, the
card's identity, the result line and the comparison that decides
``correct``.

A cell's specs come from four files: ``BENCHMARK.json`` (which metrics the
cell reports), ``workloads/<cell>.json`` (its driver, configuration,
traffic, sample sizes and limits), ``configs/<config>.json`` and
``traffic/<traffic>.json``. A driver returns a :class:`Outcome`; ``run.py``
turns it into the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"


def process_start_wall() -> float:
    """The wall-clock time at which this process started (from /proc: the
    interpreter's own start-up counts as set-up); the time of the call where
    /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat(5), after pid and comm
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds. The port's kernel library
    already builds into ``critic_vae_tpu_torch/csrc/_build/``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell as its files give it."""

    name: str
    chips: int
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, rehearsal: bool = False, listed: bool = True) -> Cell:
    """The cell ``name``: its entry in ``BENCHMARK.json``, its workload,
    configuration and traffic files, and the metrics it reports. With
    ``rehearsal`` the workload's ``rehearsal`` entries replace the traffic's
    and the workload's own (a tiny size for a CPU run). ``listed=False``
    also takes a workload file that ``BENCHMARK.json`` does not list yet (for
    calibrate.py and the tests), on the traffic's ``ranks`` cards, with no
    metrics."""
    bench = load_json(ROOT / "BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        if listed:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        entry = {"config": workload["config"], "traffic": workload["traffic"],
                 "chips": load_json(HERE / "traffic" / f"{workload['traffic']}.json")["ranks"]}
        bench = {"end_to_end": [], "per_layer": []}
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json names {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    if rehearsal:
        over = workload.get("rehearsal", {})
        traffic = {**traffic, **over.get("traffic", {})}
        workload = {**workload, **over.get("workload", {})}
    return Cell(name=name, chips=int(entry["chips"]), workload=workload, config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(path: Path, name: str):
    """Import a file of the harness by path (driver and metric names hold
    characters, such as '.', that an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"bench_torch_driver_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_torch_metric_" + name.replace(".", "_"))


def log(msg: str) -> None:
    """An information line on standard output, before the result line."""
    print(msg, flush=True)


def card_identity(device_index: int = 0) -> str:
    """The card's name, clocks and power limit (nvidia-smi) and the host's
    CPU, for the lines before the result."""
    parts = []
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        parts.append(f"card: {out.stdout.strip() or out.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        parts.append(f"card: nvidia-smi unavailable ({e})")
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                         "unknown")
    except OSError:
        model = "unknown"
    parts.append(f"host cpu: {model}, {os.cpu_count()} cores")
    return "; ".join(parts)


# ------------------------------------------------------------------ outcome


@dataclasses.dataclass
class Traced:
    """What a traced run hands the per-layer readers: the parsed trace of
    the traced slice (tracing.Trace), the slice's wall seconds, the units it
    ran (episodes or steps) and frames, and the cell."""

    trace: Any
    window_s: float
    units: int
    frames: int
    cell: Cell


@dataclasses.dataclass
class Outcome:
    """A driver's result: the end-to-end values it measured (name -> value),
    the traced slice (with ``--trace 1``), the comparison's numbers (name ->
    value), the work attempted and failed, and the device fields."""

    end_to_end: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    traced: Optional[Traced] = None
    busy_s: Optional[float] = None
    breakdown: Optional[Dict[str, list]] = None


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``correct`` and the checks: every limit needs its number, and each
    number must be finite and at most its limit."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def print_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """Each number compared beside its limit, as the last lines on standard
    error."""
    for name, c in checks.items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit {c['limit']!r})\n")
    sys.stderr.flush()
