"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number of the check
with its limit (also the last lines of standard error).

A cell on several cards starts one process a card (rank), forms an NCCL
group over ``tcp://localhost``, and prints rank 0's line once every rank
has ended. Without CUDA, or with fewer cards than the cell asks for, the
run prints no result and exits 1. ``--device cpu`` rehearses a cell on the
CPU at the tiny size of its workload's ``rehearsal`` entries (gloo ranks
for a cell on several cards): it prints the check, never a device metric,
and exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from bench_torch import core  # noqa: E402

REHEARSAL_EXIT = 3


@dataclasses.dataclass
class RunContext:
    """What a driver needs of the run: its rank's device, the seed, the
    window, and the hooks that keep the clocks and memory readings honest."""

    device: object
    seed: int
    seconds: float
    trace: bool
    rank: int = 0
    world: int = 1
    process_start: float = 0.0
    window_start: float = 0.0
    units: int = 0  # > 0: no timed window (calibrate.py): the video driver masks that many episodes

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier()

    def window_started(self) -> None:
        self.window_start = time.time()

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, args: argparse.Namespace, process_start: float,
              queue) -> None:
    """One rank: its device, the process group (several ranks), the cell's
    driver; rank 0 puts its outcome on ``queue`` (or returns it alone)."""
    import torch

    cpu = args.device == "cpu"
    if world > 1:
        from critic_vae_tpu_torch.parallel.distributed import init_distributed

        if cpu:
            torch.set_num_threads(1)
        init_distributed(f"127.0.0.1:{port}", world, rank, device=args.device)
    device = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    cell = core.load_cell(args.workload, rehearsal=cpu)
    ctx = RunContext(device=device, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     rank=rank, world=world, process_start=process_start)
    try:
        out = core.driver(cell.workload["driver"]).run(cell, ctx)
        out.end_to_end["setup_s"] = ctx.window_start - process_start
        if world > 1:
            import torch.distributed as dist

            gathered = [None] * world
            dist.all_gather_object(gathered, (out.busy_s, out.memory_peak_bytes))
            busy = [b for b, _ in gathered if b is not None]
            out.busy_s = sum(busy) / len(busy) if busy else None
            out.memory_peak_bytes = max(m for _, m in gathered)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    if rank == 0:
        if queue is not None:
            queue.put(out)
        return out
    return None


def result_line(cell: core.Cell, out: core.Outcome, trace: bool) -> dict:
    """The result line's object, and whether the run is correct."""
    import torch

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = core.metric_reader(m["name"]).read(out.traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise RuntimeError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    correct, checks = core.judge(out.numbers, cell.workload["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.traced.window_s
        line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    process_start = core.process_start_wall()
    core.pin_caches()
    args = parse(argv)
    cell = core.load_cell(args.workload, rehearsal=args.device == "cpu")
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            sys.stderr.write(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}\n")
            return 1
        from critic_vae_tpu_torch.kernels import build as kb

        core.log(core.card_identity())
        core.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; kernel library cache "
                 f"{'hit' if kb.library_path().exists() else 'miss (built in set-up)'}")
    else:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    if cell.chips > 1:
        import multiprocessing as mp
        import queue as queue_mod

        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=rank_main,
                             args=(r, cell.chips, port, args, process_start,
                                   queue if r == 0 else None))
                 for r in range(cell.chips)]
        for p in procs:
            p.start()
        out = None
        try:
            # wait for rank 0's outcome, or for a rank to fail
            while out is None and not any(p.exitcode for p in procs) and procs[0].exitcode is None:
                try:
                    out = queue.get(timeout=2)
                except queue_mod.Empty:
                    pass
            if out is None and procs[0].exitcode == 0:
                out = queue.get(timeout=30)  # rank 0 ended just after putting it
        finally:
            for p in procs:
                p.join(timeout=120)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if out is None or any(p.exitcode != 0 for p in procs):
            sys.stderr.write(f"rank exit codes {[p.exitcode for p in procs]}\n")
            return 1
    else:
        out = rank_main(0, 1, 0, args, process_start, None)
    if args.device == "cpu":
        correct, checks = core.judge(out.numbers, cell.workload["limits"])
        core.log(f"rehearsal on the CPU: correct {correct}, attempted {out.attempted}, failed "
                 f"{out.failed}; no device metric is printed off CUDA")
        core.print_checks(checks)
        return REHEARSAL_EXIT
    core.log(f"memory peak {out.memory_peak_bytes} bytes on the fullest card; "
             f"end-to-end {out.end_to_end}")
    line = result_line(cell, out, bool(args.trace))
    core.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
