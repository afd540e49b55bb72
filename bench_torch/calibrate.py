"""Read the check's numbers over many seeds in one process, to set a cell's
limits (the benchmark's own runs never run this).

    python bench_torch/calibrate.py --workload <cell> --seeds 12 --modes program,control
        [--faults] [--first-seed N] [--device cuda|cpu] [--out FILE]

For each mode and seed it builds the cell's set-up from the seed as a run
does, masks or trains as a run's check samples it, and prints the numbers
(one JSON line each, also appended to ``--out``). Modes: ``program`` (the
port as the configuration states it), ``control`` (the port's paths in the
nearest precision below: bf16 nets and the int8 CRF build for video, TF32
for training), and with ``--faults`` every fault of bench_torch/faults.py
that the cell can have. A cell on several cards runs its ranks as run.py
does, every rank through the same seeds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from bench_torch import core, faults  # noqa: E402
from bench_torch.run import RunContext, free_port  # noqa: E402


def _modes(args, cell) -> list:
    modes = [m for m in args.modes.split(",") if m]
    if args.faults:
        if cell.workload["driver"] == "video":
            modes += list(faults.VIDEO)
        else:
            modes += list(faults.TRAIN_RANKS if cell.chips > 1 else faults.TRAIN)
    return modes


def rank_main(rank: int, world: int, port: int, args) -> None:
    import torch

    if world > 1:
        from critic_vae_tpu_torch.parallel.distributed import init_distributed

        init_distributed(f"127.0.0.1:{port}", world, rank, device=args.device)
    device = torch.device("cpu") if args.device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    cell = core.load_cell(args.workload, rehearsal=args.device == "cpu", listed=False)
    drv = core.driver(cell.workload["driver"])
    out = open(args.out, "a") if args.out and rank == 0 else None
    try:
        for mode in _modes(args, cell):
            for k in range(args.seeds):
                seed = args.first_seed + k
                ctx = RunContext(device=device, seed=seed, seconds=0.0, trace=False, rank=rank,
                                 world=world)
                t0 = time.perf_counter()
                try:
                    numbers = drv.readings(cell, ctx, mode)
                    error = None
                except Exception as e:  # a control that crashes has failed: record it
                    numbers, error = {}, f"{type(e).__name__}: {e}"
                if rank == 0:
                    rec = {"workload": args.workload, "mode": mode, "seed": seed,
                           "numbers": numbers, "error": error,
                           "seconds": round(time.perf_counter() - t0, 1)}
                    line = json.dumps(rec)
                    print("READING " + line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def main(argv=None) -> int:
    core.pin_caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload, rehearsal=args.device == "cpu", listed=False)
    if args.device == "cuda":
        core.log(core.card_identity())
    if cell.chips == 1:
        rank_main(0, 1, 0, args)
        return 0
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, cell.chips, port, args))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    return max(abs(p.exitcode or 0) for p in procs)


if __name__ == "__main__":
    sys.exit(main())
