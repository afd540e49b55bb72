"""The training cells: ``train/step.py::make_multi_step`` on a
device-resident dataset, as ``pipelines/train.py::train`` drives it: one
shuffled epoch a dispatch (``np.random.default_rng(seed)``'s permutation,
the tail dropped; one permutation a shard when the dataset is sharded over
ranks), float32 with TF32 off, the losses read back to the host at each
dispatch's end. The step is called one step at a time, which launches the
same work, so that a CUDA event can be recorded on the stream at each
step's end without a synchronise.

Set-up builds the one training state and drives it from the seed through
its first steps on the first epoch's rows (all different), the first three
checked afterwards and the rest a warm-up of cuDNN's choices; the window
goes on with the same state and epoch. ``train_step_ms`` is the window's
wall time over the steps it completed, ``train_step_p95_ms`` the 95th
percentile of the intervals between consecutive step-end events.

Once the window has closed and the port's state is freed, the plain
reference (reference/train.py) takes the same three steps from the same
weights on the same rows and noise, and the numbers of the check are:

* ``loss_gap``: the largest relative gap of the total loss over the three
  steps;
* ``grad1_gap``: the first gradient as the optimizer got it (Adam's first
  moment after step 1 over 1 − beta1), by the worst leaf: the gap between
  the port's norm and the reference's, over the larger of the reference
  leaf's norm and the median leaf's; ``grad1_median_gap`` the median of
  those gaps over the leaves;
* ``update3_gap``, ``update3_median_gap``: the parameters' change over the
  three steps, likewise by the worst and the median leaf, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (the encoder's conv biases, which train-mode BatchNorm cancels:
  Adam moves them by round-off alone);
* ``bn3_gap``: BatchNorm's running statistics' change over the three
  steps, likewise by the worst buffer.

The worst leaves carry the faults (a leaf left unmoved reads 1); the
median leaves are steady from seed to seed, where a worst leaf's gap
swings with the cancellation in one leaf's gradient (most often the first
conv's weights), and the median gradient is the number that the control,
TF32, fails.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench_torch import core, traffic, tracing, weights

CHECKED_STEPS = 3


@contextlib.contextmanager
def _precision(mode: str):
    """float32 with TF32 off, as ``train`` runs the step; the control turns
    TF32 on in cuDNN's convs and in matmuls (the nearest precision below)."""
    from critic_vae_tpu_torch.device import no_tf32

    if mode != "control":
        with no_tf32():
            yield
        return
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _snapshot(vae, names) -> Dict[str, torch.Tensor]:
    sd = vae.state_dict()
    return {k: sd[k].detach().to("cpu", copy=True) for k in names}


class Epochs:
    """The shuffle of ``train``: one epoch of (steps, B) int32 indices at a
    time, local offsets into this rank's shard when sharded."""

    def __init__(self, seed: int, n: int, batch: int, ranks: int, sharded: bool):
        self.rng = np.random.default_rng(seed)
        self.n, self.batch, self.ranks, self.sharded = n, batch, ranks, sharded

    def draw(self) -> np.ndarray:
        from critic_vae_tpu_torch.train.step import sharded_epoch_indices

        if self.sharded:
            return sharded_epoch_indices(self.rng, self.n, self.batch, self.ranks)
        steps = self.n // self.batch
        order = self.rng.permutation(self.n)
        return order[:steps * self.batch].reshape(steps, self.batch).astype(np.int32)

    def global_rows(self, idx_row: np.ndarray) -> np.ndarray:
        """The dataset rows of one step of the epoch."""
        if not self.sharded:
            return idx_row.astype(np.int64)
        shard, per = self.n // self.ranks, self.batch // self.ranks
        return np.concatenate([d * shard + idx_row[d * per:(d + 1) * per].astype(np.int64)
                               for d in range(self.ranks)])


class Loop:
    """The window's loop: steps one at a time over the epochs, a CUDA event
    after each, the losses to the host at each epoch's end."""

    def __init__(self, multi, state, data, epochs: Epochs, idx: np.ndarray, row: int, device):
        self.multi, self.state, self.data, self.epochs = multi, state, data, epochs
        self.idx_np, self.row, self.device = idx, row, device
        self.idx = torch.from_numpy(idx).to(device)
        self.pending: List[Dict[str, torch.Tensor]] = []
        self.host_losses: List[np.ndarray] = []
        self.events = []
        self.cuda = device.type == "cuda"

    def readback(self) -> None:
        if self.pending:
            self.host_losses.append(torch.cat([p["total_loss"] for p in self.pending]).cpu().numpy())
            self.pending = []

    def step(self) -> Dict[str, torch.Tensor]:
        if self.row == self.idx_np.shape[0]:
            self.readback()
            self.idx_np = self.epochs.draw()
            self.idx = torch.from_numpy(self.idx_np).to(self.device)
            self.row = 0
        out = self.multi(self.state, self.data, self.idx[self.row:self.row + 1])
        self.pending.append(out)
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.row += 1
        return out


class StopRule:
    """When the window ends. One rank ends at its deadline. Over ranks every
    rank must take the same number of steps (each step's all-reduces pair
    up), and their hosts are not in step with one another, so rank 0 alone
    reads the clock and, at its deadline, posts a step count a few steps
    ahead in the process group's store; the other ranks poll the store
    before each step and stop at that count."""

    MARGIN = 8  # steps: more than a rank's host can run ahead of rank 0's
    KEY = "bench_torch_window_steps"

    def __init__(self, ctx, deadline: float):
        import torch.distributed as dist

        self.rank, self.deadline, self.count = ctx.rank, deadline, None
        self.store = dist.distributed_c10d._get_default_store() if ctx.world > 1 else None

    def now(self, steps: int) -> bool:
        if self.store is None:
            return time.perf_counter() >= self.deadline
        if self.count is None:
            if self.rank == 0 and time.perf_counter() >= self.deadline:
                self.count = steps + self.MARGIN
                self.store.set(self.KEY, str(self.count))
            elif self.rank != 0 and self.store.check([self.KEY]):
                self.count = int(self.store.get(self.KEY))
        if self.count is not None and steps > self.count:
            raise RuntimeError(f"rank {self.rank} ran {steps} steps, past the window's {self.count}")
        return self.count is not None and steps == self.count


def _gaps_by_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys):
    """Each leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖): (the worst gap, its leaf, the median gap)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median([rn[k] for k in keys]))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}
    worst = max(keys, key=gaps.get)
    return gaps[worst], worst, float(np.median(list(gaps.values())))


def _numbers(cfg, ref, losses, g1, p0, p3) -> Dict[str, float]:
    from bench_torch.reference.train import is_buffer

    params = [k for k in p0 if not is_buffer(k)]
    buffers = [k for k in p0 if is_buffer(k)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]["total_loss"]))
    g_ref = {k: ref["grad1"][k].cpu() for k in params}
    gnorm = {k: float(torch.linalg.vector_norm(g_ref[k].double())) for k in params}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in params if gnorm[k] >= 1e-3 * med]
    ref_state = {k: v.cpu() for k, v in ref["state"].items()}
    d_prog = {k: p3[k] - p0[k] for k in p0}
    d_ref = {k: ref_state[k] - p0[k] for k in p0}
    grad1, update3, bn3 = (_gaps_by_leaf(g1, g_ref, params), _gaps_by_leaf(d_prog, d_ref, moved),
                           _gaps_by_leaf(d_prog, d_ref, buffers))
    core.log(f"worst leaves: grad1 {grad1[1]}, update3 {update3[1]}, bn3 {bn3[1]}; left out "
             f"of update3: {sorted(set(params) - set(moved))}")
    return {"loss_gap": loss_gap,
            "grad1_gap": grad1[0], "grad1_median_gap": grad1[2],
            "update3_gap": update3[0], "update3_median_gap": update3[2], "bn3_gap": bn3[0]}


def run(cell: core.Cell, ctx, mode: str = "program") -> core.Outcome:
    """One run of a training cell on this rank (``ctx``: run.py's
    RunContext). ``mode`` "control" runs the step with TF32 on
    (calibrate.py)."""
    from critic_vae_tpu_torch.models.critic import Critic
    from critic_vae_tpu_torch.parallel.mesh import make_mesh, row_slice
    from critic_vae_tpu_torch.train import step as ts

    cfg, tr, wl = cell.config, cell.traffic, cell.workload
    device = ctx.device
    batch, n = int(tr["batch_size"]), int(tr["dataset_frames"])
    critic_sd, vae_sd = weights.make(cfg, ctx.seed, device)
    critic = Critic(tuple(cfg["critic_dims"]), cfg["critic_bottleneck"], cfg["channels"])
    weights.load_into(critic, critic_sd)
    critic = critic.to(device).eval().requires_grad_(False)
    state = ts.init_train_state(*weights.jax_layout(cfg, vae_sd), device=device, seed=ctx.seed)
    if not weights.same_state(state.vae, vae_sd):
        raise RuntimeError("the training state does not hold the harness's weights")
    mesh = make_mesh(0, device)
    sharded = mesh.size > 1 and bool(tr.get("shard_dataset", True))
    full = traffic.dataset(ctx.seed, tr, device)
    data = full[row_slice(mesh, n)].clone() if sharded else full
    epochs = Epochs(ctx.seed, n, batch, mesh.size, sharded)
    idx = epochs.draw()
    checked = [full[torch.from_numpy(epochs.global_rows(idx[k])).to(device)].cpu()
               for k in range(CHECKED_STEPS)]
    del full
    multi = ts.make_multi_step(critic, mesh=mesh, learning_rate=cfg["learning_rate"],
                               kld_weight=cfg["kld_weight"],
                               faithful_msssim=cfg["faithful_msssim"],
                               compute_dtype=cfg["compute_dtype"])
    names = list(vae_sd)
    beta1 = cfg["adam"]["beta1"]
    outcome = core.Outcome(end_to_end={}, numbers={}, attempted=0, failed=0,
                           memory_peak_bytes=0)
    with _precision(mode):
        p0 = _snapshot(state.vae, names)
        loop = Loop(multi, state, data, epochs, idx, 0, device)
        losses = []
        for k in range(max(int(wl["warmup_steps"]), CHECKED_STEPS)):
            out = loop.step()
            if k < CHECKED_STEPS:
                losses.append(float(out["total_loss"][0]))
            if k == 0:
                pnames = [nm for nm, _ in state.vae.named_parameters()]
                g1 = {nm: (m / (1 - beta1)).detach().cpu() for nm, m in zip(pnames, state.mu)}
            if k == CHECKED_STEPS - 1:
                p3 = _snapshot(state.vae, names)
        loop.readback()
        loop.events, loop.host_losses = [], []
        ctx.sync()
        ctx.barrier()
        ctx.window_started()
        if ctx.trace:
            steps = int(wl["trace_steps"])
            with tracing.capture(f"train-{ctx.rank}") as box:
                for _ in range(steps):
                    loop.step()
                loop.readback()
            outcome.traced = core.Traced(box["trace"], box["window_s"], steps, steps * batch, cell)
            outcome.busy_s = box["trace"].busy_s()
            outcome.breakdown = box["trace"].breakdown()
        elif not ctx.units:
            start = None
            if loop.cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            stop = StopRule(ctx, t0 + ctx.seconds)
            steps = 0
            while not stop.now(steps):
                loop.step()
                steps += 1
            loop.readback()
            ctx.sync()
            wall = time.perf_counter() - t0
            outcome.end_to_end["train_step_ms"] = 1e3 * wall / steps
            if loop.cuda:
                ends = loop.events
                gaps = [start.elapsed_time(ends[0])] + [a.elapsed_time(b)
                                                        for a, b in zip(ends, ends[1:])]
                outcome.end_to_end["train_step_p95_ms"] = float(np.percentile(gaps, 95))
        else:
            steps = 0
        window_losses = np.concatenate(loop.host_losses) if loop.host_losses else np.zeros(0)
        outcome.attempted = steps
        outcome.failed = int(np.sum(~np.isfinite(window_losses)))
        outcome.memory_peak_bytes = ctx.memory_peak()
        core.log(f"rank {ctx.rank}: steps in the window {steps}, epoch row {loop.row}; "
                 f"losses {losses} (checked steps), window last "
                 f"{window_losses[-1] if window_losses.size else None}; "
                 f"non-finite steps skipped {int(state.total_notfinite)}")
    del state, multi, data, critic, loop
    gc.collect()
    ctx.free()
    if ctx.rank != 0:
        return outcome
    from bench_torch.reference import train as ref_train

    gen = torch.Generator(device=device).manual_seed(int(ctx.seed))
    eps = [torch.randn((batch, cfg["latent_dim"]), generator=gen, device=device,
                       dtype=torch.float32) for _ in range(CHECKED_STEPS)]
    ref = ref_train.steps(cfg, critic_sd, {k: v.to(device) for k, v in p0.items()},
                          [b.to(device) for b in checked], eps)
    outcome.numbers = _numbers(cfg, ref, losses, g1, p0, p3)
    return outcome


def readings(cell: core.Cell, ctx, mode: str) -> Dict[str, float]:
    """The check's numbers for calibrate.py: set-up and its checked steps,
    no window, and the comparison; ``mode`` "program", "control" or a fault
    of bench_torch/faults.py."""
    from bench_torch import faults

    ctx.units = 1
    planted = faults.train(mode) if mode in faults.TRAIN_RANKS else contextlib.nullcontext()
    with planted:
        return run(cell, ctx, "control" if mode == "control" else "program").numbers
