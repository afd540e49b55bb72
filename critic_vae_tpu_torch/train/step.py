"""The VAE train step and its multi-step loop (counterpart of
critic_vae_tpu/train/step.py: ``TrainState``, ``_step_logic``,
``make_train_step`` and ``make_multi_step``).

One step: a uint8 batch normalised on the device, the frozen critic's
labels in the compute dtype (under ``no_grad``), encode with train-mode
BatchNorm, reparametrize, the phase-split decode at the labels, MS-SSIM + KL
in float32 (plus the optional value-consistency term), the gradients, and
Adam as optax computes it (b1 0.9, b2 0.999, eps 1e-8 outside the square
root, bias correction by the count; torch's fused Adam) behind the guard of
``optax.apply_if_finite(max_consecutive_errors=100)``: a step whose
gradients are not all finite leaves the parameters and Adam's state as they
are, unless it is more than the 100th such step in a row, when the update
is applied anyway; BatchNorm's running stats move only on a finite step;
the noise generator advances either way.

No step reads anything back to the host: the finite flag is a device
tensor, the skip is the fused Adam's ``found_inf`` and the BN commit a
``torch.where``. State is updated in place, the guard's counters too. Under
a profiler the step opens four spans in turn (:data:`PHASES`):
``train.forward`` (the batch's gather and normalisation, labels, the VAE),
``train.loss``, ``train.backward`` and ``train.update`` (the gradient sum,
the guard, Adam, the BN commit; utils/profiling.py::span).

On CUDA without a process group the step replays as CUDA graphs, so the
card no longer waits on the host's ~1,300 launches a step. Each
``make_*`` closure keeps one signature's graphs (a new signature's capture
frees the old): a signature's first call runs eagerly (cuDNN's choices,
the caching allocator), its second is captured, a graph a phase in one
memory pool, the backward's with the forward's autograd graph retained,
and replayed, and every later call replays, the four phases inside one ``train.replay`` span, each in its
phase's span. Replays compute what eager steps compute: the noise
generator is registered with the forward's graph, so replays draw what
eager steps would from its state (``load_state_tree`` included); the
per-call tensors are copied into static buffers; the losses returned are
copies. A grouped mesh's collectives and the CPU run eagerly. The
process's first step is the set-up span ``setup.first_call`` (key
``train.step``), closed once the card has run it, and each capture
``setup.capture`` (key ``train:`` and its per-call inputs' shapes;
utils/profiling.py::setup_span).

``mesh=`` (parallel/mesh.py: one rank a device) trains data-parallel with
the JAX mesh step's meaning: each rank takes its equal share of the global
batch, BatchNorm takes the global batch's statistics, every loss is the
global batch's (MS-SSIM's per-scale means, KLD, the BCE and the Dice over
ranks before anything nonlinear), each rank backpropagates the loss over
the number of ranks through reductions whose backward sums over ranks, and
the parameter gradients are summed over ranks in one bucket. The state
then stays equal on every rank, and so does the guard's decision, taken on
the summed gradients. A mesh without a process group runs no collective:
one process computes exactly as without a mesh.

``compute_dtype="bfloat16"`` runs the convs and matmuls in bfloat16; the
parameters, Adam's state, BN statistics and the loss stay float32.

``mask_distill > 0`` adds the JAX package's self-distillation term: the
diff map |decode(mu, 0) - decode(mu, v)| in Rec.601 grey, divided by its
per-frame max + 1e-6 (the serving mask signal of ops/mask.py, here plain
differentiable torch: kernel B1 has no backward), is pushed into the
batch's pseudo-label masks by a soft-Dice loss. Its per-frame max is
``amax``, whose backward spreads the gradient over ties as JAX's max does,
and its |.| has JAX's slope 1 at 0.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.optim.adam import adam

from critic_vae_tpu_torch.models.critic import Critic
from critic_vae_tpu_torch.models.vae import VAE
from critic_vae_tpu_torch.ops.losses import vae_loss
from critic_vae_tpu_torch.parallel.mesh import (Mesh, global_mean, grouped, row_slice,
                                                shard_batch, sum_gradients)
from critic_vae_tpu_torch.utils.profiling import setup_span, span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)  # torch defaults, as the reference (vae.py:36)
MAX_CONSECUTIVE_ERRORS = 100
_INT32_MAX = 2**31 - 1  # optax's safe_increment saturates here
VC_CLIP = 1e-6  # value consistency: the critic's outputs are clipped to [eps, 1 - eps]
GREY = (0.2989, 0.5870, 0.1140)  # Rec.601, as ops/mask.py's diff maps
DICE_EPS = 1e-6
PHASES = ("train.forward", "train.loss", "train.backward", "train.update")
# CUDA graph captures (one a signature: a graph a phase) and replayed steps in
# this process, for the tests and chip_smoke.py
GRAPHS = {"captures": 0, "replays": 0}


@dataclasses.dataclass
class TrainState:
    """All mutable training state: the VAE (its parameters and BatchNorm
    running stats), Adam's moments ``mu``/``nu`` (one a parameter, in
    ``vae.parameters()`` order) and its per-parameter counts (torch's fused
    Adam keeps one a parameter; they are equal), the counters of
    ``optax.apply_if_finite``, the reparametrize noise generator and the
    step."""

    vae: VAE
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    counts: List[torch.Tensor]
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor
    generator: torch.Generator
    step: torch.Tensor

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.vae.parameters())


def init_train_state(params, bn_state, *, device, seed: int = 0) -> TrainState:
    """A fresh state from the JAX-layout numpy ``(params, bn_state)`` (FiLM
    when the decoder holds ``film{i}``) on ``device``; the noise generator
    on that device seeded ``seed``. The JAX package draws its initial
    weights from threefry, which torch cannot reproduce: pass
    ``io/weights.py::numpy_vae_params`` (or the JAX package's own draw, for
    parity) here."""
    from critic_vae_tpu_torch.io.weights import vae_from_params

    device = torch.device(device)
    vae = vae_from_params(params, bn_state).to(device).requires_grad_(True)
    ps = list(vae.parameters())

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=device)

    return TrainState(
        vae=vae, mu=[torch.zeros_like(p) for p in ps], nu=[torch.zeros_like(p) for p in ps],
        counts=[scalar(0.0, torch.float32) for _ in ps],
        notfinite_count=scalar(0, torch.int32), last_finite=scalar(True, torch.bool),
        total_notfinite=scalar(0, torch.int32),
        generator=torch.Generator(device=device).manual_seed(seed),
        step=scalar(0, torch.int64))


def _bce_terms(critic: Critic, recon_v, recon_0, target, mesh: Optional[Mesh] = None):
    """The value-consistency loss: the frozen critic must read decode(mu, v)
    as probability v and decode(mu, 0) as 0. ``torch.sigmoid`` of the
    logits, not the critic's op-by-op sigmoid, whose backward is NaN at
    saturated logits. ``mesh``: both means over the global batch."""
    cv = torch.sigmoid(critic(recon_v, return_logits=True)[:, 0]).float()
    c0 = torch.sigmoid(critic(recon_0, return_logits=True)[:, 0]).float()
    cv = torch.clamp(cv, VC_CLIP, 1.0 - VC_CLIP)
    c0 = torch.clamp(c0, VC_CLIP, 1.0 - VC_CLIP)
    bce_v = -(target * torch.log(cv) + (1.0 - target) * torch.log(1.0 - cv))
    mean_v, mean_0 = torch.mean(bce_v), torch.mean(-torch.log(1.0 - c0))
    if grouped(mesh):
        mean_v, mean_0 = global_mean(mesh, torch.stack([mean_v, mean_0])).unbind()
    return mean_v + mean_0


def _dice_term(recon_v, recon_0, masks, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean soft-Dice loss between the per-frame max-normalised grey
    diff of two (B, 3, H, W) decodes and (B, H, W) 0/1 masks; ``mesh``: the
    mean over the global batch."""
    diff = recon_0.float() - recon_v.float()
    # |diff| as JAX differentiates it, slope 1 at 0 (torch.abs's is 0): the
    # decodes are equal in float32 wherever the critic's value rounds away
    d = torch.where(diff >= 0, diff, -diff)
    grey = d[:, 0] * GREY[0] + d[:, 1] * GREY[1] + d[:, 2] * GREY[2]
    dn = grey / (torch.amax(grey, dim=(1, 2), keepdim=True) + DICE_EPS)
    m = masks.float()
    inter = torch.sum(dn * m, dim=(1, 2))
    dice = 1.0 - (2.0 * inter + DICE_EPS) / (
        torch.sum(dn, dim=(1, 2)) + torch.sum(m, dim=(1, 2)) + DICE_EPS)
    return global_mean(mesh, torch.mean(dice))


def _make_local_step(critic: Critic, mesh: Optional[Mesh], *, learning_rate: float = 5e-5,
                     kld_weight: float = 1e-3, faithful_msssim: bool = True,
                     compute_dtype: str = "float32", value_consistency: float = 0.0,
                     mask_distill: float = 0.0) -> Callable:
    """``phases(state, source, idx, eps, masks, retain_graph=False)``: one
    step on this rank's rows of the global batch (with their rows of ``eps``
    and ``masks``), as a generator that runs one phase of :data:`PHASES`
    each ``next`` and yields the losses, the global batch's (the module's
    note), at the last. The batch is ``source``, or with ``idx`` its rows
    ``source[idx]`` gathered on the device, and ``masks`` those rows of
    ``masks``. ``retain_graph`` keeps the forward's autograd graph past the
    backward (a capture keeps its memory)."""
    cdt = DTYPES[compute_dtype]
    meshed = grouped(mesh)

    def phases(state: TrainState, source: torch.Tensor, idx: Optional[torch.Tensor],
               eps: Optional[torch.Tensor], masks: Optional[torch.Tensor],
               retain_graph: bool = False) -> Iterator[Optional[Dict[str, torch.Tensor]]]:
        if mask_distill > 0.0 and masks is None:
            raise ValueError("mask_distill > 0 requires the batch's pseudo-label masks")
        # train.forward
        batch = source
        if idx is not None:
            batch = source.index_select(0, idx)
            masks = None if masks is None else masks.index_select(0, idx)
        if batch.dtype == torch.uint8:
            batch = batch.to(cdt) / 255.0
        x = batch.to(cdt).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            preds = critic(x)[:, 0]
        vae = state.vae
        params = state.params
        recon, mu, logvar, stats = vae.vae_apply(x, preds, eps=eps, generator=state.generator,
                                                 mesh=mesh)
        yield None
        # train.loss
        losses = vae_loss(x.float(), mu.float(), logvar.float(), recon.float(),
                          kld_weight=kld_weight, faithful=faithful_msssim, mesh=mesh)
        if value_consistency > 0.0 or mask_distill > 0.0:
            # the deterministic mu path, where the masks come from
            recon_v = vae.decode(mu, preds)
            recon_0 = vae.decode(mu, torch.zeros_like(preds))
        if value_consistency > 0.0:
            losses["vc_loss"] = value_consistency * _bce_terms(critic, recon_v, recon_0,
                                                               preds.float(), mesh)
            losses["total_loss"] = losses["total_loss"] + losses["vc_loss"]
        if mask_distill > 0.0:
            losses["md_loss"] = mask_distill * _dice_term(recon_v, recon_0, masks, mesh)
            losses["total_loss"] = losses["total_loss"] + losses["md_loss"]
        # each rank's share of the global loss: the reductions' backward and
        # the gradient sum over ranks make up the rest
        objective = losses["total_loss"] / mesh.size if meshed else losses["total_loss"]
        yield None
        # train.backward: the fused Adam reads each gradient as flat memory in
        # its parameter's order, so a channels-last gradient would be applied
        # to the wrong elements
        grads = [g.contiguous() for g in
                 torch.autograd.grad(objective, params, retain_graph=retain_graph)]
        yield None
        # train.update, every counter written in place (a graph holds addresses)
        grads = sum_gradients(mesh, grads)
        with torch.no_grad():
            nonfinite = torch.zeros((), dtype=torch.float32, device=x.device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, nonfinite, torch.ones((), dtype=torch.float32, device=x.device))
            finite = nonfinite == 0
            state.notfinite_count.copy_(torch.where(
                finite, 0, torch.clamp_max(state.notfinite_count + 1, _INT32_MAX)))
            apply = finite | (state.notfinite_count > MAX_CONSECUTIVE_ERRORS)
            adam(params, grads, state.mu, state.nu, [], state.counts, fused=True,
                 found_inf=(~apply).float(), amsgrad=False, lr=learning_rate,
                 weight_decay=0.0, maximize=False, **ADAM)
            for bn, (mean, var) in zip(vae.encoder.bns, stats):
                bn.running_mean.copy_(torch.where(finite, mean, bn.running_mean))
                bn.running_var.copy_(torch.where(finite, var, bn.running_var))
            state.total_notfinite.copy_(torch.where(
                finite, state.total_notfinite,
                torch.clamp_max(state.total_notfinite + 1, _INT32_MAX)))
            state.last_finite.copy_(finite)
            state.step += 1
        yield {k: v.detach() for k, v in losses.items()}

    return phases


def _eager(phases: Callable, state: TrainState, **args) -> Dict[str, torch.Tensor]:
    """One step of ``phases`` run as it comes, each phase in its span."""
    run = phases(state, **args)
    for name in PHASES:
        with span(name):
            out = next(run)
    return out


def graphed(device, mesh: Optional[Mesh]) -> bool:
    """Whether a step on ``device`` over ``mesh`` replays as CUDA graphs: on
    CUDA without a process group (a grouped mesh's collectives run eagerly)."""
    return torch.device(device).type == "cuda" and not grouped(mesh)


class _Captured:
    """One signature's step captured into a CUDA graph a phase, in one
    memory pool: ``varying`` copied into static buffers at each call,
    ``fixed`` (and the state) read and written where they are."""

    def __init__(self, phases: Callable, state: TrainState, fixed: dict, varying: dict):
        shapes = ",".join(f"{k}={'x'.join(map(str, t.shape))}"
                          for k, t in varying.items() if t is not None)
        with setup_span("setup.capture", "train:" + shapes):
            self.state, self.fixed = state, fixed  # the graphs hold their addresses
            self.static = {k: None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                                                  device=state.step.device)
                           for k, t in varying.items()}
            self.graphs = [torch.cuda.CUDAGraph() for _ in PHASES]
            # replays draw the noise eager steps would draw from the generator's state
            self.graphs[0].register_generator_state(state.generator)
            pool = torch.cuda.graph_pool_handle()
            # the generator's frame holds every tensor the graphs read and write
            self.run = phases(state, **fixed, **self.static, retain_graph=True)
            for g in self.graphs:
                with torch.cuda.graph(g, pool=pool):
                    self.losses = next(self.run)
        GRAPHS["captures"] += 1
        print(f"train step: a signature's second call captured as {len(PHASES)} CUDA graphs on "
              f"{state.step.device}; it and every later call of the signature replay them",
              file=sys.stderr)

    def replay(self, varying: dict) -> Dict[str, torch.Tensor]:
        for k, t in varying.items():
            if t is not None:
                self.static[k].copy_(t)
        with span("train.replay"):
            for name, g in zip(PHASES, self.graphs):
                with span(name):
                    g.replay()
        GRAPHS["replays"] += 1
        # copies: a caller keeps a step's losses past the next replay
        return {k: v.clone() for k, v in self.losses.items()}


class _StepGraphs:
    """A ``make_*`` closure's steps, by signature: a signature's first call
    runs eagerly (warming cuDNN and the caching allocator), its second is
    captured and replayed, and every later one replays (:func:`graphed`
    says where; elsewhere every call is eager). The signature: the state's
    identity, each ``fixed`` tensor's address, shape and dtype, each
    ``varying`` tensor's shape and dtype (or its absence), and the precision
    flags in force (TF32 in cuDNN and matmuls, cuDNN's determinism); the
    closure's options, the compute dtype among them, are its own. A closure
    keeps one signature's graphs: capturing another frees them first (their
    pool holds the forward's activations), and its first call is eager."""

    def __init__(self, phases: Callable, mesh: Optional[Mesh]):
        self.phases, self.mesh = phases, mesh
        self.pending = None  # (key, state, fixed) of the last signature run eagerly
        self.captured = None  # (key, _Captured)

    def __call__(self, state: TrainState, fixed: dict, varying: dict) -> Dict[str, torch.Tensor]:
        # the process's first step, until the card has run it: cuDNN's
        # choices, the allocator's growth
        with setup_span("setup.first_call", "train.step", barrier=state.step):
            return self._step(state, fixed, varying)

    def _step(self, state: TrainState, fixed: dict, varying: dict) -> Dict[str, torch.Tensor]:
        if not graphed(state.step.device, self.mesh):
            return _eager(self.phases, state, **fixed, **varying)

        def desc(t, address=False):
            if t is None:
                return None
            return (t.device, t.shape, t.dtype) + ((t.data_ptr(),) if address else ())

        key = (id(state), torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.deterministic,
               tuple((k, desc(t, address=True)) for k, t in fixed.items()),
               tuple((k, desc(t)) for k, t in varying.items()))
        if self.captured is not None and self.captured[0] == key:
            return self.captured[1].replay(varying)
        if self.pending is None or self.pending[0] != key:
            # held, so that no other state or tensor takes its identity or address
            self.pending = (key, state, fixed)
            return _eager(self.phases, state, **fixed, **varying)
        self.pending = self.captured = None  # the old graphs and their pool go first
        self.captured = (key, _Captured(self.phases, state, fixed, varying))
        return self.captured[1].replay(varying)


def make_train_step(critic: Critic, *, mesh: Optional[Mesh] = None, **options) -> Callable:
    """``step(state, batch, eps=None, masks=None) -> losses``: one step on
    ``batch`` (B, H, W, 3), uint8 or float in [0, 1], on the state's device,
    updating ``state`` in place. ``losses``: float32 scalars on the device,
    ``total_loss``, ``recon_loss``, ``kld`` (and ``vc_loss`` with
    ``value_consistency``, ``md_loss`` with ``mask_distill``), this call's
    own. ``eps`` (B, latent) replaces the noise draw (the JAX package's
    draws, for parity); the generator is then not advanced. ``masks`` (B,
    H, W), the batch's pseudo-label masks, are required with ``mask_distill
    > 0``. ``mesh``: ``batch``, ``eps`` and ``masks`` are the global
    batch's, each rank trains on its block of rows (the JAX package's
    ``P("data")``), and the losses are the global batch's on every rank (the
    module's note). On CUDA without a process group the step replays as
    CUDA graphs from a signature's second call, ``batch``, ``eps`` and
    ``masks`` copied in (the module's note).

    ``options``: ``learning_rate`` (5e-5), ``kld_weight`` (1e-3),
    ``faithful_msssim`` (True), ``compute_dtype`` ("float32"),
    ``value_consistency`` (0) and ``mask_distill`` (0)."""
    steps = _StepGraphs(_make_local_step(critic, mesh, **options), mesh)

    def rows(t):
        return t if t is None or mesh is None else shard_batch(mesh, t)

    def step(state: TrainState, batch: torch.Tensor, eps: Optional[torch.Tensor] = None,
             masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return steps(state, {}, dict(source=rows(batch), idx=None, eps=rows(eps),
                                     masks=rows(masks)))

    return step


def make_multi_step(critic: Critic, *, mesh: Optional[Mesh] = None, **options) -> Callable:
    """``multi_step(state, dataset, idx, eps=None, masks=None) -> losses``: K
    steps of :func:`make_train_step` (``options`` are its) over a
    device-resident ``dataset`` (N, H, W, 3), uint8 or float, each batch
    gathered on the device by a row of the int32 (K, B) ``idx``, and with
    ``masks`` (N, H, W), row-aligned with the dataset, its mask rows by the
    same row. The per-step losses stay on the device, stacked to (K,) each
    (the counterpart of the JAX package's ``lax.scan`` loop). ``eps`` (K, B,
    latent) replaces the noise draws. ``mesh``: the dataset (and masks)
    replicated on every rank, and each rank gathers the rows of its column
    block ``[r·B/D, (r+1)·B/D)`` of ``idx`` (the JAX package's ``P(None,
    "data")``) and takes the same rows of ``eps``. On CUDA without a process
    group each step replays as CUDA graphs from a signature's second step:
    the row of ``idx`` (and of ``eps``) is copied in, and the gather runs
    inside the graph from the dataset (and masks) where they are.

    Sharded (the JAX package's ``make_sharded_multi_step``, an alias here),
    rank r holds only its rows ``[r·S, (r+1)·S)`` of the N-frame dataset, S
    = N/D, as ``dataset`` (and ``masks``, row-aligned with it), so device
    memory scales with the ranks; ``idx`` then holds LOCAL offsets laid out
    in rank-block columns (:func:`sharded_epoch_indices`), and each rank
    gathers its column block's batch from its own rows without a
    collective. Everything after the gather (global BatchNorm, the global
    losses, the gradient sum) is the replicated loop's, so the math is
    that on the equivalent global indices."""
    steps = _StepGraphs(_make_local_step(critic, mesh, **options), mesh)

    def multi_step(state: TrainState, dataset: torch.Tensor, idx: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            cols = row_slice(mesh, idx.shape[1])
            idx = idx[:, cols]
            eps = None if eps is None else eps[:, cols]
        rows = [steps(state, dict(source=dataset, masks=masks),
                      dict(idx=idx[k], eps=None if eps is None else eps[k]))
                for k in range(idx.shape[0])]
        return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    return multi_step


make_sharded_multi_step = make_multi_step


def sharded_epoch_indices(rng: np.random.Generator, n: int, batch_size: int,
                          n_devices: int) -> np.ndarray:
    """One epoch of LOCAL batch indices for a sharded :func:`make_multi_step`,
    the JAX package's stream bit for bit: with the dataset in D contiguous
    shards of S = N/D rows, (steps, batch_size) int32 whose column block
    ``[d·B/D, (d+1)·B/D)`` holds offsets into device d's shard, each device
    taking a fresh permutation of its rows (the tail dropped per shard, as
    the reference drops its tail batch, vae.py:44-46)."""
    if batch_size % n_devices:
        raise ValueError(
            f"batch_size {batch_size} must divide over {n_devices} devices"
        )
    if n % n_devices:
        raise ValueError(
            f"sharded dataset needs n ({n}) divisible by the mesh size "
            f"({n_devices}); pad or trim the dataset first"
        )
    s = n // n_devices
    pb = batch_size // n_devices
    steps = s // pb
    if steps == 0:
        raise ValueError(
            f"per-device shard of {s} rows is smaller than the per-device "
            f"batch ({pb})"
        )
    cols = []
    for _ in range(n_devices):
        perm = rng.permutation(s).astype(np.int32)
        cols.append(perm[: steps * pb].reshape(steps, pb))
    return np.concatenate(cols, axis=1)


# ------------------------------------------------------------ the state as numpy


def _running(vae: VAE):
    return [(f"bn{i}", bn) for i, bn in enumerate(vae.encoder.bns)]


def state_tree(state: TrainState) -> dict:
    """The state as a nested dict of numpy arrays (the port's checkpoint
    layout): ``params/<name>`` by torch parameter name, ``bn_state/bn<i>/
    mean|var``, ``opt/mu|nu/<name>``, ``opt/count`` and the guard's
    counters, ``rng`` (the generator's state bytes) and ``step``."""
    names = [n for n, _ in state.vae.named_parameters()]

    def host(t):
        return t.detach().cpu().numpy().copy()

    return {
        "params": {n: host(p) for n, p in zip(names, state.params)},
        "bn_state": {k: {"mean": host(bn.running_mean), "var": host(bn.running_var)}
                     for k, bn in _running(state.vae)},
        "opt": {"mu": {n: host(t) for n, t in zip(names, state.mu)},
                "nu": {n: host(t) for n, t in zip(names, state.nu)},
                "count": np.int32(state.counts[0].item()),
                "notfinite_count": host(state.notfinite_count),
                "last_finite": host(state.last_finite),
                "total_notfinite": host(state.total_notfinite)},
        "rng": state.generator.get_state().numpy().copy(),
        "step": host(state.step),
    }


def load_state_tree(state: TrainState, tree: dict) -> None:
    """Write a :func:`state_tree` (of the same structure) into ``state``."""
    names = [n for n, _ in state.vae.named_parameters()]

    def put(t, a):
        t.copy_(torch.from_numpy(np.asarray(a)).to(t.device))

    with torch.no_grad():
        for n, p, m, v in zip(names, state.params, state.mu, state.nu):
            put(p, tree["params"][n])
            put(m, tree["opt"]["mu"][n])
            put(v, tree["opt"]["nu"][n])
        for k, bn in _running(state.vae):
            put(bn.running_mean, tree["bn_state"][k]["mean"])
            put(bn.running_var, tree["bn_state"][k]["var"])
        for c in state.counts:
            c.fill_(float(tree["opt"]["count"]))
        for key in ("notfinite_count", "last_finite", "total_notfinite"):
            put(getattr(state, key), tree["opt"][key])
        put(state.step, tree["step"])
    state.generator.set_state(torch.from_numpy(np.asarray(tree["rng"], np.uint8).copy()))
