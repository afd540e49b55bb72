"""The data-parallel mesh (counterpart of critic_vae_tpu/parallel/mesh.py):
one process (rank) a device, the idiom of ``torch.distributed``.

A :class:`Mesh` is this rank's device, its rank and the number of ranks
(``size``, the JAX package's ``mesh.devices.size``). A batch is split along
its first axis in contiguous rows, one block a rank (:func:`shard_batch`);
each rank holds its own copy of the weights, so :func:`replicate` is the
identity; and :func:`fetch` all-gathers the rows so that every rank holds
the whole value, as the JAX package's ``process_allgather(tiled=True)``.
The serving path needs no other collective: its frames are independent.

Training keeps the JAX mesh step's global-batch meaning, which XLA gives
the JAX package for free, with two reductions. :func:`global_mean` turns
per-rank means of equal counts into the global batch's (BatchNorm's
statistics, each MS-SSIM scale's SSIM and CS, KLD, the value-consistency
BCE, the soft Dice); it is an all-reduce SUM that autograd follows, and its
backward is an all-reduce SUM of the incoming gradients, so the
cross-rank terms of the gradient are kept. Each rank then backpropagates
the (replicated) loss over the number of ranks, and :func:`sum_gradients`
sums the parameter gradients over ranks in one flat bucket: the sum is the
global loss's gradient. On gloo the values go through the host, as
:func:`fetch`'s do; on NCCL they stay on the card. A mesh without a group
runs no collective and leaves every value as it is. :func:`fetch`'s gather
opens a span (``mesh.all_gather``; utils/profiling.py::span), so a trace of
a meshed episode shows the time a rank waits on the others apart from the
transfer.

Deviation from the JAX package: a mesh spans every rank. ``make_mesh(N)``
with N below the number of ranks raises instead of leaving ranks idle,
since a rank outside the mesh would have no device stage to run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from critic_vae_tpu_torch.utils.profiling import span

# what gloo's all_gather takes as it is; other dtypes go as bytes
_GLOO_DTYPES = (torch.float32, torch.float64, torch.float16, torch.uint8, torch.int8,
                torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's device, its rank, the number of ranks, and the process
    group (None for a one-rank mesh without a group, which runs no
    collective)."""

    device: torch.device
    rank: int
    size: int
    group: Optional[Any] = None


def make_mesh(num_devices: int = 0, device="cuda") -> Mesh:
    """A mesh over the ranks of the process group, ``device`` (as
    device.py::resolve_device takes it) on this rank. ``num_devices`` 0 is
    every rank; without a group the one process is a one-rank mesh, and
    ``make_mesh(1)`` there runs no collective, as the JAX package's
    ``make_mesh(1)`` in one process. More devices than ranks raise the JAX
    package's ValueError, fewer raise too (the module's note)."""
    from critic_vae_tpu_torch.device import resolve_device

    has_group = dist.is_initialized()
    world = dist.get_world_size() if has_group else 1
    if num_devices and world < num_devices:
        raise ValueError(
            f"requested a {num_devices}-device mesh but only {world} rank(s) are "
            f"running (one device a rank). Launch one process a device: python -m "
            f"torch.distributed.run --nproc-per-node {num_devices} -m critic_vae_tpu_torch "
            f"... (gloo with --device cpu, NCCL on the card, one card a rank)"
        )
    if num_devices and world > num_devices:
        raise ValueError(
            f"requested a {num_devices}-device mesh over {world} ranks: a mesh spans "
            f"every rank (one device a rank); pass --num-devices {world} or 0, or launch "
            f"{num_devices} processes"
        )
    return Mesh(device=resolve_device(device), rank=dist.get_rank() if has_group else 0,
                size=world, group=dist.group.WORLD if has_group else None)


def row_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of a batch of ``n`` rows."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, x):
    """This rank's contiguous block of rows of ``x`` (a batch that divides
    by ``mesh.size``)."""
    return x[row_slice(mesh, x.shape[0])]


def row_offset(mesh: Mesh, n: int) -> int:
    """The index of this rank's first row in a batch of ``n`` rows."""
    return row_slice(mesh, n).start


def replicate(mesh: Mesh, tree: Any) -> Any:
    """The identity: every rank holds its own copy of the weights."""
    return tree


def fetch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order, on every rank
    (the JAX package's ``process_allgather(tiled=True)``), on ``x``'s
    device. A mesh without a group returns ``x``. Gloo gathers on the CPU
    and lacks some dtypes (bool, bf16, int16), so those travel as their
    bytes (uint8); NCCL gathers on the card, bool as uint8."""
    if mesh.group is None:
        return x
    nccl = dist.get_backend(mesh.group) == "nccl"
    src = x.contiguous() if nccl else x.cpu().contiguous()
    wire = src
    if src.dtype == torch.bool or (not nccl and src.dtype not in _GLOO_DTYPES):
        wire = src.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    with span("mesh.all_gather"):
        dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts)
    if wire is not src:
        out = out.view(src.dtype)
    return out.to(x.device)


def grouped(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` runs collectives (it has a process group)."""
    return mesh is not None and mesh.group is not None


def _summed(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``buf``, a contiguous tensor no one else holds,
    on its device: NCCL sums it in place, gloo a host copy."""
    if dist.get_backend(mesh.group) == "nccl":
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        return buf
    host = buf.cpu()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    return host.to(buf.device)


def _all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A new tensor: the sum over ranks of ``x``."""
    return _summed(mesh, x.detach().clone(memory_format=torch.contiguous_format))


class _AllSum(torch.autograd.Function):
    """The sum over ranks; its backward sums the incoming gradients over
    ranks (the rule of ``torch.distributed.nn.functional.all_reduce``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_sum(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(ctx.mesh, grad), None


def global_mean(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of ``x``, each rank's mean of an equal share of
    the global batch: the global batch's mean, on every rank. Autograd
    follows it (the module's note). Without a group, ``x`` itself."""
    if not grouped(mesh):
        return x
    return _AllSum.apply(x, mesh) / mesh.size


def sum_gradients(mesh: Optional[Mesh], grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed over ranks by one all-reduce of one flat bucket,
    as contiguous views of it in ``grads``' shapes. Without a group,
    ``grads`` itself."""
    if not grouped(mesh):
        return grads
    flat = _summed(mesh, torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]
