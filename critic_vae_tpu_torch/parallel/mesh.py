"""The data-parallel mesh (counterpart of critic_vae_tpu/parallel/mesh.py):
one process (rank) a device, the idiom of ``torch.distributed``.

A :class:`Mesh` is this rank's device, its rank and the number of ranks
(``size``, the JAX package's ``mesh.devices.size``). A batch is split along
its first axis in contiguous rows, one block a rank (:func:`shard_batch`);
each rank holds its own copy of the weights, so :func:`replicate` is the
identity; and :func:`fetch` all-gathers the rows so that every rank holds
the whole value, as the JAX package's ``process_allgather(tiled=True)``.
The serving path needs no other collective: its frames are independent.

Deviation from the JAX package: a mesh spans every rank. ``make_mesh(N)``
with N below the number of ranks raises instead of leaving ranks idle,
since a rank outside the mesh would have no device stage to run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

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

    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
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
    return Mesh(device=resolve_device(device), rank=dist.get_rank() if grouped else 0,
                size=world, group=dist.group.WORLD if grouped else None)


def _rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, x):
    """This rank's contiguous block of rows of ``x`` (a batch that divides
    by ``mesh.size``)."""
    return x[_rows(mesh, x.shape[0])]


def row_offset(mesh: Mesh, n: int) -> int:
    """The index of this rank's first row in a batch of ``n`` rows."""
    return _rows(mesh, n).start


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
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts)
    if wire is not src:
        out = out.view(src.dtype)
    return out.to(x.device)
