"""Multi-process initialisation (counterpart of
critic_vae_tpu/parallel/distributed.py) on ``torch.distributed``.

One process (rank) a device: ``init_distributed`` forms the process group
before any device use, and ``make_mesh`` (parallel/mesh.py) then spans the
ranks. The backend is NCCL on the card and gloo for ``--device cpu``.
Launch the ranks with ``python -m torch.distributed.run --nproc-per-node N
-m critic_vae_tpu_torch ...`` (torchrun's variables), or give each process
an address, a count and its index.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the JAX package's coordinator variables (its parallel/distributed.py)
COORDINATOR_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                    "MEGASCALE_COORDINATOR_ADDRESS")
# torchrun's (torch.distributed.run) launcher variables
LAUNCHER_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
OPT_IN_VAR = "CRITIC_VAE_TPU_DISTRIBUTED"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device: str = "cuda") -> bool:
    """Form the process group if a multi-process environment is detected.

    Detection, in the JAX package's order:

    * an explicit ``coordinator_address`` ("host:port"): a TCP rendezvous
      there, with ``num_processes`` and ``process_id`` (else RANK and
      WORLD_SIZE from the environment);
    * the launcher's environment: torchrun's MASTER_ADDR, RANK and
      WORLD_SIZE (``env://``), or one of the JAX package's coordinator
      variables (COORDINATOR_ADDRESS, JAX_COORDINATOR_ADDRESS,
      MEGASCALE_COORDINATOR_ADDRESS) with RANK and WORLD_SIZE;
    * ``CRITIC_VAE_TPU_DISTRIBUTED=1``: ``env://``, torch's own reading of
      the launcher's variables, which raises naming any that is missing.

    The backend is ``nccl`` for ``device="cuda"`` and ``gloo`` for
    ``"cpu"``. On the card each rank first selects its device,
    ``LOCAL_RANK`` (else the rank modulo the cards), so that
    device.py::resolve_device, which takes the current device, gives each
    rank its own card. Returns whether more than one process takes part; a
    no-op returning False without an environment, and when a group exists
    already it only reports its size."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_coord = next((os.environ[v] for v in COORDINATOR_VARS if v in os.environ), None)
    launcher = all(v in os.environ for v in LAUNCHER_VARS)
    opt_in = os.environ.get(OPT_IN_VAR) == "1"
    if coordinator_address is None and env_coord is None and not launcher and not opt_in:
        return False
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(str(device))
    if backend is None:
        raise ValueError(f"unknown device {device!r} (cuda|cpu)")
    address = coordinator_address or (None if launcher else env_coord)
    if address is not None:
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        rank = process_id if process_id is not None else _env_int("RANK")
        if world is None or rank is None:
            raise ValueError(
                f"init_distributed: a coordinator at {address} needs the process count "
                "and this process's index (num_processes and process_id, or WORLD_SIZE "
                "and RANK)")
        kw = dict(init_method=f"tcp://{address}", world_size=world, rank=rank)
    else:
        kw = dict(init_method="env://")
        rank = _env_int("RANK")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = (rank or 0) % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kw)
    return dist.get_world_size() > 1


def world_size() -> int:
    """The number of processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes files and prints results: rank 0, or
    the only process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0
