"""Pluggable trajectory sources for the balanced sampler (a numpy copy of
critic_vae_tpu/data/sources.py: importing it runs the JAX package's
``__init__``, which imports jax).

The reference hard-depends on the ``minerl`` package (Java Minecraft stack)
to stream MineRLTreechop-v0 trajectories (reference: vae_utility.py:393-415).
Here sources are plain generators of ``(name, frames)`` tuples with frames
(T, 64, 64, 3) float32 in [0, 1]:

* :func:`npy_trajectories` — directories/files of raw uint8 frame arrays
  (the X.npy episode format) — the primary, dependency-free path;
* :func:`minerl_trajectories` — the original minerl stream, used only if the
  package is importable (seed-0 trajectory shuffle like the reference,
  vae_utility.py:401);
* :func:`synthetic_trajectories` — generated Minecraft-like scenes for CI
  and benchmarks.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Tuple

import numpy as np

Trajectory = Tuple[str, np.ndarray]


def npy_trajectories(root: str) -> Iterator[Trajectory]:
    """Yield each ``*.npy`` frame array under ``root`` as one trajectory.

    Accepts both loose ``name.npy`` files of (T, H, W, 3) uint8 frames and
    episode directories containing ``X.npy``.
    """
    paths = sorted(glob.glob(os.path.join(root, "*.npy")))
    paths += sorted(glob.glob(os.path.join(root, "*", "X.npy")))
    # an episode directory's Y.npy is ground-truth MASKS, not frames — at
    # (N, 64, 64, 3) uint8 it would pass the shape filter and silently
    # pollute the training set with near-black mask images
    paths = [p for p in paths if os.path.basename(p) != "Y.npy"]
    if not paths:
        raise FileNotFoundError(f"no .npy trajectories under {root}")
    yielded = 0
    skipped = []
    for p in paths:
        frames = np.load(p)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            skipped.append((os.path.relpath(p, root), frames.shape))
            continue
        name = os.path.relpath(p, root)
        yielded += 1
        yield name, frames.astype(np.float32) / 255.0
    if not yielded:
        raise ValueError(
            f"no usable (T, H, W, 3) trajectories under {root}; rejected: "
            + ", ".join(f"{n} {s}" for n, s in skipped[:5])
        )


def minerl_trajectories(
    data_root: str, env: str = "MineRLTreechop-v0", seed: int = 0
) -> Iterator[Trajectory]:
    """Stream minerl trajectories (optional dependency).

    Matches the reference's setup: ``minerl.data.make`` with one worker and a
    numpy seed-0 shuffle of trajectory names (vae_utility.py:398-403).
    """
    import minerl  # noqa: deferred optional import

    os.environ["MINERL_DATA_ROOT"] = data_root
    data = minerl.data.make(env, num_workers=1)
    names = data.get_trajectory_names()
    rng = np.random.default_rng(seed=seed)
    rng.shuffle(names)
    try:
        for name in names:
            frames = []
            for obs, _, _, _, _ in data.load_data(name, skip_interval=0, include_metadata=False):
                frames.append(obs["pov"])
            if frames:
                yield name, np.stack(frames).astype(np.float32) / 255.0
    finally:
        del data  # reference works around a minerl shutdown error the same way


def synthetic_trajectories(
    num_trajectories: int = 8, frames_per_trajectory: int = 512, seed: int = 0
) -> Iterator[Trajectory]:
    """Generated Minecraft-like trajectories (CI / bench stand-in)."""
    from critic_vae_tpu_torch.data.synthetic import generate_frames

    for t in range(num_trajectories):
        frames, _ = generate_frames(frames_per_trajectory, seed=seed + t)
        yield f"synthetic-{t:03d}", frames.astype(np.float32) / 255.0


def open_source(spec: str) -> Iterator[Trajectory]:
    """Resolve a source spec string:

    * ``synthetic[:N[:T]]`` → synthetic trajectories
    * ``minerl:<data_root>`` → minerl stream
    * anything else → a path for :func:`npy_trajectories`
    """
    if spec.startswith("synthetic"):
        parts = spec.split(":")
        n = int(parts[1]) if len(parts) > 1 else 8
        t = int(parts[2]) if len(parts) > 2 else 512
        return synthetic_trajectories(n, t)
    if spec.startswith("minerl:"):
        return minerl_trajectories(spec.split(":", 1)[1])
    return npy_trajectories(spec)
