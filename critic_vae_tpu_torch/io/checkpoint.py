"""Checkpoint files: nested dicts of numpy arrays as one ``.npz``, with
numpy alone (counterpart of critic_vae_tpu/io/checkpoint.py).

The format is the JAX package's: a stored zip of ``<path>.npy`` entries,
each path the '/'-joined keys of a leaf, which ``np.load`` reads. It is the
format of the JAX package's ``train`` artifacts (``vae_encoder.ckpt``,
``vae_decoder.ckpt``), which both packages read, and of the port's own
training checkpoints (``pipelines/train.py``). Loading is strict: a missing
or extra leaf, or a wrong shape or dtype, raises; nothing falls back to
random weights (the reference's loader does, vae_utility.py:353-357).
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Dict, Tuple

import numpy as np

PREFIX = "ckpt-"  # training checkpoints are PREFIX + step + ".npz"


def flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined key paths of a nested dict -> its leaves as numpy arrays.

    Two leaves whose paths join to the same key (a key holding '/') and
    dtypes that ``.npz`` cannot round-trip (object, raw void such as a
    bfloat16 array's) raise."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            items = flatten(v, f"{key}/").items()
        else:
            arr = np.asarray(v)
            if arr.dtype.hasobject or arr.dtype.kind == "V":
                raise TypeError(f"leaf {key!r} has dtype {arr.dtype}, which .npz cannot "
                                "round-trip losslessly")
            items = ((key, arr),)
        for name, arr in items:
            if name in flat:
                raise ValueError(
                    f"pytree flattens two distinct leaves to the same key {name!r} "
                    "('/'-joined paths collide) — rename the offending fields")
            flat[name] = arr
    return flat


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_pytree(path: str, tree: dict) -> None:
    """Atomically write a nested dict of arrays to ``path``: the zip is
    written directly (``np.savez``'s keywords would collide with its own
    ``file`` parameter for a leaf named "file") into a temporary file that
    then replaces ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    flat = flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
            for key, arr in flat.items():
                with zf.open(f"{key}.npy", "w") as entry:
                    np.lib.format.write_array(entry, arr)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like: dict) -> dict:
    """The arrays of ``path`` in the structure of ``like``: every leaf of
    ``like`` must be stored with its shape and dtype, and the file may hold
    nothing else (an extra leaf means a structurally different model, such
    as a FiLM decoder loaded as a plain one)."""
    with np.load(path) as data:
        stored = {k: np.asarray(data[k]) for k in data.files}
    want = flatten(like)
    for key, leaf in want.items():
        if key not in stored:
            raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
        arr = stored[key]
        if arr.shape != leaf.shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                             f"expected {leaf.shape}")
        if arr.dtype != leaf.dtype:
            raise ValueError(f"checkpoint leaf {key!r} has dtype {arr.dtype}, "
                             f"expected {leaf.dtype}")
    unused = sorted(set(stored) - set(want))
    if unused:
        raise ValueError(
            f"checkpoint {path} carries {len(unused)} leaves the target structure has no "
            f"slot for (e.g. {unused[:3]}); loading would silently drop them — the "
            "artifact belongs to a structurally different model")
    return unflatten({k: stored[k] for k in want})


def _steps(directory: str):
    """(step, file name) of each ``ckpt-{step}.npz`` in ``directory``."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        if name.startswith(PREFIX) and name.endswith(".npz"):
            try:
                found.append((int(name[len(PREFIX):-len(".npz")]), name))
            except ValueError:
                continue
    return found


def latest_checkpoint(directory: str) -> Tuple[str, int] | None:
    """(path, step) of the newest ``ckpt-{step}.npz`` in ``directory``, or None."""
    found = _steps(directory)
    if not found:
        return None
    step, name = max(found)
    return os.path.join(directory, name), step


def prune_checkpoints(directory: str, keep: int) -> None:
    """Delete all but the ``keep`` newest checkpoints (``keep=0`` keeps all)."""
    for _, name in sorted(_steps(directory))[:-keep] if keep else []:
        os.unlink(os.path.join(directory, name))
