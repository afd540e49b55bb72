"""The host dense CRF: the C++ permutohedral lattice, bound with ctypes
(counterpart of critic_vae_tpu/crf/__init__.py's host functions).

``densecrf.cpp`` beside this file is a byte-identical copy of the JAX
package's (a test compares the bytes), so the masks are bit-identical to its
host CRF. It is built with ``g++ -fopenmp`` at first use into ``_build/``
(gitignored), trying ``-O3 -march=native -funroll-loops`` and then ``-O3``,
with the compiler's resolved target options in the library's name: a
library built for another CPU is never loaded. A missing ``g++`` or a failed
build raises. ctypes releases the GIL during a call, so a refinement can
run on a worker thread beside the device (pipelines/video.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from critic_vae_tpu_torch.crf import DEFAULT_PARAM_GRID, REFERENCE_CRF_PARAMS

SRC = Path(__file__).parent / "densecrf.cpp"
BUILD_DIR = Path(__file__).parent / "_build"

# flag sets tried in order; -march=native is safe because the library is
# built on the machine that loads it (the fingerprint below pins that)
FLAG_SETS = (
    ["-O3", "-march=native", "-funroll-loops"],
    ["-O3"],
)
BASE_FLAGS = ["-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _target_fingerprint(flags) -> bytes:
    """g++'s resolved target options for ``flags``, part of the cache key."""
    try:
        out = subprocess.run(["g++", *flags, "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.encode()
    except Exception:
        return b"unknown-target"


def compile_library() -> Path:
    """Build (or find) the library; returns its path."""
    src = SRC.read_bytes()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    last_err = None
    for flags in FLAG_SETS:
        key = src + " ".join(flags).encode() + _target_fingerprint(flags)
        out = BUILD_DIR / f"libdensecrf-{hashlib.sha256(key).hexdigest()[:16]}.so"
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *flags, *BASE_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found — cannot build the dense CRF extension") from e
        except subprocess.CalledProcessError as e:
            last_err = e.stderr
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError(f"dense CRF build failed:\n{last_err}")


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = compile_library()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # a stale artifact: rebuild from source once
                path.unlink(missing_ok=True)
                lib = ctypes.CDLL(str(compile_library()))
            u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
            lib.densecrf_single.argtypes = [
                u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, u8p,
            ]
            lib.densecrf_single.restype = None
            lib.densecrf_batch.argtypes = [
                u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, u8p, ctypes.c_int,
            ]
            lib.densecrf_batch.restype = None
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def densecrf(img: np.ndarray, prob: np.ndarray, params) -> np.ndarray:
    """One frame: (H, W, 3) uint8 RGB and (H, W, L) class probabilities ->
    (H, W) uint8 argmax labels; ``params`` = (w1, alpha, beta, w2, gamma,
    iters), the reference's ``denseCRF.densecrf`` call shape."""
    img = np.ascontiguousarray(np.squeeze(img), dtype=np.uint8)
    prob = np.ascontiguousarray(prob, dtype=np.float32)
    h, w, n_labels = prob.shape
    if img.shape != (h, w, 3):
        raise ValueError(f"img shape {img.shape} does not match prob {prob.shape}")
    w1, alpha, beta, w2, gamma, iters = params
    out = np.empty((h, w), np.uint8)
    _lib().densecrf_single(_ptr(img, ctypes.c_uint8), _ptr(prob, ctypes.c_float),
                           h, w, n_labels, float(w1), float(alpha), float(beta), float(w2),
                           float(gamma), int(iters), _ptr(out, ctypes.c_uint8))
    return out


def densecrf_batch(imgs: np.ndarray, probs: np.ndarray, params,
                   num_threads: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 frames and (N, H, W, L) probabilities -> (N, H, W)
    uint8 labels, frames in parallel with OpenMP (``num_threads`` 0: its
    default)."""
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    n, h, w, n_labels = probs.shape
    if imgs.shape != (n, h, w, 3):
        raise ValueError(f"imgs shape {imgs.shape} does not match probs {probs.shape}")
    w1, alpha, beta, w2, gamma, iters = params
    out = np.empty((n, h, w), np.uint8)
    _lib().densecrf_batch(_ptr(imgs, ctypes.c_uint8), _ptr(probs, ctypes.c_float),
                          n, h, w, n_labels, float(w1), float(alpha), float(beta), float(w2),
                          float(gamma), int(iters), _ptr(out, ctypes.c_uint8),
                          int(num_threads))
    return out


def refine_masks(frames_u8: np.ndarray, thr_masks: np.ndarray,
                 params=REFERENCE_CRF_PARAMS, num_threads: int = 0) -> np.ndarray:
    """Refine (N, H, W) 0/1 threshold masks of (N, H, W, 3) uint8 frames:
    the class probabilities are the stacked (1 - mask, mask) planes, as the
    reference's ``crf()`` wrapper builds them. Returns (N, H, W) bool."""
    m = np.asarray(thr_masks).astype(np.float32)
    probs = np.stack([1.0 - m, m], axis=-1)
    return densecrf_batch(frames_u8, probs, params, num_threads).astype(bool)


def crf_reference_scaffold(imgs: np.ndarray, mask: np.ndarray, gt: np.ndarray, skip: int = 1,
                           param_grid: Optional[dict] = None, num_threads: int = 0):
    """The reference ``crf()`` wrapper's grid-search scaffold
    (vae_utility.py:22-54), as the JAX package's ``crf_reference_scaffold``,
    on this host CRF, with the reference's quirks: only every ``skip``-th
    frame is refined, in place through the ``mask[::skip]`` view of a copy
    of ``mask``; each combination of ``param_grid`` (default: the reference's
    one-combination grid) re-refines the previous one's output, in
    sequence; each combination's whole-stack IoU is taken against
    ``gt[::skip]``.

    ``mask`` is (N, 1, H, W) float 0/1, the reference's layout. Returns
    (refined, results): the (N, 1, H, W) bool masks, refined at the
    ``::skip`` frames, and the ascending-IoU list of (iou, params)."""
    import itertools

    from critic_vae_tpu_torch.ops.iou import iou

    grid = param_grid or DEFAULT_PARAM_GRID
    combos = [dict(zip(grid.keys(), vals)) for vals in itertools.product(*grid.values())]
    mask = mask.copy()  # like the reference's `mask = mask.copy()`
    view = mask[::skip]  # a view: the refinements land in `mask`
    imgs_s = imgs[::skip]
    gt_s = gt[::skip]
    results = []
    for c in combos:
        params = (c["w1"], c["alpha"], c["beta"], c["w2"], c["gamma"], c["iters"])
        refined = refine_masks(imgs_s, view[:, 0], params, num_threads)
        view[:, 0] = refined  # in place: the next combination re-refines this
        results.append((iou(gt_s, refined, round_digits=None), params))
    results.sort(key=lambda r: r[0])
    return mask >= 1, results
