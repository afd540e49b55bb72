"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The build happens at the first kernel launch of the process, so
the first run on a fresh checkout pays the slowest source's ``nvcc``; the
library is named by a hash of its sources, their headers (``csrc/*.cuh``)
and flags, so an edit rebuilds it and a stale library is never loaded.

Fast math is deliberately off: ``--use_fast_math`` swaps in the approximate
``__expf``/``tanhf`` and flushes denormals to zero, which changes the
bilateral row sums of isolated pixels (their off-diagonal terms underflow
towards the 1e-20 floor) and the diff maps' tanh — both are parity surfaces
against the JAX package.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels, and opens a span named
after the kernel around its launch (utils/profiling.py::span), so a
``torch.profiler`` trace names each launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES = {"diff_mask": 0, "bilateral_build": 0, "kernel_i8_build": 0, "matvec_i8": 0,
            "mean_field_resident": 0, "caps_probe": 0, "front_end_probe": 0}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], output: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(output), *map(str, objs)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcvt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen(compile_command(src, obj), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        failed = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        so = Path(tmp) / lib.name
        proc = subprocess.run(link_command(objs, so), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cvt_diff_mask.argtypes = [p, i, i, i, p, p, p]
    lib.cvt_diff_mask.restype = i
    lib.cvt_bilateral_build.argtypes = [p, i, i, i, f, f, f, p, p, p, i, p]
    lib.cvt_bilateral_build.restype = i
    lib.cvt_kernel_i8_build.argtypes = [p, i, i, i, f, f, p, p, p, p]
    lib.cvt_kernel_i8_build.restype = i
    lib.cvt_matvec_i8.argtypes = [p, p, i, i, i, p, p]
    lib.cvt_matvec_i8.restype = i
    lib.cvt_mean_field_resident.argtypes = [p, p, p, i, i, i, i, f, f, f, f, f, i,
                                            p, p, p, p, p, p, p]
    lib.cvt_mean_field_resident.restype = i
    lib.cvt_caps_q1.argtypes = [p, p, p]
    lib.cvt_caps_q2.argtypes = [p, p, p]
    lib.cvt_caps_q3.argtypes = [p, p, p, p]
    lib.cvt_caps_empty.argtypes = [p]
    lib.cvt_front_end_probe.argtypes = [p, p, i, i, i, p, p]
    for fn in (lib.cvt_caps_q1, lib.cvt_caps_q2, lib.cvt_caps_q3, lib.cvt_caps_empty,
               lib.cvt_front_end_probe):
        fn.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(str(build())))
        return _LIB


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
