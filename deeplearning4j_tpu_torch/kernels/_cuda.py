"""Build and load the port's CUDA C++ kernels.

Each library is one source under ``deeplearning4j_tpu_torch/csrc/``
(``<name>.cu``) with a plain C interface. At its first use in a process,
:func:`load` compiles it with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``deeplearning4j_tpu_torch/_build/cuda/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source builds anew, and opens it with ``ctypes``. A kernel's wrapper
declares the C functions' argument types and checks each launch's returned
``cudaError_t``.

Importing this module needs neither ``nvcc`` nor a card: nothing is built
until a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(PACKAGE, "_build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # print each kernel's registers, shared memory and spills
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time, "log": nvcc's output}, for the builds
#: this process ran
BUILDS: Dict[str, dict] = {}


def source(name: str, csrc: str = CSRC) -> str:
    return os.path.join(csrc, f"{name}.cu")


def library_path(name: str, csrc: str = CSRC) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the flags and the source's bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(source(name, csrc), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc() -> str:
    """The toolkit's ``nvcc``: under ``$CUDA_HOME``, on ``PATH``, or in
    ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are compiled at their first launch")


def build_command(name: str, out: str, compiler: str = "nvcc",
                  csrc: str = CSRC) -> List[str]:
    return [compiler, *NVCC_FLAGS, "-o", out, source(name, csrc)]


def nvcc_version() -> str:
    out = subprocess.run([nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if this
    source has not been built yet."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            _build(name, path)
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def _build(name: str, path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    out = subprocess.run(build_command(name, tmp, nvcc()),
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{out.stderr}")
    os.replace(tmp, path)       # atomic: a concurrent build loses nothing
    BUILDS[name] = {"seconds": time.perf_counter() - t0,
                    "log": (out.stdout + out.stderr).strip()}


def declare(fn, argtypes: Sequence) -> None:
    """Declare a C entry's ``(name, ctypes type)`` arguments and its
    ``int`` (``cudaError_t``) result."""
    fn.argtypes = [t for _, t in argtypes]
    fn.restype = ctypes.c_int


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
