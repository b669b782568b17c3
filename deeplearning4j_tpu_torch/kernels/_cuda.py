"""Build and load the port's CUDA C++ kernels.

Each library is one source under ``deeplearning4j_tpu_torch/csrc/``
(``<name>.cu``) with a plain C interface; the Hopper primitives the
sources share are in one header there (``sm90.cuh``). At its first use in a
process, :func:`load` compiles it with ``nvcc`` for Hopper (``sm_90a``),
with ``csrc/`` on the include path, into a shared library under
``deeplearning4j_tpu_torch/_build/cuda/`` (listed in ``.gitignore``),
named by a hash of the source, the shared header and the flags, so an
edited source or header builds anew, and opens it with ``ctypes``. A
kernel's wrapper declares the C functions' argument types and checks each
launch's returned ``cudaError_t``.

Importing this module needs neither ``nvcc`` nor a card: nothing is built
until a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

import torch

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(PACKAGE, "_build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # print each kernel's registers, shared memory and spills
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: one lock a library name: two wrappers of one library (the recurrence
#: engine's) may load it from two threads at once, and build it once
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
#: name -> {"seconds": build time, "log": nvcc's output}, for the builds
#: this process ran
BUILDS: Dict[str, dict] = {}


#: every wrapper's counters (name -> count: launches, copies), registered
#: by the kernel modules at import. A CUDA graph records launches without
#: making them: a captured fit window takes what its recording added back
#: out and adds it again at each replay (``autodiff/window.py``).
COUNTERS: List[Dict[str, int]] = []
#: (counter, name, count): what a span of work added to the counters
Counts = List[Tuple[Dict[str, int], str, int]]


def register_counters(*counters: Dict[str, int]) -> None:
    COUNTERS.extend(counters)


def count_snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in COUNTERS]


def counts_since(snapshot: List[Dict[str, int]]) -> Counts:
    """What the counters gained since ``snapshot`` (a counter registered
    since then started at its values when it was registered: zero)."""
    out = []
    for i, c in enumerate(COUNTERS):
        before = snapshot[i] if i < len(snapshot) else {}
        for k, n in c.items():
            if n != before.get(k, 0):
                out.append((c, k, n - before.get(k, 0)))
    return out


def add_counts(counts: Counts, sign: int = 1) -> None:
    for c, k, n in counts:
        c[k] += sign * n


def source(name: str, csrc: str = CSRC) -> str:
    return os.path.join(csrc, f"{name}.cu")


#: the header of Hopper primitives every kernel source may include
HEADER = os.path.join(CSRC, "sm90.cuh")


def library_path(name: str, csrc: str = CSRC) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the flags, the source's bytes and the shared header's."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source(name, csrc), HEADER):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """nvcc's output (ptxas's registers and spills per kernel) for the
    library built from ``csrc/<name>.cu``; empty if it was not built."""
    try:
        with open(f"{library_path(name)}.log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


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
    """nvcc's command for ``csrc/<name>.cu``; the shared header is found in
    the source's directory, else in the package's ``csrc/`` (a study's
    variant built elsewhere)."""
    return [compiler, *NVCC_FLAGS, "-I", CSRC, "-o", out,
            source(name, csrc)]


def nvcc_version() -> str:
    out = subprocess.run([nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if this
    source has not been built yet."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCKS_GUARD:
            lock = _LOCKS.setdefault(name, threading.Lock())
        with lock:
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
    log = (out.stdout + out.stderr).strip()
    with open(f"{path}.log", "w") as f:     # ptxas's report, kept beside it
        f.write(log)
    os.replace(tmp, path)       # atomic: a concurrent build loses nothing
    BUILDS[name] = {"seconds": time.perf_counter() - t0, "log": log}


def declare(fn, argtypes: Sequence) -> None:
    """Declare a C entry's ``(name, ctypes type)`` arguments and its
    ``int`` (``cudaError_t``) result."""
    fn.argtypes = [t for _, t in argtypes]
    fn.restype = ctypes.c_int


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def rows_aligned(ts) -> bool:
    """Every row of every tensor starts on 16 bytes: the base and every
    stride but the last, as the kernels' 16-byte copies (TMA, cp.async)
    need them."""
    return all(t.data_ptr() % 16 == 0 and all(
        (st * t.element_size()) % 16 == 0 for st in t.stride()[:-1])
        for t in ts)


def copy_unaligned(ts, counter: Dict[str, int], key: str) -> list:
    """The tensors as the kernels read them: each whose rows are not on 16
    bytes replaced by a contiguous copy, counted in ``counter[key]``."""
    out = []
    for t in ts:
        if not rows_aligned([t]):
            t = t.clone(memory_format=torch.contiguous_format)
            counter[key] += 1
        out.append(t)
    return out
