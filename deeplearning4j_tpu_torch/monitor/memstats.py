"""Device memory headroom guards and out-of-memory forensics.

Counterpart of ``deeplearning4j_tpu/monitor/memstats.py``, cut to what
the serving tier calls: :func:`projected_headroom` (:317),
:func:`check_headroom` (:328), :func:`is_resource_exhausted` (:347) and
:func:`oom_error` (:364), over
``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats`` in place of
PJRT's per-device counters. On the CPU no device reports a limit, and
the guards pass, as the JAX package's do on its CPU backend.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.memory import (MemoryExhaustedError,
                                             MemoryHeadroomError)


def _devices() -> List[dict]:
    """Per visible card: bytes in use (PyTorch's allocator), its peak,
    the card's total and free bytes."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_limit": int(total), "bytes_free": int(free)})
    return out


def projected_headroom(device: Optional[torch.device] = None
                       ) -> Optional[int]:
    """Free bytes on ``device`` (a card), counting what PyTorch's caching
    allocator holds but does not use as free; None off the card."""
    if device is None or torch.device(device).type != "cuda":
        return None
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    free, _ = torch.cuda.mem_get_info(idx)
    return int(free + torch.cuda.memory_reserved(idx)
               - torch.cuda.memory_allocated(idx))


def check_headroom(required_bytes: int, what: str,
                   device: Optional[torch.device] = None,
                   margin: float = 1.0) -> None:
    """Raise :class:`MemoryHeadroomError` when ``required_bytes x margin``
    exceeds the projected headroom (no-op off the card)."""
    head = projected_headroom(device)
    if head is None:
        return
    need = int(required_bytes * float(margin))
    if need > head:
        raise MemoryHeadroomError(
            f"{what} needs ~{need / 2**20:.1f} MiB but the card has "
            f"{head / 2**20:.1f} MiB free: refused before the allocator "
            f"fails", required_bytes=need, headroom_bytes=head)


def is_resource_exhausted(exc: BaseException) -> bool:
    """Is this the card's allocation failure?"""
    if isinstance(exc, MemoryExhaustedError):
        return False                 # already converted
    return isinstance(exc, torch.cuda.OutOfMemoryError) or \
        "CUDA out of memory" in str(exc)


def oom_error(cause: BaseException,
              program: Optional[str] = None) -> MemoryExhaustedError:
    """The structured out-of-memory error, the card's counters attached."""
    try:
        devices = _devices()
    except Exception:
        devices = []
    return MemoryExhaustedError(
        f"device memory exhausted during {program or 'execution'}: "
        f"{cause}", program=program, devices=devices)
