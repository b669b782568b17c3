"""Inverted dropout whose mask is drawn on the card by the step.

The counterpart of the JAX package's ``dropout`` op
(``deeplearning4j_tpu/ops/random.py:104-114``: ``p`` is the *retain*
probability, ``y = where(keep, x / p, 0)``), which draws its mask with
``jax.random.bernoulli`` from ``fold_in(fold_in(base_key, iteration),
node)`` inside the compiled step (``autodiff/samediff.py:490``,
``:826-829``). It replaces no TPU kernel: it is written by hand because a
CUDA graph replays its launches with the arguments it recorded, so the
draw must read the step's iteration (and the fit's base seed) from device
memory, where the fit tiers stage them before each replay
(``autodiff/window.py``), and no host value may be baked into the graph.

The kernel (``csrc/dropout.cu``, CUDA C++ for ``sm_90a``, built at first
use like the other libraries, ``kernels/_cuda.py``) draws Philox4x32-10
(the generator of cuRAND and PyTorch), written in the source:

- key ``(seed_lo, seed_hi ^ node)``: the fit's base seed and the node's
  index in the graph (the op's position in a ``SameDiff``, the vertex's
  in a ``ComputationGraph``);
- counter ``(g_lo, g_hi, it_lo, it_hi)``: element group ``g = i // 4``
  and the step's absolute iteration; one draw gives the 4 words of
  elements ``4g .. 4g + 3``;
- ``keep = (word >> 8) < ceil(p * 2^24)``, i.e. ``u < p`` for the top
  24 bits as the uniform ``u``. This is the port's convention: JAX draws
  with threefry, so the port's masks are held to distribution tests and
  to their own determinism, not to JAX's bits.

The backward is the same function of ``dy``: the mask is drawn again from
the same key and counter, and no mask is stored. Both run in x's dtype
(bf16, float32, float64), dividing by ``p`` (a multiplication by
``1 / p`` rounds differently for p = 0.8).

:func:`dropout_plain` computes the same generator with int64 torch ops,
each 32 x 32-bit product split into 16-bit halves so that no product
passes 2^63: its masks are the kernel's bit for bit. The wrapper takes it
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. Launches count in :data:`LAUNCHES` (``dropout_fwd`` and
``dropout_bwd``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda

LAUNCHES: Dict[str, int] = {"dropout_fwd": 0, "dropout_bwd": 0}
_cuda.register_counters(LAUNCHES)

_LIB = "dropout"
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the C entry's arguments, in order
ARGTYPES = ([("x", _P), ("y", _P), ("n", _I64), ("seed", _P),
             ("iteration", _P), ("node", _I64), ("threshold", _I64),
             ("p", ctypes.c_double), ("dtype", _I), ("stream", _P)])
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}

#: Philox4x32-10's multipliers and key increments
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entry's argument types declared."""
    lib = _cuda.load(_LIB)
    if lib.dl4j_dropout.argtypes is None:
        _cuda.declare(lib.dl4j_dropout, ARGTYPES)
    return lib


def keep_threshold(p: float) -> int:
    """``ceil(p * 2^24)``: a 24-bit draw ``v`` is kept where ``v <`` it,
    i.e. where ``v / 2^24 < p``."""
    return min(int(math.ceil(float(p) * (1 << 24))), 1 << 24)


# ----------------------------------------------------------------------
# the plain version
def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for 32-bit ``a`` (int64 tensor)
    and the constant ``m``, with no int64 product above 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``ctr`` four
    tensors, ``key`` two (tensors or ints). Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
    return c0, c1, c2, c3


def _host_int(v) -> int:
    return int(v.reshape(-1)[0].item()) if isinstance(v, torch.Tensor) \
        else int(v)


def keep_mask_plain(n: int, seed, iteration, node: int, p: float,
                    device=None) -> torch.Tensor:
    """The kernel's ``keep`` for ``n`` elements, a bool tensor."""
    s, it = _host_int(seed), _host_int(iteration)
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    ctr = (g & _MASK, g >> 32,
           torch.full_like(g, it & _MASK), torch.full_like(g, it >> 32))
    words = philox4x32_10(ctr, (s & _MASK, ((s >> 32) ^ node) & _MASK))
    r = torch.stack(words, dim=1).reshape(-1)[:n]
    return (r >> 8) < keep_threshold(p)


def _divide(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x / p`` rounded as the kernel rounds: a division in x's dtype
    (bf16 in float32, then rounded), by a tensor (a Python scalar divisor
    may become a multiplication by its reciprocal)."""
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (x.to(cdt) / torch.tensor(p, dtype=cdt, device=x.device)
            ).to(x.dtype)


def dropout_plain(x: torch.Tensor, p: float, seed, iteration,
                  node: int) -> torch.Tensor:
    """``where(keep, x / p, 0)`` with the kernel's mask, in x's dtype."""
    keep = keep_mask_plain(x.numel(), seed, iteration, node, p, x.device)
    return torch.where(keep.reshape(x.shape), _divide(x, p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ----------------------------------------------------------------------
# the wrapper
def _check(x: torch.Tensor, seed: torch.Tensor,
           iteration: torch.Tensor) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no dropout kernel for device {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the dropout kernel does not take {x.dtype}")
    for name, t in (("seed", seed), ("iteration", iteration)):
        if t.dtype != torch.int64 or t.numel() != 1 or t.device != dev:
            raise ValueError(f"{name} must be one int64 on {dev}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def dropout_apply(x: torch.Tensor, p: float, seed: torch.Tensor,
                  iteration: torch.Tensor, node: int,
                  name: str = "dropout_fwd") -> torch.Tensor:
    """``where(keep, x / p, 0)``: the plain version for a CPU tensor, one
    kernel launch (counted under ``name``) for a CUDA one."""
    if x.device.type == "cpu":
        return dropout_plain(x, p, seed, iteration, node)
    _check(x, seed, iteration)
    x = x.contiguous()
    y = torch.empty_like(x)
    dev = x.device
    with torch.cuda.device(dev):
        err = _lib().dl4j_dropout(
            x.data_ptr(), y.data_ptr(), x.numel(), seed.data_ptr(),
            iteration.data_ptr(), int(node), keep_threshold(p), float(p),
            _DTYPE_CODE[x.dtype], torch._C._cuda_getCurrentRawStream(
                dev.index))
    _cuda.check(err, name)
    LAUNCHES[name] += 1
    return y


class Dropout(torch.autograd.Function):
    """The forward and backward launches; only ``x`` has a gradient. The
    seed and iteration tensors are kept by reference: a captured step's
    backward reads them at replay."""

    @staticmethod
    def forward(ctx, x, p: float, seed, iteration, node: int):
        ctx.p, ctx.node = p, node
        ctx.save_for_backward(seed, iteration)
        return dropout_apply(x, p, seed, iteration, node, "dropout_fwd")

    @staticmethod
    def backward(ctx, dy):
        seed, iteration = ctx.saved_tensors
        return (dropout_apply(dy, ctx.p, seed, iteration, ctx.node,
                              "dropout_bwd"), None, None, None, None)


def dropout(x: torch.Tensor, p: float, seed: torch.Tensor,
            iteration: torch.Tensor, node: int) -> torch.Tensor:
    """Inverted dropout of ``x`` keeping each element with probability
    ``p``, keyed by ``seed`` and ``node`` and counted by ``iteration``
    (one int64 tensor each, on x's device)."""
    return Dropout.apply(x, float(p), seed, iteration, int(node))
