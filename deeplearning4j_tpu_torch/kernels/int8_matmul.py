"""A float32 activation times an int8 weight with a float32 scale a
channel, with a hand-written CUDA C++ kernel for Hopper.

Counterpart of the int8 branches of the JAX package's decode functions
(``deeplearning4j_tpu/zoo/gpt.py`` ``_matmul`` :262-269 and ``_logits``
:283-293): a projection ``(x @ w_i8.astype(f32)) * s[n]`` and the tied
logits ``(x * s_wte[h]) @ wte_i8.astype(f32).T``, the payloads and scales
``gpt_quantize_params`` makes. XLA fused the upcast into the product on the
TPU; written the same way in eager PyTorch the upcast would write a float32
copy of the weight, four times its bytes.

``int8_matmul(x, w, scale)`` is one launch of ``csrc/int8_matmul.cu``
(built by ``kernels/_cuda.py``) on the card: the weight's columns are the
64-row side of Hopper's wgmma and x's rows its n side (8, 16, 32 or 64
rows a block, by M: ``tile_rows``), x cut into three bf16 pieces (int8 is
exact in bf16), each weight tile one TMA box of a tensor map the C side
encodes once a weight; a cluster of 8 blocks a tile of 64 columns, each
an eighth of the K tiles, the eight partials added in rank order, where
the weight has few column tiles, a cluster of 2 halving the K axis where
it has many (``ranks``). Every order of the sums is set by the weight's
shape alone, so a row's result does not depend on M or on the other
rows, and two calls give the same bits. ``transposed=True`` takes ``w``
as ``[N, K]`` (the embedding ``wte``) and ``scale`` as the ``[K]`` scale
of its hidden channels, applied to ``x`` first, as JAX does.

``int8_matmul_plain`` is the JAX expression in torch; the wrapper takes it
only for CPU tensors, and on a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from deeplearning4j_tpu_torch.kernels import _cuda

#: Kernel launches, bumped where the kernel is launched.
LAUNCHES: Dict[str, int] = {"int8_matmul": 0}

_LIB = "int8_matmul"
ENTRY = "dl4j_int8_matmul"
#: columns of y a cluster's tile, depth of a K tile, the rows a tile may
#: take (the MMA's n), and the 64-column tiles from which a cluster of 2
#: halves the K axis (else a cluster of 8 cuts it in eighths), as
#: csrc/int8_matmul.cu sets them
TILE_N, TILE_K, TILE_ROWS, MANY_TILES = 64, 64, (8, 16, 32, 64), 256

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
ARGTYPES = ([(n, _P) for n in ("x", "w", "scale", "y")]
            + [(n, _I64) for n in ("M", "N", "K", "sxm")]
            + [("layout", _I), ("stream", _P)])

_cuda.register_counters(LAUNCHES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entry's argument types declared."""
    lib = _cuda.load(_LIB)
    fn = getattr(lib, ENTRY)
    if fn.argtypes is None:
        _cuda.declare(fn, ARGTYPES)
    return lib


def tile_rows(m: int) -> int:
    """Rows of y a cluster's tile for M rows, as the C entry picks them:
    the least of ``TILE_ROWS`` that holds M, or 64 (more tiles)."""
    return next((r for r in TILE_ROWS if m <= r), TILE_ROWS[-1])


def ranks(n: int) -> int:
    """Blocks a cluster for a weight of N columns, as the C entry picks
    them: 2 from MANY_TILES tiles of 64 columns on, else 8 (set by the
    weight's shape, never by M)."""
    return 2 if -(-n // TILE_N) >= MANY_TILES else 8


def grid_blocks(m: int, n: int) -> int:
    """Blocks of one launch: ``ranks(n)`` a tile of TILE_N columns x
    ``tile_rows(m)`` rows."""
    return -(-n // TILE_N) * -(-m // tile_rows(m)) * ranks(n)


def int8_matmul_plain(x, w, scale, transposed: bool = False):
    """The JAX expression: ``(x @ w.astype(x.dtype)) * scale`` for ``w``
    [K, N], or ``(x * scale) @ w.astype(x.dtype).T`` for ``w`` [N, K]
    (``transposed``), in x's dtype (float64 for a float64 reference)."""
    s = scale.to(x.dtype)
    if transposed:
        return (x * s) @ w.to(x.dtype).t()
    return (x @ w.to(x.dtype)) * s


def abs_terms(x, w, scale, transposed: bool = False):
    """Per output element, the sum of the absolute values of its terms, in
    float64: a kernel that sums the same terms in another order in float32
    lies within a small multiple of 2^-24 times this of the plain
    version."""
    return int8_matmul_plain(x.double().abs(), w.to(torch.int16).abs(),
                             scale.double().abs(), transposed)


def _check(x, w, scale, transposed: bool) -> torch.device:
    """Raise on what the function does not take; returns the device."""
    if x.dim() < 1 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} must be [..., K], w "
                         f"{tuple(w.shape)} 2-d and scale {tuple(scale.shape)}"
                         f" 1-d")
    k = x.shape[-1]
    kw, n = (w.shape[1], w.shape[0]) if transposed else w.shape
    if kw != k or scale.shape[0] != (k if transposed else n):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and scale "
                         f"{tuple(scale.shape)} do not match "
                         f"({'[N, K] and [K]' if transposed else '[K, N] and [N]'})")
    if w.dtype != torch.int8:
        raise ValueError(f"w must be int8, got {w.dtype}")
    dev = x.device
    if w.device != dev or scale.device != dev:
        raise ValueError("x, w and scale must be on one device")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 x and scale, got "
                         f"{x.dtype}, {scale.dtype}")
    if not w.is_contiguous() or not scale.is_contiguous():
        raise ValueError("w and scale must be contiguous")
    return dev


def _rows(x) -> torch.Tensor:
    """x as [M, K] with its last stride 1: a view where the leading axes
    flatten into one stride, else a contiguous copy."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[1] > 1 and x2.stride(1) != 1:
        x2 = x2.contiguous()
    return x2


def _launch(x, w, scale, transposed: bool, lib=None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; ``lib`` is the built
    library (a variant, for studies) or None for the port's."""
    n = w.shape[0] if transposed else w.shape[1]
    x2 = _rows(x)
    m, k = x2.shape
    dev = x.device
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = getattr(lib or _lib(), ENTRY)(
            x2.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n,
            k, x2.stride(0), int(transposed), stream)
    _cuda.check(err, ENTRY)
    return y.view(*x.shape[:-1], n)


def int8_matmul(x, w, scale, transposed: bool = False) -> torch.Tensor:
    """``y [..., N]`` float32: one launch on the card, the plain version on
    the CPU.

    ``x`` [..., K] float32 (any leading shape), ``w`` int8 [K, N] with
    ``scale`` [N] (a projection), or with ``transposed`` ``w`` [N, K] with
    ``scale`` [K] (the tied logits over the embedding)."""
    dev = _check(x, w, scale, transposed)
    if dev.type == "cpu":
        return int8_matmul_plain(x, w, scale, transposed)
    y = _launch(x, w, scale, transposed)
    LAUNCHES["int8_matmul"] += 1
    return y
