"""Float32 attention on the card's tensor cores: the dense causal forward
and the paged prefill, one hand-written CUDA C++ library.

``csrc/attention_f32.cu`` (built by ``kernels/_cuda.py``) holds both entries
on one tile engine that multiplies in 3xTF32 (each float32 operand split
into two TF32 parts, three ``mma.sync`` products summed in float32), and
beside it the paged prefill's kernel for an int8 cache:

- ``dl4j_attention_fwd_f32``: what ``attention.attention_fwd`` computes for
  float32 (O and the base-2 stats its backward reads), the dense prefill's
  attention (the JAX package's ``scaled_dot_product_attention``,
  ``deeplearning4j_tpu/ops/nn_ops.py:462``, called by ``gpt_decode_fns``
  ``prefill_fn``, ``deeplearning4j_tpu/zoo/gpt.py:306``);
- ``dl4j_paged_prefill_f32``: the paged prefill's attention of one lane's
  rows over its block table (``gpt_paged_decode_fns`` ``prefill_fn``,
  ``deeplearning4j_tpu/zoo/gpt.py:586``, :621-636), over a float32 cache
  or an int8 one (the serving tier's int8 KV, :612-628): with ``k_scale``
  and ``v_scale`` [A, D] the entry launches ``prefill_i8_kernel``, which
  fetches the int8 tiles by bulk copies a tile ahead, turns them into bf16
  (exact) and multiplies on wgmma: ``(q * k_scale) . K_i8`` with ``q *
  k_scale`` in three bf16 pieces, ``(P . V_i8) * v_scale`` with P in three
  pieces, on the float engine's work split and combining launch.

The wrappers here launch them on CUDA tensors only; their callers
(``attention.attention_fwd`` and ``paged_attention.paged_prefill_attention``)
take the plain versions for CPU tensors. Each call cuts a query tile's keys
into work items of ``chunk_keys`` keys, sized from the shapes (and, for the
prefill, from the host's copy of ``kmax``) so that the items fill the card
about once; a tile cut into several items is combined by a second launch,
in item order, counted apart (``LAUNCHES["attention_f32_combine"]``). Two
calls with the same arguments give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import _cuda

#: Kernel launches, bumped where each kernel is launched: the main kernel
#: of each entry, and the combining kernel (either entry's) where a call
#: cuts a tile's keys into several work items.
LAUNCHES: Dict[str, int] = {"attention_fwd_f32": 0, "paged_prefill_f32": 0,
                            "attention_f32_combine": 0}
#: Of the paged prefill's launches, the ones over an int8 cache (counted in
#: both).
INT8_LAUNCHES: Dict[str, int] = {"paged_prefill_f32": 0}
#: Copies of an input whose base or strides were not on 16 bytes (the
#: kernels' 16-byte copies need them), by the wrapper that made them.
ALIGN_COPIES: Dict[str, int] = {"attention_fwd_f32": 0, "paged_prefill_f32": 0}

_LIB = "attention_f32"
#: query rows of a tile, and the unit (keys) of a work item's key range
TILE_ROWS = 64
CHUNK_ALIGN = 64

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double
FWD_ARGTYPES = (
    [(n, _P) for n in ("q", "k", "v", "out", "stats", "part")]
    + [(n, _I64) for n in ("part_floats", "B", "H", "Sq", "Sk", "D", "sqb",
                           "sqh", "sqs", "skb", "skh", "sks", "svb", "svh",
                           "svs")]
    + [("scale", _D), ("causal", _I), ("chunk", _I64), ("stream", _P)])
PREFILL_ARGTYPES = (
    [(n, _P) for n in ("q", "kc", "vc", "k_scale", "v_scale", "table", "kmax",
                       "out", "part")]
    + [(n, _I64) for n in ("part_floats", "N", "A", "D", "BS", "MAXB", "sqn",
                           "sqa", "skb", "ska", "skt", "svb", "sva", "svt")]
    + [("scale", _D), ("chunk", _I64), ("stream", _P)])
OCCUPANCY_ARGTYPES = [("D", _I64), ("kind", _I), ("blocks", _P)]
#: the main kernel's forms, as the occupancy entry takes them: the dense
#: forward, the paged prefill over a float32 cache, and over an int8 one
#: (prefill_i8_kernel)
KINDS = {"dense": 0, "paged": 1, "paged_i8": 2}
ENTRIES = {"dl4j_attention_fwd_f32": FWD_ARGTYPES,
           "dl4j_paged_prefill_f32": PREFILL_ARGTYPES,
           "dl4j_attention_f32_blocks_per_sm": OCCUPANCY_ARGTYPES}

_cuda.register_counters(LAUNCHES, ALIGN_COPIES, INT8_LAUNCHES)


def reset_launches() -> None:
    for d in (LAUNCHES, ALIGN_COPIES, INT8_LAUNCHES):
        for k in d:
            d[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entries' argument types declared."""
    lib = _cuda.load(_LIB)
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            _cuda.declare(fn, argtypes)
    return lib


def blocks_per_sm(d: int, kind: str, lib=None) -> int:
    """The main kernel's resident blocks an SM at head dim ``d`` for
    ``kind`` (a key of :data:`KINDS`), as the card's occupancy calculator
    gives them (needs a card)."""
    n = ctypes.c_int(0)
    err = (lib or _lib()).dl4j_attention_f32_blocks_per_sm(
        d, KINDS[kind], ctypes.addressof(n))
    _cuda.check(err, "dl4j_attention_f32_blocks_per_sm")
    return n.value


@functools.lru_cache(maxsize=None)
def slots(index: int, d: int, kind: str) -> int:
    """Blocks of the main kernel the card ``index`` holds at once
    (``kind`` as :func:`blocks_per_sm`'s)."""
    with torch.cuda.device(index):
        per_sm = blocks_per_sm(d, kind)
    if per_sm < 1:
        raise RuntimeError(f"the attention_f32 kernel at head dim {d}, "
                           f"{kind}, fits no block on an SM of card {index}")
    return torch.cuda.get_device_properties(
        index).multi_processor_count * per_sm


# ----------------------------------------------------------------------
# the work split (what the C side computes per tile, in Python)
def dense_tile_keys(sq: int, sk: int, causal: bool) -> list:
    """Per query tile, the keys it visits: every key for a tile that holds
    a fully masked row (``Sq > Sk``) or without the causal mask, else up
    to its last row's diagonal (the C side's ``tile_key_end``)."""
    off = sk - sq
    out = []
    for q0 in range(0, sq, TILE_ROWS):
        if not causal or q0 + off < 0:
            out.append(sk)
        else:
            out.append(max(0, min(sk, min(q0 + TILE_ROWS, sq) + off)))
    return out


def paged_tile_keys(kmax: Sequence[int], reach: int) -> list:
    """Per tile of ``TILE_ROWS`` rows, its largest ``kmax`` (clamped to
    the table's ``reach``) plus one."""
    k = np.minimum(np.asarray(kmax, dtype=np.int64), reach - 1)
    return [int(k[i:i + TILE_ROWS].max()) + 1
            for i in range(0, len(k), TILE_ROWS)]


def chunk_keys(tile_keys: Sequence[int], heads: int, slots: int) -> int:
    """Keys a work item takes: the smallest multiple of ``CHUNK_ALIGN``
    that cuts every (head, tile)'s key range into items whose count, over
    all heads, fits the card's ``slots`` resident blocks once (at least
    one unit a tile)."""
    units = sum(max(1, -(-k // CHUNK_ALIGN)) for k in tile_keys) * heads
    per = max(1, -(-units // slots))
    return per * CHUNK_ALIGN


def partial_floats(heads: int, rows: int, keys: int, chunk: int,
                   d: int) -> int:
    """The scratch the kernels' work items write their parts to (0 when no
    tile can be cut): per (head, tile, item), O [TILE_ROWS, D] and the
    row's max and sum."""
    items = -(-keys // chunk)
    if items <= 1:
        return 0
    tiles = -(-rows // TILE_ROWS)
    return heads * tiles * items * TILE_ROWS * (d + 2)


def _part(n: int, dev) -> torch.Tensor:
    return torch.empty(max(n, 1), dtype=torch.float32, device=dev)


def _stream(dev) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _count(entry: str, part_floats: int) -> None:
    """Count a call's launches: its entry's main kernel, and the combining
    kernel where the call has partials to combine."""
    LAUNCHES[entry] += 1
    if part_floats > 0:
        LAUNCHES["attention_f32_combine"] += 1


# ----------------------------------------------------------------------
def launch_fwd(q, k, v, out, stats, part, scale: float, causal: bool,
               chunk: int, stream: int, lib=None) -> None:
    """One ``dl4j_attention_fwd_f32`` call (raises on its CUDA error)."""
    b, h, sq, d = q.shape
    err = (lib or _lib()).dl4j_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr(), part.data_ptr(), part.numel(), b, h, sq,
        k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), chunk, stream)
    _cuda.check(err, "dl4j_attention_fwd_f32")


def launch_prefill(q, kc, vc, table, kmax, out, part, scale: float,
                   chunk: int, stream: int, k_scale=None, v_scale=None,
                   lib=None) -> None:
    """One ``dl4j_paged_prefill_f32`` call (raises on its CUDA error);
    ``k_scale``/``v_scale`` [A, D] float32 for an int8 cache, else None."""
    n, a, d = q.shape
    err = (lib or _lib()).dl4j_paged_prefill_f32(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (k_scale, v_scale)),
        table.data_ptr(), kmax.data_ptr(), out.data_ptr(), part.data_ptr(), part.numel(), n,
        a, d, kc.shape[2], table.shape[0], q.stride(0), q.stride(1),
        *kc.stride()[:3], *vc.stride()[:3], scale, chunk, stream)
    _cuda.check(err, "dl4j_paged_prefill_f32")


def attention_fwd_f32(q, k, v, causal: bool, scale: float):
    """(O, stats) of float32 CUDA q, k, v [B, H, S, D] (last stride 1,
    head_dim 16-128), checked by the caller: one call of the
    kernel (two launches when a tile is cut into several items)."""
    q, k, v = _cuda.copy_unaligned((q, k, v), ALIGN_COPIES,
                                   "attention_fwd_f32")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    chunk = chunk_keys(dense_tile_keys(sq, sk, causal), b * h,
                       slots(dev.index, d, "dense"))
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    stats = torch.empty((b, h, sq, 2), dtype=torch.float32, device=dev)
    n_part = partial_floats(b * h, sq, sk, chunk, d)
    part = _part(n_part, dev)
    with torch.cuda.device(dev):
        launch_fwd(q, k, v, out, stats, part, scale, causal, chunk,
                   _stream(dev))
    _count("attention_fwd_f32", n_part)
    return out, stats


def paged_prefill_f32(q, kc, vc, table, kmax, kmax_host: Sequence[int],
                      k_scale=None, v_scale=None):
    """``out [N, A, D]`` of float32 CUDA q [N, A, D], one layer's kc, vc
    [num_blocks, A, BS, D] (float32, or int8 with ``k_scale``/``v_scale``
    [A, D] float32), the lane's ``table`` [MAXB] and ``kmax`` [N] (int32),
    checked by the caller. ``kmax_host``, the same last keys on the host,
    sizes the work items from the rows' real key ranges (the split, never
    what is computed)."""
    q, kc, vc = _cuda.copy_unaligned((q, kc, vc), ALIGN_COPIES,
                                     "paged_prefill_f32")
    n, a, d = q.shape
    reach = kc.shape[2] * table.shape[0]
    dev = q.device
    int8 = kc.dtype == torch.int8
    chunk = chunk_keys(paged_tile_keys(kmax_host, reach), a,
                       slots(dev.index, d, "paged_i8" if int8 else "paged"))
    out = torch.empty((n, a, d), dtype=torch.float32, device=dev)
    n_part = partial_floats(a, n, reach, chunk, d)
    part = _part(n_part, dev)
    with torch.cuda.device(dev):
        launch_prefill(q, kc, vc, table, kmax, out, part,
                       1.0 / math.sqrt(d), chunk, _stream(dev), k_scale,
                       v_scale)
    _count("paged_prefill_f32", n_part)
    if int8:
        INT8_LAUNCHES["paged_prefill_f32"] += 1
    return out
