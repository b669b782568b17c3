"""Attention over a KV cache addressed through block tables, and the
decode step's K/V write, with a hand-written CUDA C++ kernel for Hopper.

Counterpart of the attention inside the JAX package's decode functions
(``deeplearning4j_tpu/zoo/gpt.py``): the paged decode (``decode_fn`` :649,
its K/V scatter :668-674, then :675-690), the paged prefill over its
table (``prefill_fn`` :586, :621-636) and the dense decode over its slot
rows (``gpt_decode_fns`` ``decode_fn`` :354, its masked write :375-382,
then :383-394). There each is a gather of the lane's whole table into a
``[T, D]`` context per layer, scores over all ``T = MAXB * BS`` keys, a
mask to the lane's position, and a ``where`` that zeroes masked V rows so
a stale or NaN block cannot leak; XLA fused it on the TPU, with no Pallas
kernel behind it. Written the same way in eager PyTorch it would copy the
full context for K and V per layer, whatever each lane's real length.

``paged_attention`` computes, for query row ``r`` of lane ``lane[r]``, head
``a`` and last key ``kmax[r]``::

    out[r, a] = sum_{t <= kmax[r]} softmax_t(q[r, a] . K[t] / sqrt(D)) V[t]
    K[t] = kc[tables[lane[r], t // BS], a, t % BS]   (and V from vc)

``paged_decode_attention`` is the decode step's layer: it first writes
each row's new K and V rows (``k_new[r]``, ``v_new[r]``) at
``(write_block[r], write_off[r])`` of the cache (``write_block[r] = -1``:
no write), then computes the same attention. On the card both are one
launch of ``csrc/paged_attention.cu``'s cluster kernel (built by
``kernels/_cuda.py``): eight blocks a (row, head), each taking every
eighth chunk of 16 key positions, their partials combined in distributed
shared memory. It reads only the keys ``t <= kmax[r]`` through the table:
a block past a row's last key is never loaded, so stale or NaN blocks are
harmless by construction, and the order of its sums depends on key
positions alone, so paged and dense decode of one context give the same
bits. The dense slab ``[S, A, max_seq, D]`` is a paged slab with ``BS =
max_seq`` and ``tables[s] = [s]``.

``paged_verify_attention`` is a speculative verify's layer (the JAX
``verify_fn`` :701, its window scatter and write-then-attend :728-751;
dense :406, :437-459): the rows of every lane's window, each writing its
K/V and attending to its own last key, with the keys of its window taken
from the launch's new rows (``win0``, ``wrow``) rather than read back. On
the card it is one launch of the entry ``dl4j_paged_verify_attention``,
counted in ``LAUNCHES``: a cluster of 2 blocks a (group of 8 rows, a
lane's window at W = 8, head), each block taking the decode kernel's 8
ranks in turn (every second one), each chunk of the lane's keys copied
once for the group's rows, each row run with the decode kernel's arithmetic in its
order, so row ``w``'s
output is ``paged_decode_attention``'s at ``kmax = pos0 + w`` over the
same keys, bit for bit. ``paged_verify_plain`` is the JAX
write-then-attend.

``paged_prefill_attention`` is the prefill's form, every row in one lane
over that lane's table: for float32 on the card it launches
``attention_f32``'s ``dl4j_paged_prefill_f32`` (``csrc/attention_f32.cu``,
3xTF32 on the tensor cores, the rows of a tile sharing each key tile
they load), counted in ``attention_f32.LAUNCHES``; float64 takes
``paged_attention`` with every row in lane 0.

Every function takes an int8 cache too (the serving tier's int8 KV: the
JAX decode functions' ``_q_store``/``_q_load``, ``zoo/gpt.py`` :294-304,
paged :576-584): ``kc``/``vc`` int8 with ``k_scale``/``v_scale`` [A, D]
float32, the layer's per-(head, channel) scales. A written row is stored
as :func:`q_store` makes it, ``clip(round(x / s), -127, 127)``; a stored
value is read as :func:`q_load` reads it, ``float(x) * s`` rounded in
float32 and then widened to q's dtype; a row a call writes is attended to
in that stored form (``dequant(quant(k_new))``), as JAX reads it back from
its slab. On the card the same entries run with the scales' pointers (an
int8 ring of chunks, dequantised as read); float64 q runs the same int8
path.

``paged_attention_plain`` is the JAX expression step by step: the gather
by table, scores in float32 (float64 for float64 input), ``where`` with
-1e30, the softmax, the V rows zeroed under the mask. It runs per lane;
for a lane with several rows (a prefill) it zeroes K and V past the lane's
last key and masks each row's scores, as the JAX prefill does with its
``valid`` and causal masks. ``paged_decode_plain`` is the decode
functions' ``index_put_`` of the new rows followed by it. The wrappers
take the plain versions only for CPU tensors; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.evaluation.calibration import quantize_symmetric
from deeplearning4j_tpu_torch.kernels import _cuda, attention_f32

#: Kernel launches, bumped where the kernel is launched, by the wrapper
#: that launched it (all three launch the cluster kernel).
LAUNCHES: Dict[str, int] = {"paged_attention": 0, "paged_decode_attention": 0,
                            "paged_verify_attention": 0}
#: Of those launches, the ones over an int8 cache (each counted in both).
INT8_LAUNCHES: Dict[str, int] = {k: 0 for k in LAUNCHES}

_LIB = "paged_attention"
_MASKED = -1e30
#: what the kernel takes, with the C side's codes
_DTYPE_CODE = {torch.float32: 1, torch.float64: 2}
_HEAD_DIMS = (16, 32, 64, 128)
#: key positions a chunk, and blocks a cluster (csrc/paged_attention.cu)
CHUNK, RANKS = 16, 8

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double
#: k_scale and v_scale: an int8 cache's scales, or null for a float cache
DECODE_ARGTYPES = (
    [(n, _P) for n in ("q", "k_new", "v_new", "kc", "vc", "k_scale",
                       "v_scale", "tables", "lane", "kmax", "write_block",
                       "write_off", "out")]
    + [(n, _I64) for n in ("N", "A", "D", "BS", "MAXB", "NB", "S", "sqn",
                           "sqa", "skb", "ska", "skt", "svb", "sva", "svt")]
    + [("scale", _D), ("dtype", _I), ("stream", _P)])
#: the verify's entry: the decode entry's arguments with each row's window
#: (win0, wrow) after kmax
VERIFY_ARGTYPES = (
    [(n, _P) for n in ("q", "k_new", "v_new", "kc", "vc", "k_scale",
                       "v_scale", "tables", "lane", "kmax", "win0", "wrow",
                       "write_block", "write_off", "out")]
    + DECODE_ARGTYPES[13:])
#: the decode kernel's occupancy: blocks [2] int32 (blocks an SM, clusters
#: the card holds)
OCCUPANCY_ARGTYPES = [("D", _I64), ("dtype", _I), ("int8", _I),
                      ("blocks", _P)]
ENTRY = "dl4j_paged_decode_attention"
VERIFY_ENTRY = "dl4j_paged_verify_attention"
OCCUPANCY_ENTRY = "dl4j_paged_decode_occupancy"
ENTRIES = {ENTRY: DECODE_ARGTYPES, VERIFY_ENTRY: VERIFY_ARGTYPES,
           OCCUPANCY_ENTRY: OCCUPANCY_ARGTYPES}
_cuda.register_counters(LAUNCHES, INT8_LAUNCHES)


def reset_launches() -> None:
    for d in (LAUNCHES, INT8_LAUNCHES):
        for k in d:
            d[k] = 0


def _count(name: str, kc: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    if kc.dtype == torch.int8:
        INT8_LAUNCHES[name] += 1


def _lib() -> ctypes.CDLL:
    """The built library, its C entries' argument types declared."""
    lib = _cuda.load(_LIB)
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            _cuda.declare(fn, argtypes)
    return lib


def decode_occupancy(d: int, dtype: torch.dtype, int8: bool,
                     lib=None) -> Tuple[int, int]:
    """(resident blocks an SM, clusters the card holds at once) of the
    decode kernel at head dim ``d`` for ``dtype`` over a cache of that
    dtype or, with ``int8``, an int8 one, as the card's occupancy
    calculator gives them (needs a card). ``lib``: a built library whose
    entries are declared (a study's variant), else the port's."""
    out = (ctypes.c_int * 2)()
    err = (lib or _lib()).dl4j_paged_decode_occupancy(
        d, _DTYPE_CODE[dtype], int(int8), ctypes.addressof(out))
    _cuda.check(err, OCCUPANCY_ENTRY)
    return out[0], out[1]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Scores and softmax: float32, float64 for float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scale(d: int) -> float:
    """The score scale, 1/sqrt(D), for the kernel and the plain version."""
    return 1.0 / math.sqrt(d)


def q_store(x: torch.Tensor, s) -> torch.Tensor:
    """What a cache stores of rows ``x`` [..., D] at the scales ``s``
    (broadcast over x's trailing axes): for an int8 cache ``clip(round(x /
    s), -127, 127)`` as int8, the JAX ``_q_store`` (the quotient in x's
    dtype, round half to even); ``x`` itself where ``s`` is None."""
    return x if s is None else quantize_symmetric(x, s)


def q_load(x: torch.Tensor, s, dtype: torch.dtype) -> torch.Tensor:
    """A cache's values as the attention reads them: an int8 cache's as
    ``float(x) * s`` rounded in float32 (the JAX ``_q_load``) and then
    widened to ``dtype``; a float cache's (``s`` None) as they are."""
    return x if s is None else (x.to(torch.float32) * s).to(dtype)


def dequantized(kc: torch.Tensor, s) -> torch.Tensor:
    """One layer's cache [num_blocks, A, BS, D] as float32 values (an
    int8 cache at its scales ``s`` [A, D]; a float cache as it is)."""
    return kc if s is None else q_load(kc, s[:, None, :], torch.float32)


# ----------------------------------------------------------------------
def _context_dtype(q, vc, k_scale):
    """The dtype the context is read in: q's for an int8 cache, else the
    cache's."""
    return q.dtype if k_scale is not None else vc.dtype


def _gathered(kc, tab, s, dtype):
    """One lane's cache rows through its table as a ``[A, T, D]`` context
    in ``dtype`` (an int8 cache dequantised at ``s`` [A, D])."""
    a, d = kc.shape[1], kc.shape[3]
    ctx = kc[tab].transpose(0, 1).reshape(a, -1, d)
    return q_load(ctx, None if s is None else s[:, None, :], dtype)


def _write(kc, vc, k_new, v_new, write_block, write_off, k_scale, v_scale):
    """``index_put_`` of each writing row's stored ``k_new``/``v_new`` at
    ``(write_block, write_off)`` of ``kc``/``vc`` (in place)."""
    rows = torch.nonzero(write_block >= 0).flatten()
    if rows.numel():
        heads = torch.arange(k_new.shape[1], device=k_new.device)
        at = (write_block[rows].long()[:, None], heads[None, :],
              write_off[rows].long()[:, None])
        kc.index_put_(at, q_store(k_new[rows], k_scale))
        vc.index_put_(at, q_store(v_new[rows], v_scale))


def paged_attention_plain(q, kc, vc, tables, lane, kmax, k_scale=None,
                          v_scale=None):
    """The JAX expression, per lane: gather the lane's table into a
    ``[A, T, D]`` context (an int8 cache dequantised, :func:`q_load`),
    zero K and V past the lane's last key, scores ``q . K / sqrt(D)`` in the
    accumulation dtype, -1e30 where ``t > kmax[r]``, the softmax, the
    probabilities in the context's dtype times V."""
    n, a, d = q.shape
    bs = kc.shape[2]
    t_len = tables.shape[1] * bs
    acc = acc_dtype(q.dtype)
    cd = _context_dtype(q, vc, k_scale)
    s = _scale(d)
    out = torch.empty((n, a, d), dtype=cd, device=q.device)
    lane, kmax = lane.long(), kmax.long()
    keys = torch.arange(t_len, device=q.device)
    for u in torch.unique(lane).tolist():
        rows = torch.nonzero(lane == u).flatten()
        tab = tables[u].long()
        ctx_k = _gathered(kc, tab, k_scale, cd)
        ctx_v = _gathered(vc, tab, v_scale, cd)
        valid = (keys <= kmax[rows].max())[None, :, None]
        ctx_k = torch.where(valid, ctx_k, 0)
        ctx_v = torch.where(valid, ctx_v, 0)
        mask = keys[None, :] <= kmax[rows][:, None]             # [R, T]
        scores = torch.einsum("rad,atd->rat", q[rows].to(acc),
                              ctx_k.to(acc)) * s
        scores = torch.where(mask[:, None, :], scores, _MASKED)
        probs = torch.softmax(scores, dim=-1).to(cd)
        out[rows] = torch.einsum("rat,atd->rad", probs, ctx_v)
    out[kmax < 0] = 0               # a row with no key: the kernel's 0
    return out


def paged_prefill_plain(q, kc, vc, table, kmax, k_scale=None, v_scale=None):
    """The prefill's function: ``paged_attention_plain`` with every row in
    lane 0 of the one-row table ``table[None]``."""
    lane = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return paged_attention_plain(q, kc, vc, table[None], lane, kmax,
                                 k_scale, v_scale)


def paged_decode_plain(q, k_new, v_new, kc, vc, tables, lane, kmax,
                       write_block, write_off, k_scale=None, v_scale=None):
    """The decode functions' two steps: ``index_put_`` of each writing
    row's ``k_new``/``v_new`` (stored: :func:`q_store`) at ``(write_block,
    write_off)`` of ``kc``/``vc`` (in place), then
    ``paged_attention_plain``, which reads the written rows back."""
    _write(kc, vc, k_new, v_new, write_block, write_off, k_scale, v_scale)
    return paged_attention_plain(q, kc, vc, tables, lane, kmax, k_scale,
                                 v_scale)


def _window_context(kc, vc, table, k_new, v_new, win0, wrow, kmax, k_scale,
                    v_scale, dtype):
    """One lane's gathered ``[A, T, D]`` K and V in ``dtype`` with keys
    ``win0 .. kmax`` (the window's own keys, as far as the table reaches)
    taken from ``k_new``/``v_new`` rows ``wrow + (t - win0)`` in their
    stored form (an int8 cache's ``dequant(quant(row))``)."""
    bs = kc.shape[2]
    t_len = table.shape[0] * bs
    tab = table.long()
    ctx_k = _gathered(kc, tab, k_scale, dtype).clone()
    ctx_v = _gathered(vc, tab, v_scale, dtype).clone()
    hi = min(kmax, t_len - 1)
    if 0 <= win0 <= hi:
        rows = torch.arange(wrow, wrow + hi - win0 + 1, device=kc.device)
        for ctx, new, s in ((ctx_k, k_new, k_scale), (ctx_v, v_new, v_scale)):
            ctx[:, win0:hi + 1] = q_load(q_store(new[rows], s), s,
                                         dtype).transpose(0, 1)
    return ctx_k, ctx_v


def paged_verify_plain(q, k_new, v_new, kc, vc, tables, lane, kmax, win0,
                       wrow, write_block, write_off, k_scale=None,
                       v_scale=None):
    """A speculative verify's layer as the JAX verify functions write it:
    ``index_put_`` of each writing row's stored ``k_new``/``v_new`` at
    ``(write_block, write_off)`` (in place), then each row's attention over
    its lane's table to ``kmax``, with the keys ``win0 .. kmax`` of its
    window taken from the new rows ``wrow + (t - win0)`` in their stored
    form (where every window row writes, what the write put there), the V
    rows past the lane's last key zeroed, scores in the accumulation dtype,
    -1e30 past each row's key, the softmax. A row whose window does not lie
    within the launch's rows (``wrow < 0`` or ``wrow + (kmax - win0) >=
    N``, with ``kmax`` cut to the table's reach) is refused as the kernel
    refuses it: its output is NaN (its write is still made)."""
    _write(kc, vc, k_new, v_new, write_block, write_off, k_scale, v_scale)
    n, a, d = q.shape
    t_len = tables.shape[1] * kc.shape[2]
    acc = acc_dtype(q.dtype)
    cd = _context_dtype(q, vc, k_scale)
    s = _scale(d)
    out = torch.empty((n, a, d), dtype=cd, device=q.device)
    keys = torch.arange(t_len, device=q.device)
    groups: Dict[tuple, list] = {}
    refused = []
    for r, (u, k, w0, wr) in enumerate(zip(lane.tolist(), kmax.tolist(),
                                           win0.tolist(), wrow.tolist())):
        last = min(k, t_len - 1)
        if 0 <= w0 <= last and not (wr >= 0 and wr + (last - w0) < n):
            refused.append(r)
        else:
            groups.setdefault((u, w0, wr), []).append(r)
    km = kmax.long()
    for (u, w0, wr), rows in groups.items():
        rows = torch.tensor(rows, device=q.device)
        top = int(km[rows].max())
        ctx_k, ctx_v = _window_context(kc, vc, tables[u], k_new, v_new, w0,
                                       wr, top, k_scale, v_scale, cd)
        valid = (keys <= top)[None, :, None]
        ctx_k = torch.where(valid, ctx_k, 0)
        ctx_v = torch.where(valid, ctx_v, 0)
        mask = keys[None, :] <= km[rows][:, None]
        scores = torch.einsum("rad,atd->rat", q[rows].to(acc),
                              ctx_k.to(acc)) * s
        scores = torch.where(mask[:, None, :], scores, _MASKED)
        probs = torch.softmax(scores, dim=-1).to(cd)
        out[rows] = torch.einsum("rat,atd->rad", probs, ctx_v)
    out[kmax < 0] = 0
    out[refused] = math.nan
    return out


def abs_terms(q, kc, vc, tables, lane, kmax, k_scale=None, v_scale=None):
    """Per output element, the sum of the absolute values of the terms that
    make it up, ``sum_t p_t |V[t]|``, in float64 (an int8 cache's values
    dequantised): a kernel that sums the same terms in another order, in a
    dtype of unit roundoff u, lies within a small multiple of u times this
    of the plain version."""
    return paged_attention_plain(
        q.double(), dequantized(kc, k_scale).double(),
        dequantized(vc, v_scale).double().abs(), tables, lane, kmax)


# ----------------------------------------------------------------------
def _check(q, kc, vc, tables, lane, kmax, k_scale=None,
           v_scale=None) -> torch.device:
    """Raise on what the function does not take; returns the device."""
    if q.dim() != 3 or kc.dim() != 4 or vc.shape != kc.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [N, A, D] and kc, vc "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)} the same "
                         f"[num_blocks, A, BS, D]")
    n, a, d = q.shape
    if kc.shape[1] != a or kc.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(kc.shape)}")
    if k_scale is None and v_scale is None:
        if not (q.dtype == kc.dtype == vc.dtype):
            raise ValueError(f"q, kc, vc dtypes differ: {q.dtype}, "
                             f"{kc.dtype}, {vc.dtype}")
    else:
        _check_scales(q, kc, vc, k_scale, v_scale)
    if tables.dim() != 2 or kmax.shape != (n,) or (
            lane is not None and lane.shape != (n,)):
        raise ValueError(f"tables {tuple(tables.shape)} must be [S, MAXB], "
                         f"lane {None if lane is None else tuple(lane.shape)}"
                         f" and kmax {tuple(kmax.shape)} [N]")
    dev = q.device
    if any(t is not None and t.device != dev
           for t in (kc, vc, tables, lane, kmax, k_scale, v_scale)):
        raise ValueError("q, the cache, its scales, tables, lane and kmax "
                         "must be on one device")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel does not take {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    for name, t in (("tables", tables), ("lane", lane), ("kmax", kmax)):
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32")
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have its last stride 1, got "
                             f"{t.stride()}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _check_scales(q, kc, vc, k_scale, v_scale) -> None:
    """Raise on an int8 cache the functions do not take: both scales
    [A, D] float32, kc and vc int8, q float32 or float64."""
    a, d = q.shape[1], q.shape[2]
    if k_scale is None or v_scale is None:
        raise ValueError("k_scale and v_scale go together (an int8 cache)")
    if kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise ValueError(f"scales go with an int8 cache, got kc {kc.dtype}, "
                         f"vc {vc.dtype}")
    if q.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"an int8 cache is read in float32 or float64, not "
                         f"{q.dtype}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.shape != (a, d) or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"[A, D] = [{a}, {d}] float32")


def _check_write(q, k_new, v_new, write_block, write_off, dev):
    """Raise on a step's new rows or write places the kernel does not
    take."""
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} and v_new "
                         f"{tuple(v_new.shape)} must be q's {tuple(q.shape)}")
    if not (k_new.dtype == v_new.dtype == q.dtype):
        raise ValueError(f"k_new, v_new dtypes {k_new.dtype}, {v_new.dtype} "
                         f"differ from q's {q.dtype}")
    n = q.shape[0]
    if write_block.shape != (n,) or write_off.shape != (n,):
        raise ValueError(f"write_block {tuple(write_block.shape)} and "
                         f"write_off {tuple(write_off.shape)} must be [N]")
    if any(t.device != dev for t in (k_new, v_new, write_block, write_off)):
        raise ValueError("k_new, v_new, write_block and write_off must be on "
                         "q's device")
    if dev.type == "cpu":
        return
    if k_new.stride() != q.stride() or v_new.stride() != q.stride():
        raise ValueError(f"k_new {k_new.stride()} and v_new {v_new.stride()} "
                         f"must have q's strides {q.stride()}")
    for name, t in (("write_block", write_block), ("write_off", write_off)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")


def _check_verify(q, k_new, v_new, win0, wrow, write_block, write_off, dev):
    """Raise on a verify's new rows, windows or write places the kernel does
    not take."""
    _check_write(q, k_new, v_new, write_block, write_off, dev)
    n = q.shape[0]
    if win0.shape != (n,) or wrow.shape != (n,):
        raise ValueError(f"win0 {tuple(win0.shape)} and wrow "
                         f"{tuple(wrow.shape)} must be [N]")
    if win0.device != dev or wrow.device != dev:
        raise ValueError("win0 and wrow must be on q's device")
    if dev.type == "cpu":
        return
    for name, t in (("win0", win0), ("wrow", wrow)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")


def _launch(q, kc, vc, tables, lane, kmax, write=None, window=None,
            lib=None, scales=None) -> torch.Tensor:
    """One launch of the cluster kernel; ``write`` is (k_new, v_new,
    write_block, write_off) or None; ``window`` is (win0, wrow), a verify's
    windows (the verify entry), or None; ``lib`` is the built library (a
    variant of the source, for studies) or None for the port's; ``scales``
    is an int8 cache's (k_scale, v_scale) or None. The cache is read in
    16-byte slices and written in place, so it is not copied: its rows
    must start on 16 bytes."""
    if not _cuda.rows_aligned([kc, vc]):
        raise ValueError("the cache's rows must start on 16 bytes (its base "
                         "and strides)")
    n, a, d = q.shape
    dev = q.device
    out = torch.empty((n, a, d), dtype=q.dtype, device=dev)
    k_new, v_new, wb, wo = [None if t is None else t.data_ptr()
                            for t in (write or (None,) * 4)]
    ks, vs = [None if t is None else t.data_ptr()
              for t in (scales or (None,) * 2)]
    bs, maxb = kc.shape[2], tables.shape[1]
    entry = ENTRY if window is None else VERIFY_ENTRY
    win = () if window is None else tuple(t.data_ptr() for t in window)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = getattr(lib or _lib(), entry)(
            q.data_ptr(), k_new, v_new, kc.data_ptr(), vc.data_ptr(), ks, vs,
            tables.data_ptr(), lane.data_ptr(), kmax.data_ptr(), *win, wb, wo,
            out.data_ptr(), n, a, d, bs, maxb, kc.shape[0], tables.shape[0],
            q.stride(0), q.stride(1), *kc.stride()[:3], *vc.stride()[:3],
            _scale(d), _DTYPE_CODE[q.dtype], stream)
    _cuda.check(err, entry)
    return out


def _scales(k_scale, v_scale):
    return None if k_scale is None else (k_scale, v_scale)


def paged_attention(q, kc, vc, tables, lane, kmax, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """``out [N, A, D]`` (contiguous, q's dtype): one launch on the card;
    the plain version on the CPU.

    ``q`` [N, A, D] (any row and head strides), ``kc``/``vc`` one layer's
    [num_blocks, A, BS, D] cache (q's dtype, or int8 with ``k_scale`` and
    ``v_scale`` [A, D] float32), ``tables`` [S, MAXB], ``lane`` [N] (the
    table row of each query row) and ``kmax`` [N] (its last key) int32."""
    dev = _check(q, kc, vc, tables, lane, kmax, k_scale, v_scale)
    if dev.type == "cpu":
        return paged_attention_plain(q, kc, vc, tables, lane, kmax, k_scale,
                                     v_scale)
    out = _launch(q, kc, vc, tables, lane, kmax,
                  scales=_scales(k_scale, v_scale))
    _count("paged_attention", kc)
    return out


def paged_decode_attention(q, k_new, v_new, kc, vc, tables, lane, kmax,
                           write_block, write_off, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """A decode step's layer: each row's new K/V rows written into the
    cache, then ``out [N, A, D]`` (contiguous, q's dtype) as
    ``paged_attention`` computes it; one launch on the card, the plain
    version (``index_put_``, then ``paged_attention_plain``) on the CPU.

    ``k_new``/``v_new`` [N, A, D] at q's strides are the step's rows;
    ``write_block``/``write_off`` [N] int32 say where row ``r``'s rows land
    in ``kc``/``vc`` (updated in place): ``kc[write_block[r], :,
    write_off[r]]``; ``write_block[r] = -1`` writes nothing. The other
    arguments are ``paged_attention``'s.

    The contract (both decode functions keep it): a row with a write has
    ``(write_block[r], write_off[r])`` where its key ``kmax[r]`` lies
    through its table, ``(tables[lane[r], kmax[r] // BS], kmax[r] % BS)``,
    and no other row reads that key (at decode each lane has one row and
    writes into its own tail block). The kernel then takes ``k_new[r]`` and
    ``v_new[r]`` as key ``kmax[r]``'s K and V, the bits the write stores
    (an int8 cache's stored row, dequantised), and never reads them back.
    A write outside the cache is dropped."""
    dev = _check(q, kc, vc, tables, lane, kmax, k_scale, v_scale)
    _check_write(q, k_new, v_new, write_block, write_off, dev)
    if dev.type == "cpu":
        return paged_decode_plain(q, k_new, v_new, kc, vc, tables, lane,
                                  kmax, write_block, write_off, k_scale,
                                  v_scale)
    out = _launch(q, kc, vc, tables, lane, kmax,
                  (k_new, v_new, write_block, write_off),
                  scales=_scales(k_scale, v_scale))
    _count("paged_decode_attention", kc)
    return out


def paged_verify_attention(q, k_new, v_new, kc, vc, tables, lane, kmax, win0,
                           wrow, write_block, write_off, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """A speculative verify's layer: ``out [N, A, D]`` (contiguous, q's
    dtype) of the rows of every lane's window, one launch of the verify
    entry on the card, ``paged_verify_plain`` on the CPU.

    Row ``r`` (of lane ``lane[r]``, last key ``kmax[r]``) writes its new
    K/V rows ``k_new[r]``/``v_new[r]`` at ``(write_block[r],
    write_off[r])`` (-1: no write, as ``paged_decode_attention``), and
    attends to keys ``0 .. kmax[r]``: those below ``win0[r]`` read from
    the cache through its table, the keys ``win0[r] .. kmax[r]`` taken
    from the new rows ``wrow[r] + (t - win0[r])`` (``win0[r]`` -1: none).
    A verify hands row ``w`` of lane ``s``'s window (``r = s W + w``) the
    lane's first window position ``pos0`` as ``win0`` and ``s W`` as
    ``wrow``, so that its window keys are the rows the same launch writes,
    never read back: row ``w``'s output is then ``paged_decode_attention``'s
    at ``kmax = pos0 + w`` over the same keys, bit for bit on the card.
    ``win0``/``wrow`` [N] int32; the other arguments are
    ``paged_decode_attention``'s. Any window length runs in one launch.
    A row whose window runs past the launch's rows (``wrow[r] + (kmax[r] -
    win0[r]) >= N``) or has ``wrow[r] < 0`` is refused, on the card and on
    the CPU alike: its output is NaN (the kernel cannot raise without a
    host sync; reading those keys from the cache would read slots the
    launch writes)."""
    dev = _check(q, kc, vc, tables, lane, kmax, k_scale, v_scale)
    _check_verify(q, k_new, v_new, win0, wrow, write_block, write_off, dev)
    if dev.type == "cpu":
        return paged_verify_plain(q, k_new, v_new, kc, vc, tables, lane,
                                  kmax, win0, wrow, write_block, write_off,
                                  k_scale, v_scale)
    out = _launch(q, kc, vc, tables, lane, kmax,
                  (k_new, v_new, write_block, write_off), (win0, wrow),
                  scales=_scales(k_scale, v_scale))
    _count("paged_verify_attention", kc)
    return out


def paged_prefill_attention(q, kc, vc, table, kmax, kmax_host, k_scale=None,
                            v_scale=None):
    """``out [N, A, D]`` (contiguous, q's dtype) of one lane's prefill rows
    over its block table: float32 on the card, one call of the tensor-core
    kernel; float64 on the card, ``paged_attention`` with every row in lane
    0; the plain version on the CPU.

    ``q`` [N, A, D] (any row and head strides), ``kc``/``vc`` one layer's
    [num_blocks, A, BS, D] cache (q's dtype, or int8 with ``k_scale`` and
    ``v_scale`` [A, D] float32), ``table`` [MAXB] and ``kmax`` [N] (each
    row's last key, in any order) int32; ``kmax_host``, the same N last
    keys on the host, sizes the float32 kernel's work items."""
    if table.dim() != 1:
        raise ValueError(f"table {tuple(table.shape)} must be [MAXB]")
    if len(kmax_host) != q.shape[0]:
        raise ValueError(f"kmax_host holds {len(kmax_host)} keys, want one "
                         f"a row ({q.shape[0]})")
    dev = _check(q, kc, vc, table[None], None, kmax, k_scale, v_scale)
    if dev.type == "cpu":
        return paged_prefill_plain(q, kc, vc, table, kmax, k_scale, v_scale)
    if q.dtype == torch.float32:
        return attention_f32.paged_prefill_f32(q, kc, vc, table, kmax,
                                               kmax_host, k_scale, v_scale)
    return paged_attention(q, kc, vc, table[None], torch.zeros_like(kmax),
                           kmax, k_scale, v_scale)
