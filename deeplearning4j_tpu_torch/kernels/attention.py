"""Scaled dot-product attention with hand-written forward and backward
kernels for Hopper.

Counterpart of the JAX package's ``scaled_dot_product_attention``
(``deeplearning4j_tpu/ops/nn_ops.py:462-488``). There it is one op that XLA
fused on the TPU; no Pallas kernel stands behind it. In eager PyTorch the
same math writes the float32 scores, the masked scores, the probabilities
and their cast to device memory, one pass each (at GPT-medium's shape, 201
MB of scores per layer). The port computes it in CUDA C++
(``csrc/causal_attention.cu``, built by ``kernels/_cuda.py``):

- ``attention_fwd``: one flash-style launch that writes O and the per-row
  log-sum-exp (as ``stats``: the row maximum and the log-sum, in base 2);
- ``attention_bwd``: three launches, FlashAttention-2's scheme with P
  recomputed from ``stats``: ``delta = rowsum(dO * O)``; dk and dv over
  key tiles; dq over query tiles. No atomic sums: two calls are
  bit-equal.

What bounds them on the card: at GPT-medium's shape (16 x 12 heads x
512 x 128, causal) a forward is 12.9 GFLOP of products (0.013 ms at 989
TFLOP/s) on 100 MB of q, k, v and O (0.030 ms at 3.35 TB/s): the least
time is the bytes', and so for the backward's kernels. A training step
with per-layer remat runs the forward twice and the backward once per
layer. The bf16 kernels are persistent and warp specialised: a producer
thread feeds tiles to shared memory with TMA (tensor maps built from each
tensor's own strides), two consumer warpgroups multiply them with wgmma
and keep the scores in registers, and the causal mask's hidden tiles are
skipped. Their times against the bound and PyTorch's fused attention are
in PERF.md. TMA reads only tensors whose base and strides are 16-byte
multiples: the wrappers copy a bf16 view that is not (counted in
``ALIGN_COPIES`` and ``DOUT_COPIES``); build_gpt's views need no copy.

float32 input takes another kernel for the forward: ``attention_f32``'s
``dl4j_attention_fwd_f32`` (``csrc/attention_f32.cu``, 3xTF32 on the
tensor cores), which writes the same O and stats; its launches are counted
in ``attention_f32.LAUNCHES``. float64 keeps this library's scalar forward
(the card-against-CPU gates), and every dtype this library's backward.

Beside the kernels are their plain PyTorch versions: ``sdpa_plain`` (the
JAX op's math line by line: what the op computes on the CPU and with an
explicit mask), ``attention_fwd_plain`` and ``attention_bwd_plain`` (the
kernels' own functions, with their roundings). A wrapper takes the plain
version for a tensor that holds no data on the card (on the CPU, or on
the ``meta`` device during shape inference); for a CUDA tensor it
launches its kernel or raises.

One difference from the JAX op, for float64 input only: there the scores
are accumulated with ``preferred_element_type=float32``, which rounds
float64 scores to float32; here float64 input keeps float64 scores and
softmax (as the port's other kernels accumulate float64 in float64), so
that a float64 step on the card can be held to the CPU's at 1e-10.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda, attention_f32

#: Kernel launches, bumped where each kernel is launched.
LAUNCHES: Dict[str, int] = {"attention_fwd": 0, "attention_bwd_delta": 0,
                            "attention_bwd_dkdv": 0, "attention_bwd_dq": 0}
#: Copies the backward wrapper made of a dO whose last stride was not 1, or
#: (bf16) whose base or strides were not on 16 bytes.
DOUT_COPIES: Dict[str, int] = {"attention_bwd": 0}
#: Copies of a bf16 q, k or v whose base or strides were not on 16 bytes
#: (TMA reads only such tensors), by the wrapper that made them.
ALIGN_COPIES: Dict[str, int] = {"attention_fwd": 0, "attention_bwd": 0}

_LIB = "causal_attention"
_MASKED = -1e30
_LOG2E = 1.4426950408889634
#: what the kernels take, with the C side's codes; the plain versions take
#: any float dtype
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_HEAD_DIMS = (16, 32, 64, 128)
_PLAIN_DEVICES = ("cpu", "meta")

# The C entries' arguments, in order (one list for all four entries).
_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double
ATTENTION_ARGTYPES = (
    [(n, _P) for n in ("q", "k", "v", "o", "dout", "out", "stats", "delta",
                       "dq", "dk", "dv")]
    + [(n, _I64) for n in ("B", "H", "Sq", "Sk", "D", "sqb", "sqh", "sqs",
                           "skb", "skh", "sks", "svb", "svh", "svs", "sdb",
                           "sdh", "sds")]
    + [("scale", _D), ("causal", _I), ("dtype", _I), ("work", _P),
       ("stream", _P)])
ENTRIES = tuple(f"dl4j_{k}" for k in LAUNCHES)
#: per (device, raw stream): the two int32 the persistent bf16 kernels take
#: their work items from. A launch's last block leaves them zero, and
#: launches on one stream run one after another, so a stream's launches
#: share one pair; launches on two streams never do.
_WORK: Dict[Tuple[int, int], torch.Tensor] = {}

_cuda.register_counters(LAUNCHES, DOUT_COPIES, ALIGN_COPIES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DOUT_COPIES["attention_bwd"] = 0
    for k in ALIGN_COPIES:
        ALIGN_COPIES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, with every C entry's argument types declared
    (undeclared, ctypes would pass each pointer as a 32-bit int)."""
    lib = _cuda.load(_LIB)
    for name in ENTRIES:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            _cuda.declare(fn, ATTENTION_ARGTYPES)
    return lib


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Scores, softmax and statistics: float32, float64 for float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """True where query i may attend key j: ``tril(k = sk - sq)``."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


# ----------------------------------------------------------------------
# plain versions
def sdpa_plain(q, k, v, mask=None, causal: bool = False,
               scale: Optional[float] = None):
    """The JAX op's math line by line: float32 scores (float64 for float64
    input) times ``scale``, masked scores set to -1e30, a softmax in that
    dtype, the probabilities cast to v's dtype, then ``probs . v``."""
    s = _scale(q.shape[-1], scale)
    acc = acc_dtype(q.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * s
    if causal:
        cm = _causal_mask(scores.shape[-2], scores.shape[-1], q.device)
        scores = torch.where(cm, scores, _MASKED)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _logits2(q, k, causal: bool, s: float):
    """(masked scores in base-2 units, the mask) in the accumulation dtype."""
    acc = acc_dtype(q.dtype)
    x = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * s
    cm = _causal_mask(x.shape[-2], x.shape[-1], q.device) if causal \
        else None
    if cm is not None:
        x = torch.where(cm, x, _MASKED)
    return x * _LOG2E, cm


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """What the kernel feeds its tensor cores: bf16 for bf16 input."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def attention_fwd_plain(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """The forward kernel's function: (O in v's dtype, stats) with
    ``stats[..., 0]`` the row maximum of the scores times log2(e) and
    ``stats[..., 1]`` the base-2 log of the row's sum of
    ``2^(x log2(e) - stats[..., 0])``."""
    z, _ = _logits2(q, k, causal, _scale(q.shape[-1], scale))
    m2 = z.amax(dim=-1, keepdim=True)
    e = torch.exp2(z - m2)
    l = e.sum(dim=-1, keepdim=True)
    probs = _round(e / l, v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(z.dtype)).to(v.dtype)
    return o, torch.cat([m2, torch.log2(l)], dim=-1)


def bwd_delta_plain(o, dout):
    """The delta kernel's function: ``rowsum(dO * O)`` in the
    accumulation dtype."""
    acc = acc_dtype(o.dtype)
    return (dout.to(acc) * o.to(acc)).sum(dim=-1)


def _p_ds(q, k, v, dout, stats, delta, causal: bool, s: float):
    """P recomputed from ``stats``, and ``dS = P (dO v^T - delta)`` (0
    where masked), both rounded to bf16 for bf16 input."""
    z, cm = _logits2(q, k, causal, s)
    p = torch.exp2(z - stats[..., :1] - stats[..., 1:])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.to(z.dtype), v.to(z.dtype))
    ds = p * (dp - delta[..., None])
    if cm is not None:
        ds = torch.where(cm, ds, 0.0)
    return _round(p, q.dtype), _round(ds, q.dtype)


def bwd_dkdv_plain(q, k, v, dout, stats, delta, causal: bool = False,
                   scale: Optional[float] = None):
    """The dk/dv kernel's function: ``dv = P^T dO``, ``dk = scale dS^T q``."""
    s = _scale(q.shape[-1], scale)
    p, ds = _p_ds(q, k, v, dout, stats, delta, causal, s)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.to(p.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(p.dtype)) * s
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_dq_plain(q, k, v, dout, stats, delta, causal: bool = False,
                 scale: Optional[float] = None):
    """The dq kernel's function: ``dq = scale dS k``."""
    s = _scale(q.shape[-1], scale)
    _, ds = _p_ds(q, k, v, dout, stats, delta, causal, s)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ds.dtype)) * s).to(
        q.dtype)


def attention_bwd_plain(q, k, v, o, dout, stats, causal: bool = False,
                        scale: Optional[float] = None):
    """The backward kernels' function: (dq, dk, dv) from P recomputed out
    of ``stats``, with ``delta = rowsum(dO * O)``, ``dS = P (dO v^T -
    delta)`` (0 where masked), ``dv = P^T dO``, ``dk = scale dS^T q``,
    ``dq = scale dS k``; P and dS rounded to bf16 before their products
    for bf16 input, as the kernels do."""
    delta = bwd_delta_plain(o, dout)
    dk, dv = bwd_dkdv_plain(q, k, v, dout, stats, delta, causal, scale)
    return bwd_dq_plain(q, k, v, dout, stats, delta, causal, scale), dk, dv


# ----------------------------------------------------------------------
# checks and launches
def _check(q, k, v) -> torch.device:
    """Raise on what the op does not take; returns the device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, heads, seq, head_dim)")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q on {dev}, k on {k.device}, v on {v.device}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    if dev.type in _PLAIN_DEVICES:
        return dev
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel does not take {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have its last stride 1, got "
                             f"{t.stride()}")
    return dev


_rows_aligned = _cuda.rows_aligned


def _for_tma(ts, counter: Dict[str, int], key: str):
    """The bf16 tensors as the kernels read them: each whose rows are not on
    16 bytes replaced by a contiguous copy, counted in ``counter[key]``."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    return _cuda.copy_unaligned(ts, counter, key)


def _launch(entry: str, q, k, v, scale: float, causal: bool, o=None,
            dout=None, out=None, stats=None, delta=None, dq=None, dk=None,
            dv=None, lib: Optional[ctypes.CDLL] = None) -> None:
    """Launch ``entry`` of ``lib`` (the package's build by default) on
    the current stream; raises on the launch's CUDA error."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    for t in (o, out, stats, delta, dq, dk, dv):
        if t is not None and not t.is_contiguous():
            raise ValueError("the kernels write and read O, stats, delta "
                             "and the grads contiguous")

    b, h, sq, d = q.shape
    d_ = dout if dout is not None else q
    dev = q.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        work = _WORK.get((dev.index, stream))
        if work is None:    # zeroed on `stream`, before the launch
            work = _WORK[dev.index, stream] = torch.zeros(
                2, dtype=torch.int32, device=dev)
        err = getattr(lib or _lib(), entry)(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(out), ptr(stats),
            ptr(delta), ptr(dq), ptr(dk), ptr(dv), b, h, sq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *d_.stride()[:3], scale, int(causal), _DTYPE_CODE[q.dtype],
            work.data_ptr(), stream)
    _cuda.check(err, entry)
    LAUNCHES[entry[len("dl4j_"):]] += 1


def attention_fwd(q, k, v, causal: bool = False,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, stats): one launch on the card; the plain version elsewhere. A
    bf16 q, k or v whose rows are not on 16 bytes is copied first (counted
    in ``ALIGN_COPIES``). float32 goes to ``attention_f32``'s kernel
    (bf16 and float64 to this library's)."""
    dev = _check(q, k, v)
    if dev.type in _PLAIN_DEVICES:
        return attention_fwd_plain(q, k, v, causal, scale)
    if q.dtype == torch.float32:
        return attention_f32.attention_fwd_f32(
            q, k, v, causal, _scale(q.shape[3], scale))
    q, k, v = _for_tma((q, k, v), ALIGN_COPIES, "attention_fwd")
    b, h, sq, d = q.shape
    out = torch.empty((b, h, sq, d), dtype=v.dtype, device=dev)
    stats = torch.empty((b, h, sq, 2), dtype=acc_dtype(q.dtype), device=dev)
    _launch("dl4j_attention_fwd", q, k, v, _scale(d, scale), causal,
            out=out, stats=stats)
    return out, stats


def attention_bwd(q, k, v, o, dout, stats, causal: bool = False,
                  scale: Optional[float] = None):
    """(dq, dk, dv), contiguous: three launches on the card; the plain
    version elsewhere. A dO whose last stride is not 1 is copied first
    (counted in ``DOUT_COPIES``), and so is, for bf16, a dO, q, k or v
    whose rows are not on 16 bytes (``DOUT_COPIES``, ``ALIGN_COPIES``)."""
    dev = _check(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype \
            or dout.dtype != q.dtype or stats.shape != q.shape[:3] + (2,) \
            or stats.dtype != acc_dtype(q.dtype):
        raise ValueError("o, dout or stats do not match q")
    if dev.type in _PLAIN_DEVICES:
        return attention_bwd_plain(q, k, v, o, dout, stats, causal, scale)
    if not (o.is_contiguous() and stats.is_contiguous()):
        raise ValueError("o and stats must be the forward's contiguous "
                         "outputs")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
        DOUT_COPIES["attention_bwd"] += 1
    (dout,) = _for_tma((dout,), DOUT_COPIES, "attention_bwd")
    q, k, v = _for_tma((q, k, v), ALIGN_COPIES, "attention_bwd")
    s = _scale(q.shape[3], scale)
    delta = torch.empty(q.shape[:3], dtype=stats.dtype, device=dev)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    common = dict(o=o, dout=dout, stats=stats, delta=delta)
    _launch("dl4j_attention_bwd_delta", q, k, v, s, causal, **common)
    _launch("dl4j_attention_bwd_dkdv", q, k, v, s, causal, dk=dk, dv=dv,
            **common)
    _launch("dl4j_attention_bwd_dq", q, k, v, s, causal, dq=dq, **common)
    return dq, dk, dv


class Attention(torch.autograd.Function):
    """``attention_fwd`` whose backward is ``attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        o, stats = attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, dout, stats, ctx.causal,
                                   ctx.scale)
        return dq, dk, dv, None, None


def scaled_dot_product_attention(q, k, v, mask=None, causal: bool = False,
                                 scale: Optional[float] = None):
    """The op: ``Attention`` (the kernels on the card, their plain versions
    on the CPU). An explicit ``mask`` runs ``sdpa_plain`` on the CPU and
    is refused on the card, where no kernel takes it yet (ROADMAP queue
    2b item 8: attention with an explicit mask)."""
    if mask is not None:
        if q.device.type not in _PLAIN_DEVICES:
            raise NotImplementedError(
                "scaled_dot_product_attention with an explicit mask has no "
                "kernel on the card yet (ROADMAP queue 2b item 8)")
        return sdpa_plain(q, k, v, mask, causal, scale)
    return Attention.apply(q, k, v, causal, scale)


# ----------------------------------------------------------------------
# what the checks hold the kernels to
def abs_terms(q, k, v, dout, causal: bool = False,
              scale: Optional[float] = None):
    """Per output element, the sum of the absolute values of the terms
    that make it up, in float64: (O, dq, dk, dv). A kernel that sums the
    same terms in another order, in a dtype of unit roundoff u, lies
    within a small multiple of u times this of the plain version."""
    s = _scale(q.shape[-1], scale)
    q, k, v, do = (t.detach().double() for t in (q, k, v, dout))
    x = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    cm = _causal_mask(x.shape[-2], x.shape[-1], q.device) if causal \
        else None
    if cm is not None:
        x = torch.where(cm, x, _MASKED)
    p = torch.softmax(x, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.abs())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.abs(), v.abs())
    delta = (do.abs() * o).sum(dim=-1, keepdim=True)
    ds = p * (dp + delta)
    if cm is not None:
        ds = torch.where(cm, ds, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.abs())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.abs()) * s
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.abs()) * s
    return o, dq, dk, dv
