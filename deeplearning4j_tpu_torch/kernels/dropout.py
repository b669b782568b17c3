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

The other random ops draw from the same generator with the same key and
counter (``dl4j_noise``): ``gaussian_noise`` ``x + s n``, whose backward
is ``dy`` and draws nothing; ``gaussian_dropout`` ``x (1 + s n)``, whose
backward is the same function of ``dy``; ``alpha_dropout`` ``a where(keep,
x, alpha') + b``, whose backward is ``where(keep, a dy, 0)``; and
``spatial_dropout``, one keep a (batch, channel), drawn at index ``batch *
C + channel``. ``n`` is a standard normal by Box-Muller from the group's
words (:func:`normals_plain`), computed once a pair of normals in float32
for bf16 and float32 outputs and in float64 for float64 ones; every
product and sum is rounded on its own. Each backward draws again.
:func:`noise_plain` is their plain version: its Bernoulli masks are the
kernel's bit for bit, its float32 normals within 2^-20 of their magnitude
of the kernel's (:data:`NORMAL_KERNEL_REL`: the CPU's and the card's
``logf`` and the card's ``sincospif`` may round a last bit apart), its
float64 normals within a few ulp. Launches count under
``gaussian_noise_fwd``, ``gaussian_dropout_fwd``/``_bwd``,
``alpha_dropout_fwd``/``_bwd`` and ``spatial_dropout_fwd``/``_bwd``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import _cuda

LAUNCHES: Dict[str, int] = {
    "dropout_fwd": 0, "dropout_bwd": 0, "gaussian_noise_fwd": 0,
    "gaussian_dropout_fwd": 0, "gaussian_dropout_bwd": 0,
    "alpha_dropout_fwd": 0, "alpha_dropout_bwd": 0,
    "spatial_dropout_fwd": 0, "spatial_dropout_bwd": 0}
_cuda.register_counters(LAUNCHES)

_LIB = "dropout"
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the C entry's arguments, in order
ARGTYPES = ([("x", _P), ("y", _P), ("n", _I64), ("seed", _P),
             ("iteration", _P), ("node", _I64), ("threshold", _I64),
             ("p", ctypes.c_double), ("dtype", _I), ("stream", _P)])
NOISE_ARGTYPES = ([("kind", _I), ("x", _P), ("y", _P), ("n", _I64),
                   ("seed", _P), ("iteration", _P), ("node", _I64),
                   ("threshold", _I64), ("p0", ctypes.c_double),
                   ("p1", ctypes.c_double), ("p2", ctypes.c_double),
                   ("per_batch", _I64), ("channels", _I64), ("inner", _I64),
                   ("dtype", _I), ("stream", _P)])
#: the noise kernel's kinds
NOISE_KINDS = {"gaussian_noise": 0, "gaussian_dropout": 1,
               "alpha_dropout": 2, "alpha_dropout_bwd": 3,
               "spatial_dropout": 4}
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
    if lib.dl4j_noise.argtypes is None:
        _cuda.declare(lib.dl4j_noise, NOISE_ARGTYPES)
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


def words_plain(n: int, seed, iteration, node: int,
                device=None) -> torch.Tensor:
    """The kernel's words for ``n`` elements (element i: word i % 4 of
    group i // 4), int64 holding 32 bits."""
    s, it = _host_int(seed), _host_int(iteration)
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    ctr = (g & _MASK, g >> 32,
           torch.full_like(g, it & _MASK), torch.full_like(g, it >> 32))
    words = philox4x32_10(ctr, (s & _MASK, ((s >> 32) ^ node) & _MASK))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_mask_plain(n: int, seed, iteration, node: int, p: float,
                    device=None) -> torch.Tensor:
    """The kernel's ``keep`` for ``n`` elements, a bool tensor."""
    return (words_plain(n, seed, iteration, node, device) >> 8) \
        < keep_threshold(p)


#: the largest relative difference between a normal of the noise kernel
#: and of :func:`normals_plain` in float32 (8 float32 ulp of 1), and
#: between :func:`normals_plain`'s float32 normal and the Box-Muller
#: formula evaluated in float64 (4 ulp of 1); ``csrc/dropout.cu`` has the
#: arithmetic behind both
NORMAL_KERNEL_REL = 2.0 ** -20
NORMAL_PLAIN_REL = 2.0 ** -21


def normals_plain(n: int, seed, iteration, node: int, device=None,
                  dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The kernel's standard normals for ``n`` elements in ``dtype``
    (float64, or float32: the kernel's for bf16 and float32 outputs):
    group g's words (w0, w1) give elements 4g, 4g + 1 as ``rho cos``,
    ``rho sin`` of the angle ``2 pi u2``, ``rho = sqrt(-2 log u1)``, ``u1 =
    ((w0 >> 8) + 1) / 2^24``, ``u2 = (w1 >> 8) / 2^24``; (w2, w3)
    elements 4g + 2, 4g + 3.

    float64: log, sqrt, cos and sin in float64 (the kernel's double
    path). float32: u1 and u2 exact, torch's float32 log and sqrt, the
    cosine and sine of ``2 pi u2`` in float64 (:func:`sincospi_plain`)
    rounded once to float32 (the kernel's ``sincospif(2 u2)``, whose
    argument is exact), each product rounded in float32. Bounds (relative to the normal's magnitude): within
    :data:`NORMAL_PLAIN_REL` (2^-21, 4 float32 ulp of 1) of the formula in
    float64, and within :data:`NORMAL_KERNEL_REL` (2^-20, 8 ulp) of the
    kernel's float normal: each log within 1 ulp (the CPU's and CUDA's
    ``logf``), ``sincospif`` within 1, the rounded float64 values within
    half, and the roundings of sqrt and the product."""
    groups = (n + 3) // 4
    w = words_plain(4 * groups, seed, iteration, node, device).view(-1, 4)
    scale = 2.0 ** -24
    if dtype == torch.float64:
        u1 = ((w[:, 0::2] >> 8) + 1).double() * scale      # (groups, 2)
        u2 = (w[:, 1::2] >> 8).double() * scale
        rho = torch.sqrt(-2.0 * torch.log(u1))
        ang = 6.283185307179586 * u2
        out = torch.stack([rho * torch.cos(ang), rho * torch.sin(ang)],
                          dim=2)
    else:
        u1 = ((w[:, 0::2] >> 8) + 1).float() * scale       # exact
        u2 = (w[:, 1::2] >> 8).float() * scale
        rho = torch.sqrt(-2.0 * torch.log(u1))
        sn, cs = sincospi_plain((2 * u2).double())
        out = torch.stack([rho * cs.float(), rho * sn.float()], dim=2)
    return out.reshape(-1)[:n]


def sincospi_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin(pi x), cos(pi x))`` in float64 for float64 ``x``, reduced by
    quarter turns first, as CUDA's ``sincospif``: ``x = k / 2 + r`` with
    ``|r| <= 1/4`` exact, so a multiple of 1/2 gives exact zeros and ones
    (``sin(pi * x)`` in float64 would not: pi is rounded)."""
    k = torch.round(2 * x)
    r = x - k / 2
    s, c = torch.sin(math.pi * r), torch.cos(math.pi * r)
    q = torch.remainder(k, 4)
    sn = torch.where(q == 0, s, torch.where(q == 1, c, torch.where(
        q == 2, -s, -c)))
    cs = torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(
        q == 2, -c, s)))
    return sn, cs


def _compute(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def spatial_index(shape, channel_axis: int) -> torch.Tensor:
    """Each element's draw index ``batch * C + channel`` (int64, flat)."""
    axis = channel_axis % len(shape)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    inner = int(np.prod(shape[axis + 1:]))
    per_batch = int(np.prod(shape[1:]))
    c = shape[axis]
    return (idx // per_batch) * c + (idx // inner) % c


def noise_plain(kind: str, x: torch.Tensor, seed, iteration, node: int,
                p: float = 1.0, stddev: float = 0.0,
                channel_axis: int = -1) -> torch.Tensor:
    """The noise kernel's output, in x's dtype: ``kind`` one of
    :data:`NOISE_KINDS` (``p`` the retain probability of the Bernoulli
    kinds, ``stddev`` the Gaussian kinds' s). The Bernoulli kinds are the
    kernel's bit for bit; the Gaussian kinds draw :func:`normals_plain` in
    the compute dtype (float32 for bf16 and float32 x), each normal within
    :data:`NORMAL_KERNEL_REL` (2^-20, 8 float32 ulp) of its magnitude of
    the kernel's."""
    cdt = _compute(x)
    v = x.to(cdt)
    dev = x.device
    if kind in ("gaussian_noise", "gaussian_dropout"):
        nrm = normals_plain(x.numel(), seed, iteration, node, dev,
                            cdt).reshape(x.shape)
        s = torch.tensor(stddev, dtype=cdt, device=dev)
        out = v + s * nrm if kind == "gaussian_noise" else v * (1 + s * nrm)
    elif kind == "spatial_dropout":
        idx = spatial_index(tuple(x.shape), channel_axis).to(dev)
        words = words_plain(int(idx.max()) + 1, seed, iteration, node, dev)
        keep = ((words[idx] >> 8) < keep_threshold(p)).reshape(x.shape)
        return torch.where(keep, _divide(x, p),
                           torch.zeros((), dtype=x.dtype, device=dev))
    else:
        a, b, ap = alpha_constants(p)
        keep = keep_mask_plain(x.numel(), seed, iteration, node, p,
                               dev).reshape(x.shape)
        ta = torch.tensor(a, dtype=cdt, device=dev)
        if kind == "alpha_dropout":
            out = ta * torch.where(keep, v, torch.tensor(
                ap, dtype=cdt, device=dev)) + torch.tensor(b, dtype=cdt,
                                                           device=dev)
        else:
            out = torch.where(keep, ta * v, torch.zeros((), dtype=cdt,
                                                        device=dev))
    return out.to(x.dtype)


#: SELU's alpha and scale (the JAX ``alpha_dropout`` constants)
SELU_ALPHA, SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def alpha_constants(p: float) -> Tuple[float, float, float]:
    """``(a, b, alpha')`` of alpha dropout with retain probability ``p``,
    as the JAX op computes them in Python floats."""
    alpha_p = -SELU_ALPHA * SELU_SCALE
    a = (p + alpha_p ** 2 * p * (1 - p)) ** -0.5
    b = -a * alpha_p * (1 - p)
    return a, b, alpha_p


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


# ----------------------------------------------------------------------
# the other noise draws
def noise_apply(kind: str, x: torch.Tensor, seed: torch.Tensor,
                iteration: torch.Tensor, node: int, name: str,
                p: float = 1.0, stddev: float = 0.0,
                channel_axis: int = -1) -> torch.Tensor:
    """:func:`noise_plain` for a CPU tensor, one launch of the noise kernel
    (counted under ``name``) for a CUDA one."""
    if x.device.type == "cpu":
        return noise_plain(kind, x, seed, iteration, node, p, stddev,
                           channel_axis)
    _check(x, seed, iteration)
    per_batch = channels = inner = 1
    axis = channel_axis % x.dim()
    if kind == "spatial_dropout":
        if x.dim() == 4 and axis == 1 and \
                x.is_contiguous(memory_format=torch.channels_last) and \
                not x.is_contiguous():
            # a channels-last map: its memory is (B, H, W, C)
            y = noise_apply(kind, x.permute(0, 2, 3, 1), seed, iteration,
                            node, name, p, stddev, -1)
            return y.permute(0, 3, 1, 2)
        per_batch = int(np.prod(x.shape[1:]))
        channels = x.shape[axis]
        inner = int(np.prod(x.shape[axis + 1:]))
    x = x.contiguous()
    y = torch.empty_like(x)
    if kind in ("alpha_dropout", "alpha_dropout_bwd"):
        p0, p1, p2 = alpha_constants(p)
    else:
        p0, p1, p2 = (p if kind == "spatial_dropout" else stddev), 0.0, 0.0
    dev = x.device
    with torch.cuda.device(dev):
        err = _lib().dl4j_noise(
            NOISE_KINDS[kind], x.data_ptr(), y.data_ptr(), x.numel(),
            seed.data_ptr(), iteration.data_ptr(), int(node),
            keep_threshold(p), float(p0), float(p1), float(p2), per_batch,
            channels, inner, _DTYPE_CODE[x.dtype],
            torch._C._cuda_getCurrentRawStream(dev.index))
    _cuda.check(err, name)
    LAUNCHES[name] += 1
    return y


class Noise(torch.autograd.Function):
    """A noise op's forward and backward launches; only ``x`` has a
    gradient. The seed and iteration tensors are kept by reference: a
    captured step's backward reads them at replay."""

    @staticmethod
    def forward(ctx, kind: str, x, seed, iteration, node: int, p: float,
                stddev: float, channel_axis: int):
        ctx.args = (kind, node, p, stddev, channel_axis)
        ctx.save_for_backward(seed, iteration)
        return noise_apply(kind, x, seed, iteration, node, f"{kind}_fwd", p,
                           stddev, channel_axis)

    @staticmethod
    def backward(ctx, dy):
        kind, node, p, stddev, channel_axis = ctx.args
        seed, iteration = ctx.saved_tensors
        if kind == "gaussian_noise":
            dx = dy
        else:
            bwd = "alpha_dropout_bwd" if kind == "alpha_dropout" else kind
            dx = noise_apply(bwd, dy, seed, iteration, node, f"{kind}_bwd",
                             p, stddev, channel_axis)
        return None, dx, None, None, None, None, None, None


def noise(kind: str, x: torch.Tensor, seed: torch.Tensor,
          iteration: torch.Tensor, node: int, p: float = 1.0,
          stddev: float = 0.0, channel_axis: int = -1) -> torch.Tensor:
    """The ``kind`` noise of ``x`` (:data:`NOISE_KINDS` but the alpha
    backward), keyed by ``seed`` and ``node`` and counted by
    ``iteration`` (one int64 tensor each, on x's device)."""
    return Noise.apply(kind, x, seed, iteration, int(node), float(p),
                       float(stddev), int(channel_axis))
