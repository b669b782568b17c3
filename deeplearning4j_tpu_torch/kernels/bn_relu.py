"""Training batch norm with its fused (ReLU-masked) backward.

Replaces the TPU kernel pair ``bn_relu_bwd_pallas`` in
``experiments/pallas_bn_spike.py`` (``_phase1_kernel`` launched at :87,
``_phase2_kernel`` at :115, and the fold between them, :97-107) with two
kernels for Hopper, each built with and without the ReLU mask (as
``bn_relu_bwd_phase*`` and ``bn_bwd_phase*``):

- phase 1 and its fold, one CUDA C++ launch (``csrc/bn_bwd_reduce.cu``):
  per channel, ``s1 = sum(dz)`` and ``s2 = sum(dz * (x - mean))`` with
  ``dz = dy * [z > 0]`` (``dz = dy`` without the ReLU), ``z`` being the
  forward's pre-ReLU output recomputed from ``x``; then ``dgamma = inv *
  s2`` and ``dbeta = s1`` in gamma's dtype, and phase 2's per-channel
  ``g = gamma * inv``, ``c1 = s1 / R``, ``c2 = inv^2 * s2 / R``;
- phase 2, a Triton kernel (``bn_relu_triton.py``):
  ``dx = g * (dz - c1 - (x - mean) * c2)``.

A BN backward on the card is these two launches and nothing else.

What bounds it on the card: device-memory bandwidth alone. Phase 1 reads
``x`` and ``dy``; phase 2 reads them again and writes ``dx``: 10 bytes
per element at bf16, so 10 * R * C bytes for an (R, C) activation, i.e.
~0.31 ms for (128, 56, 56, 256) at the H100 SXM's 3.35 TB/s. Neither
phase does tensor-core work.

What the design does about it:

- The TPU ran its grid in order and summed (8, C) partial blocks. On the
  card, phase 1's grid is (channel blocks) x (row splits), sized from R, C
  and the SM count; the last block of each channel block to finish sums
  the splits' partials in a fixed order and applies the fold in the same
  launch (no atomics on data: results are the same from run to run).
  The design notes are in the ``.cu`` source.
- The sum is centred, ``sum(dz * (x - mean))``, not the spike's
  ``sum(dz * x)``: ``inv * (sum(dz*x) - mean * sum(dz))`` cancels
  catastrophically when ``|mean| * inv`` is large, which the convolutions'
  biases make real. Both forms are the same function.
- The ReLU mask is recomputed with the forward's own rounding
  (``z = (x * a) + b`` rounded to x's dtype after each operation, with
  ``a``/``b`` already in x's dtype) and floating-point contraction is off
  for it, so the mask equals the one the forward applied. Nothing but
  ``x`` is kept from the forward.
- The kernels take the element strides of ``x`` and ``dy`` in logical
  (N, H, W, C) order, so a ``dy`` that autograd hands over in NCHW layout
  while ``x`` is channels-last needs no copy; ``dx`` is written in x's
  layout.

The kernels take bf16 (the main path), float32 and float64 (the
card-against-CPU checks of a whole step); they sum and compute in
float32, in float64 for float64 input.

Beside the kernels are their plain PyTorch versions. A wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda

#: Kernel launches, bumped where each kernel is launched; keys are the
#: kernels' names (phase 1's CUDA kernels carry a dtype suffix after them).
LAUNCHES: Dict[str, int] = {"bn_relu_bwd_phase1": 0, "bn_relu_bwd_phase2": 0,
                            "bn_bwd_phase1": 0, "bn_bwd_phase2": 0}

_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "triton")
_KERNELS = None
_LOWP = (torch.bfloat16, torch.float16)
#: what the kernels take (bf16 on the main path, float32 and float64 for
#: the card-vs-CPU checks of a whole step), with the C side's codes; the
#: plain versions take any float dtype
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_KERNEL_DTYPES = tuple(_DTYPE_CODE)


def kernel_name(phase: int, relu: bool) -> str:
    return f"bn{'_relu' if relu else ''}_bwd_phase{phase}"

_cuda.register_counters(LAUNCHES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# phase 2: the Triton kernels (bn_relu_triton.py, built at first launch)
def _kernels():
    """The Triton module, imported (and so built at first launch) only
    when a kernel is launched on the card."""
    global _KERNELS
    if _KERNELS is None:
        os.environ.setdefault("TRITON_CACHE_DIR", _BUILD_DIR)
        from deeplearning4j_tpu_torch.kernels import bn_relu_triton
        _KERNELS = bn_relu_triton
    return _KERNELS


# ----------------------------------------------------------------------
# phase 1: the CUDA C++ kernels (csrc/bn_bwd_reduce.cu, built at first
# launch). The C entries' arguments, in order; every pointer and the
# stream is a c_void_p.
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
PHASE1_ARGTYPES = (
    [(n, _P) for n in ("x", "dy", "a", "b", "mean", "inv", "gamma", "dgamma",
                       "dbeta", "g", "c1", "c2", "ws", "counters")]
    + [(n, _I64) for n in ("R", "C", "HW", "W", "rsx", "rsy", "sxn", "sxh",
                           "sxw", "sxc", "syn", "syh", "syw", "syc",
                           "rows_per_split")]
    + [(n, _I) for n in ("dtype", "gamma_dtype", "vec", "tx", "n_cblk",
                         "splits")]
    + [("stream", _P)])
_PHASE1_LIB = "bn_bwd_reduce"
_THREADS = 256           # a block's threads (kThreads in the .cu)
_CTAS_PER_SM = 2         # resident blocks per SM (__launch_bounds__ in the .cu)
_WS_MIN_BYTES = 1 << 20  # first workspace: enough for every path shape
_COUNTERS_MIN = 4096
_SCRATCH: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
#: scratch tensors a larger one replaced, kept alive: a captured CUDA
#: graph may hold their addresses
_RETIRED: List[torch.Tensor] = []
_SM_COUNT: Dict[int, int] = {}


def _phase1_lib() -> ctypes.CDLL:
    """The built library, with both C entries' argument types declared
    (undeclared, ctypes would pass each pointer as a 32-bit int)."""
    lib = _cuda.load(_PHASE1_LIB)
    for relu in (True, False):
        fn = getattr(lib, f"dl4j_{kernel_name(1, relu)}")
        if fn.argtypes is None:
            _cuda.declare(fn, PHASE1_ARGTYPES)
    return lib


def _phase1_plan(r: int, c: int, elsize: int, acc_size: int, sms: int):
    """(tx, n_cblk, splits, rows per split, workspace bytes) of a launch:
    each thread owns ``16 // elsize`` channels, ``tx`` threads span a
    channel block, and the row splits fill the card's ``_CTAS_PER_SM``
    resident blocks per SM in one wave (never past it: a few blocks
    more would run as a second wave and double the call's time), where R
    has the rows for it."""
    vec = 16 // elsize
    tx = min(8, 1 << (_cdiv(c, vec) - 1).bit_length())
    ty = _THREADS // tx
    n_cblk = _cdiv(c, tx * vec)
    splits = max(1, min(_CTAS_PER_SM * sms // n_cblk, _cdiv(r, ty), 65535))
    rows = _cdiv(r, splits)
    splits = _cdiv(r, rows)
    ws = splits * 2 * n_cblk * tx * vec * acc_size
    return tx, n_cblk, splits, rows, ws


def _row_stride(geo) -> int:
    """The element stride between consecutive rows when a tensor of this
    geometry has its rows at one stride and its channels contiguous, else
    0."""
    r, c, hw, w, (sn, sh, sw, sc) = geo
    if sc != 1 and c > 1:
        return 0
    h, n = hw // w, r // hw
    rs = sw if w > 1 else sh if h > 1 else sn
    even = (w == 1 or sw == rs) and (h == 1 or sh == w * rs) and \
        (n == 1 or sn == hw * rs)
    return rs if even else 0


@functools.lru_cache(maxsize=256)
def _phase1_args(shape, x_stride, dy_stride, elsize: int, acc_size: int,
                 aligned: bool, sms: int):
    """A launch's integer arguments for x and dy of this shape and these
    strides (the path repeats its 53 geometries every step): the C entry's
    int64 arguments from R to rows_per_split, its (vec, tx, n_cblk,
    splits), the workspace bytes and n_cblk."""
    gx, gy = _geometry(shape, x_stride), _geometry(shape, dy_stride)
    r, c, hw, w, sx = gx
    tx, n_cblk, splits, rows, nbytes = _phase1_plan(r, c, elsize, acc_size,
                                                    sms)
    rsx, rsy = _row_stride(gx), _row_stride(gy)
    vec = int(aligned and rsx > 0 and rsy > 0 and c % (16 // elsize) == 0
              and (rsx * elsize) % 16 == 0 and (rsy * elsize) % 16 == 0)
    return ((r, c, hw, w, rsx, rsy, *sx, *gy[4], rows),
            (vec, tx, n_cblk, splits), nbytes, n_cblk)


def _scratch(dev: torch.device, nbytes: int, n_cblk: int):
    """The device's phase-1 workspace and per-channel-block counters, kept
    across calls at stable addresses (grown, never shrunk or freed). The
    counters are 0 between launches: each launch's last block resets its
    own. So launches that share them must be ordered, as on one stream
    (eager steps and graph replays run on the current stream).

    A capture records the addresses: the scratch must not grow inside one
    (the new tensor would come from the graph's private pool and be used
    outside it). The warm-up steps before a capture run the same shapes
    and grow it; growing inside a capture raises."""
    ws, cnt = _SCRATCH.get(dev.index, (None, None))
    grow_ws = ws is None or ws.numel() < nbytes
    grow_cnt = cnt is None or cnt.numel() < n_cblk
    if not (grow_ws or grow_cnt):
        return ws, cnt
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the BN phase-1 scratch would grow inside a CUDA graph capture; "
            "warm-up steps at the captured shapes must grow it first")
    if grow_ws:
        if ws is not None:
            _RETIRED.append(ws)
        ws = torch.empty(max(nbytes, _WS_MIN_BYTES,
                             2 * (0 if ws is None else ws.numel())),
                         dtype=torch.uint8, device=dev)
    if grow_cnt:
        if cnt is not None:
            _RETIRED.append(cnt)
        cnt = torch.zeros(max(n_cblk, _COUNTERS_MIN,
                              2 * (0 if cnt is None else cnt.numel())),
                          dtype=torch.int32, device=dev)
    _SCRATCH[dev.index] = (ws, cnt)
    return ws, cnt


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SM_COUNT:
        _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev.index]


def _launch_phase1(fn, x, dy, a, b, mean, inv, gamma, relu: bool, sms: int,
                   scratch, stream: int):
    """Queue one phase-1 launch through the C entry ``fn`` on ``stream``.
    The outputs are allocated here; ``scratch(nbytes, n_cblk)`` gives the
    workspace and the counters."""
    xp, yp = x.data_ptr(), dy.data_ptr()
    i64, i32, nbytes, n_cblk = _phase1_args(
        tuple(x.shape), x.stride(), dy.stride(), x.element_size(),
        mean.element_size(), (xp | yp) % 16 == 0, sms)
    ws, counters = scratch(nbytes, n_cblk)
    dev, c = x.device, x.shape[1]
    dgamma, dbeta = torch.empty((2, c), dtype=gamma.dtype, device=dev)
    g, c1, c2 = torch.empty((3, c), dtype=mean.dtype, device=dev)
    err = fn(xp, yp, a.data_ptr(), b.data_ptr(), mean.data_ptr(),
             inv.data_ptr(), gamma.data_ptr(), dgamma.data_ptr(),
             dbeta.data_ptr(), g.data_ptr(), c1.data_ptr(), c2.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), *i64,
             _DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype], *i32, stream)
    _cuda.check(err, kernel_name(1, relu))
    return dgamma, dbeta, g, c1, c2


# ----------------------------------------------------------------------
# shapes, strides and checks
def _geometry(shape, stride) -> Tuple[int, int, int, int, tuple]:
    """(R, C, HW, W, strides in logical N, H, W, C order) of an (R, C) or
    an (N, C, H, W) tensor of any memory layout."""
    if len(shape) == 2:
        r, c = shape
        return r, c, 1, 1, (stride[0], 0, 0, stride[1])
    n, c, h, w = shape
    return n * h * w, c, h * w, w, (stride[0], stride[2], stride[3],
                                    stride[1])


def _nhwc_geometry(t: torch.Tensor) -> Tuple[int, int, int, int, tuple]:
    return _geometry(t.shape, t.stride())


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics and sums are float32 for float32 and narrower inputs,
    as in the JAX package (float64 inputs keep float64 on the CPU)."""
    return torch.float32 if dtype in _LOWP else dtype


def _up(t: torch.Tensor) -> torch.Tensor:
    return t.to(_acc_dtype(t.dtype))


def _check(x, dy, vecs: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor],
           gamma=None) -> torch.device:
    """Raise on what the kernels do not take; returns x's device. On the
    launch path, so each device and shape is read once."""
    if x.dim() not in (2, 4):
        raise ValueError(
            f"x must be (R, C) or (N, C, H, W), got {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    dev = x.device
    if dy.device != dev:
        raise ValueError(f"x on {dev}, dy on {dy.device}")
    kind = dev.type
    if kind != "cpu":
        if x.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"the kernel does not take {x.dtype}")
        if kind != "cuda":
            raise ValueError(f"no kernel for device {dev}")
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    shape = (x.shape[1],)
    for group, want in ((vecs, x.dtype), (acc, _acc_dtype(x.dtype))):
        for name, v in group.items():
            if v.shape != shape or v.dtype != want or v.device != dev \
                    or not v.is_contiguous():
                raise ValueError(
                    f"{name} must be a contiguous {shape} {want} tensor on "
                    f"{dev}; got {tuple(v.shape)} {v.dtype} on {v.device}")
    if gamma is not None and (
            gamma.shape != shape or gamma.device != dev
            or not gamma.is_contiguous()
            or (kind == "cuda" and gamma.dtype not in _DTYPE_CODE)):
        raise ValueError(f"gamma must be a contiguous {shape} bf16, float32 "
                         f"or float64 tensor on {dev}; got "
                         f"{tuple(gamma.shape)} {gamma.dtype} on "
                         f"{gamma.device}")
    return dev


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks(c: int) -> Tuple[int, int]:
    block_c = min(128, max(16, 1 << (c - 1).bit_length()))
    return 4096 // block_c, block_c


# ----------------------------------------------------------------------
# plain versions (same function, PyTorch ops)
def _chan(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def _red(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _masked_dy(x, dy, a, b, relu: bool) -> torch.Tensor:
    dyf = _up(dy)
    if not relu:
        return dyf
    z = x * _chan(a, x) + _chan(b, x)
    return torch.where(z > 0, dyf, torch.zeros((), dtype=dyf.dtype,
                                                device=dyf.device))


def phase1_plain(x, dy, a, b, mean, relu: bool):
    """Per-channel ``(sum(dz), sum(dz * (x - mean)))``."""
    dz = _masked_dy(x, dy, a, b, relu)
    xm = _up(x) - _chan(mean, x)
    return dz.sum(_red(x)), (dz * xm).sum(_red(x))


def fold(s1, s2, gamma, inv, n_rows: int):
    """Per-channel fold of phase 1's sums: (dgamma, dbeta, g, c1, c2), all
    in the statistics' dtype."""
    dgamma = inv * s2
    g = gamma.to(inv.dtype) * inv
    c1 = s1 / n_rows
    c2 = inv * dgamma / n_rows
    return dgamma, s1, g, c1, c2


def phase1_fold_plain(x, dy, a, b, mean, inv, gamma, relu: bool):
    """The function of the phase-1 kernel: :func:`phase1_plain`, then
    :func:`fold`, then dgamma and dbeta cast to gamma's dtype."""
    s1, s2 = phase1_plain(x, dy, a, b, mean, relu)
    dgamma, dbeta, g, c1, c2 = fold(s1, s2, gamma, inv,
                                    x.numel() // x.shape[1])
    return dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), g, c1, c2


def phase2_plain(x, dy, a, b, mean, g, c1, c2, relu: bool):
    dz = _masked_dy(x, dy, a, b, relu)
    xm = _up(x) - _chan(mean, x)
    dx = _chan(g, x) * (dz - _chan(c1, x) - xm * _chan(c2, x))
    return dx.to(x.dtype)


# ----------------------------------------------------------------------
# wrappers
def bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, relu: bool):
    """Phase 1 and its fold in one launch: ``(dgamma, dbeta)`` in gamma's
    dtype and phase 2's ``(g, c1, c2)`` in float32 (float64 for float64
    input)."""
    dev = _check(x, dy, {"a": a, "b": b}, {"mean": mean, "inv": inv}, gamma)
    if dev.type == "cpu":
        return phase1_fold_plain(x, dy, a, b, mean, inv, gamma, relu)
    name = kernel_name(1, relu)
    fn = getattr(_phase1_lib(), "dl4j_" + name)
    with torch.cuda.device(dev):
        # PyTorch's current stream as a raw handle (what Triton's launcher
        # reads too: torch.cuda.current_stream() costs ~5 us a call)
        out = _launch_phase1(
            fn, x, dy, a, b, mean, inv, gamma, relu, _sm_count(dev),
            lambda nbytes, n_cblk: _scratch(dev, nbytes, n_cblk),
            torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES[name] += 1
    return out


def bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu: bool):
    """``dx = g * (dz - c1 - (x - mean) * c2)`` in x's dtype and layout."""
    dev = _check(x, dy, {"a": a, "b": b},
                 {"mean": mean, "g": g, "c1": c1, "c2": c2})
    if dev.type == "cpu":
        return phase2_plain(x, dy, a, b, mean, g, c1, c2, relu)
    k = _kernels()
    dx = torch.empty_like(x)
    r, c, hw, w, sx = _nhwc_geometry(x)
    _, _, _, _, sy = _nhwc_geometry(dy)
    _, _, _, _, so = _nhwc_geometry(dx)
    block_r, block_c = _blocks(c)
    grid = (_cdiv(r, block_r), _cdiv(c, block_c))
    name = kernel_name(2, relu)
    getattr(k, name)[grid](
        x, dy, dx, a, b, mean, g, c1, c2, r, c, hw, w, *sx, *sy, *so,
        BLOCK_R=block_r, BLOCK_C=block_c,
        ACC=k.acc_dtype(x.dtype == torch.float64), num_warps=4,
        enable_fp_fusion=False)
    LAUNCHES[name] += 1
    return dx


def bn_relu_bwd(x, dy, gamma, mean, inv, a, b, relu: bool):
    """Backward of ``[relu](x * a + b)`` with batch statistics ``mean`` and
    ``inv = rsqrt(var + eps)``: returns (dx, dgamma, dbeta), the last two
    in gamma's dtype. Two launches on the card."""
    dgamma, dbeta, g, c1, c2 = bn_bwd_phase1(x, dy, a, b, mean, inv, gamma,
                                             relu)
    dx = bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu)
    return dx, dgamma, dbeta


def bn_relu_bwd_plain(x, dy, gamma, mean, inv, a, b, relu: bool):
    """The same function as :func:`bn_relu_bwd`, through the plain versions
    on any device (what the kernels are held against)."""
    dgamma, dbeta, g, c1, c2 = phase1_fold_plain(x, dy, a, b, mean, inv,
                                                 gamma, relu)
    return phase2_plain(x, dy, a, b, mean, g, c1, c2, relu), dgamma, dbeta


# ----------------------------------------------------------------------
# forward + autograd
def bn_train_forward(x, gamma, beta, eps: float, relu: bool):
    """Training batch norm over every axis but 1, numerics of the JAX
    package's ``batchnorm_train``: one-pass float32 moments (float64 for
    float64 input), per-channel
    ``a``/``b`` cast to x's dtype, one ``x * a + b`` pass in x's dtype.
    Returns (out, mean, var, inv, a, b)."""
    red = _red(x)
    xf = _up(x)
    mean = xf.mean(red)
    m2 = (xf * xf).mean(red)
    del xf
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    gf, bf = gamma.float(), beta.float()
    a = (gf * inv).to(x.dtype)
    b = (bf - gf * inv * mean).to(x.dtype)
    out = x * _chan(a, x) + _chan(b, x)
    if relu:
        out = torch.relu(out)
    return out, mean, var, inv, a, b


class BatchNormTrain(torch.autograd.Function):
    """``[relu](batchnorm_train(x))`` whose backward is the kernel pair.
    Returns (out, batch mean, batch var); only ``out`` has a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, relu: bool):
        out, mean, var, inv, a, b = bn_train_forward(x, gamma, beta, eps,
                                                     relu)
        ctx.save_for_backward(x, gamma, mean, inv, a, b)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        # no zero-filled gradients for mean and var: the backward ignores
        # them, and each would cost a launch
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        if dout is None:
            return None, None, None, None, None
        x, gamma, mean, inv, a, b = ctx.saved_tensors
        dx, dgamma, dbeta = bn_relu_bwd(x, dout, gamma, mean, inv, a, b,
                                        ctx.relu)
        return dx, dgamma, dbeta, None, None
