"""Training batch norm with its fused (ReLU-masked) backward.

Replaces the TPU kernel pair ``bn_relu_bwd_pallas`` in
``experiments/pallas_bn_spike.py`` (``_phase1_kernel`` launched at :87,
``_phase2_kernel`` at :115) with a pair of Triton kernels for Hopper
(``bn_relu_triton.py``; each phase is built with and without the ReLU
mask, as ``bn_relu_bwd_phase*`` and ``bn_bwd_phase*``):

- phase 1: per channel, ``s1 = sum(dz)`` and ``s2 = sum(dz * (x - mean))``
  with ``dz = dy * [z > 0]`` (``dz = dy`` without the ReLU), ``z`` being
  the forward's pre-ReLU output recomputed from ``x``;
- phase 2: ``dx = g * (dz - c1 - (x - mean) * c2)`` with per-channel
  ``g = gamma * inv``, ``c1 = s1 / R`` and ``c2 = inv^2 * s2 / R``,
  folded in between the phases by the wrapper.

What bounds it on the card: device-memory bandwidth alone. Phase 1 reads
``x`` and ``dy``; phase 2 reads them again and writes ``dx``: 10 bytes
per element at bf16, so 10 * R * C bytes for an (R, C) activation, i.e.
~0.31 ms for (128, 56, 56, 256) at the H100 SXM's 3.35 TB/s. Neither
phase does tensor-core work.

What the design does about it:

- The TPU ran its grid in order and summed (8, C) partial blocks; on the
  card the grid runs (row tiles x channel blocks) in parallel. Each
  program writes its partial sums into an f32 ``[n_row_tiles, C]``
  scratch buffer, and the wrapper folds them with one ``sum``: no
  atomics, so results are the same from run to run.
- The sum is centred, ``sum(dz * (x - mean))``, not the spike's
  ``sum(dz * x)``: ``inv * (sum(dz*x) - mean * sum(dz))`` cancels
  catastrophically when ``|mean| * inv`` is large, which the convolutions'
  biases make real. Both forms are the same function.
- The ReLU mask is recomputed with the forward's own rounding
  (``z = (x * a) + b`` rounded to x's dtype after each operation, with
  ``a``/``b`` already in x's dtype) and floating-point contraction is off,
  so the mask equals the one the forward applied. Nothing but ``x`` is
  kept from the forward.
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

import os
from typing import Dict, Tuple

import torch

#: Kernel launches, bumped where each kernel is launched; keys are the
#: kernels' names in ``bn_relu_triton.py``.
LAUNCHES: Dict[str, int] = {"bn_relu_bwd_phase1": 0, "bn_relu_bwd_phase2": 0,
                            "bn_bwd_phase1": 0, "bn_bwd_phase2": 0}

_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "triton")
_KERNELS = None
_LOWP = (torch.bfloat16, torch.float16)
#: what the kernels take (bf16 on the main path, float32 and float64 for
#: the card-vs-CPU checks of a whole step); the plain versions take any
#: float dtype
_KERNEL_DTYPES = (torch.bfloat16, torch.float32, torch.float64)


def kernel_name(phase: int, relu: bool) -> str:
    return f"bn{'_relu' if relu else ''}_bwd_phase{phase}"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# the Triton kernels (bn_relu_triton.py, built at first launch)
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
# shapes, strides and checks
def _nhwc_geometry(t: torch.Tensor) -> Tuple[int, int, int, int, tuple]:
    """(R, C, HW, W, strides in logical N, H, W, C order) of an (R, C) or
    an (N, C, H, W) tensor of any memory layout."""
    if t.dim() == 2:
        r, c = t.shape
        return r, c, 1, 1, (t.stride(0), 0, 0, t.stride(1))
    n, c, h, w = t.shape
    s = t.stride()
    return n * h * w, c, h * w, w, (s[0], s[2], s[3], s[1])


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics and sums are float32 for float32 and narrower inputs,
    as in the JAX package (float64 inputs keep float64 on the CPU)."""
    return torch.float32 if dtype in _LOWP else dtype


def _up(t: torch.Tensor) -> torch.Tensor:
    return t.to(_acc_dtype(t.dtype))


def _check(x, dy, vecs: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]):
    if x.dim() not in (2, 4):
        raise ValueError(
            f"x must be (R, C) or (N, C, H, W), got {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    if dy.device != x.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.device.type == "cuda":
        if x.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"the kernel does not take {x.dtype}")
    elif x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    c = x.shape[1]
    for name, v in {**vecs, **acc}.items():
        want = _acc_dtype(x.dtype) if name in acc else x.dtype
        if v.shape != (c,) or v.dtype != want or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) {want} "
                             f"tensor on {x.device}; got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")


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
    dz = _masked_dy(x, dy, a, b, relu)
    xm = _up(x) - _chan(mean, x)
    return dz.sum(_red(x)), (dz * xm).sum(_red(x))


def phase2_plain(x, dy, a, b, mean, g, c1, c2, relu: bool):
    dz = _masked_dy(x, dy, a, b, relu)
    xm = _up(x) - _chan(mean, x)
    dx = _chan(g, x) * (dz - _chan(c1, x) - xm * _chan(c2, x))
    return dx.to(x.dtype)


# ----------------------------------------------------------------------
# wrappers
def bn_bwd_phase1(x, dy, a, b, mean, relu: bool):
    """Per-channel ``(sum(dz), sum(dz * (x - mean)))`` in float32 (float64
    for float64 input)."""
    _check(x, dy, {"a": a, "b": b}, {"mean": mean})
    if x.device.type == "cpu":
        return phase1_plain(x, dy, a, b, mean, relu)
    k = _kernels()
    r, c, hw, w, sx = _nhwc_geometry(x)
    _, _, _, _, sy = _nhwc_geometry(dy)
    block_r, block_c = _blocks(c)
    n_cblk = _cdiv(c, block_c)
    # enough row tiles for ~8 programs per SM, each a whole number of
    # BLOCK_R-row steps
    tiles = max(1, 1056 // n_cblk)
    rows = _cdiv(_cdiv(r, tiles), block_r) * block_r
    n_rt = _cdiv(r, rows)
    p1 = torch.empty((n_rt, c), dtype=mean.dtype, device=x.device)
    p2 = torch.empty((n_rt, c), dtype=mean.dtype, device=x.device)
    name = kernel_name(1, relu)
    getattr(k, name)[(n_rt, n_cblk)](
        x, dy, a, b, mean, p1, p2, r, c, hw, w, rows, *sx, *sy,
        BLOCK_R=block_r, BLOCK_C=block_c,
        ACC=k.acc_dtype(x.dtype == torch.float64), num_warps=4,
        enable_fp_fusion=False)
    LAUNCHES[name] += 1
    return p1.sum(0), p2.sum(0)


def bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu: bool):
    """``dx = g * (dz - c1 - (x - mean) * c2)`` in x's dtype and layout."""
    _check(x, dy, {"a": a, "b": b},
           {"mean": mean, "g": g, "c1": c1, "c2": c2})
    if x.device.type == "cpu":
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


def fold(s1, s2, gamma, inv, n_rows: int):
    """Per-channel fold between the phases: (dgamma, dbeta, g, c1, c2)."""
    dgamma = inv * s2
    g = gamma.float() * inv
    c1 = s1 / n_rows
    c2 = inv * dgamma / n_rows
    return dgamma, s1, g, c1, c2


def bn_relu_bwd(x, dy, gamma, mean, inv, a, b, relu: bool):
    """Backward of ``[relu](x * a + b)`` with batch statistics ``mean`` and
    ``inv = rsqrt(var + eps)``: returns (dx, dgamma, dbeta), the last two
    in the statistics' dtype."""
    s1, s2 = bn_bwd_phase1(x, dy, a, b, mean, relu)
    n_rows = x.numel() // x.shape[1]
    dgamma, dbeta, g, c1, c2 = fold(s1, s2, gamma, inv, n_rows)
    dx = bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu)
    return dx, dgamma, dbeta


def bn_relu_bwd_plain(x, dy, gamma, mean, inv, a, b, relu: bool):
    """The same function as :func:`bn_relu_bwd`, through the plain versions
    on any device (what the kernels are held against)."""
    s1, s2 = phase1_plain(x, dy, a, b, mean, relu)
    dgamma, dbeta, g, c1, c2 = fold(s1, s2, gamma, inv,
                                    x.numel() // x.shape[1])
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
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, mean, inv, a, b = ctx.saved_tensors
        dx, dgamma, dbeta = bn_relu_bwd(x, dout, gamma, mean, inv, a, b,
                                        ctx.relu)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None
