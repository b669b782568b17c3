"""Triton source of the BN(+ReLU) backward's phase 2 for Hopper.

Loaded by :func:`deeplearning4j_tpu_torch.kernels.bn_relu._kernels` at
the first launch on a CUDA tensor, never when the package is imported:
it needs the ``triton`` package, which only a machine with a card has.
The design notes, the bound and the plain versions are in ``bn_relu.py``.
"""
import triton
import triton.language as tl


def acc_dtype(float64: bool):
    """The kernels' arithmetic type: float32 for float32 and bf16
    inputs, float64 for float64 inputs."""
    return tl.float64 if float64 else tl.float32


@triton.jit
def _dz(x, dy, a, b, RELU: tl.constexpr, ACC: tl.constexpr):
    # z = (x * a) + b with a rounding to x's dtype after each op, as
    # the forward computed it; only its sign is needed
    if RELU:
        p = (x.to(ACC) * a.to(ACC)).to(x.dtype)
        z = (p.to(ACC) + b.to(ACC)).to(x.dtype)
        dz = tl.where(z > 0, dy, 0.0)
    else:
        dz = dy
    return dz


@triton.jit
def _row_offsets(rows, HW, W, sn, sh, sw):
    r = rows.to(tl.int64)
    n = r // HW
    hw = r % HW
    return n * sn + (hw // W) * sh + (hw % W) * sw


@triton.jit
def _phase2(x_ptr, dy_ptr, dx_ptr, a_ptr, b_ptr, mean_ptr, g_ptr,
                   c1_ptr, c2_ptr, R, C, HW, W,
                   sxn, sxh, sxw, sxc, syn, syh, syw, syc,
                   son, soh, sow, soc,
                   RELU: tl.constexpr, BLOCK_R: tl.constexpr,
                   BLOCK_C: tl.constexpr, ACC: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    m = (rows < R)[:, None] & cmask[None, :]
    a = tl.load(a_ptr + cols, mask=cmask, other=0.0)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
    g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
    c1 = tl.load(c1_ptr + cols, mask=cmask, other=0.0)
    c2 = tl.load(c2_ptr + cols, mask=cmask, other=0.0)
    c64 = cols.to(tl.int64)
    xo = _row_offsets(rows, HW, W, sxn, sxh, sxw)
    yo = _row_offsets(rows, HW, W, syn, syh, syw)
    oo = _row_offsets(rows, HW, W, son, soh, sow)
    x = tl.load(x_ptr + xo[:, None] + (c64 * sxc)[None, :], mask=m,
                other=0.0)
    dy = tl.load(dy_ptr + yo[:, None] + (c64 * syc)[None, :], mask=m,
                 other=0.0).to(ACC)
    dz = _dz(x, dy, a[None, :], b[None, :], RELU, ACC)
    xm = x.to(ACC) - mean[None, :]
    dx = g[None, :] * (dz - c1[None, :] - xm * c2[None, :])
    tl.store(dx_ptr + oo[:, None] + (c64 * soc)[None, :],
             dx.to(dx_ptr.dtype.element_ty), mask=m)


# One kernel per ReLU flag, so that launch counts and profiles name each
# specialization. Phase 1 is CUDA C++ (csrc/bn_bwd_reduce.cu).
@triton.jit
def bn_relu_bwd_phase2(x_ptr, dy_ptr, dx_ptr, a_ptr, b_ptr, mean_ptr, g_ptr,
                       c1_ptr, c2_ptr, R, C, HW, W, sxn, sxh, sxw, sxc,
                       syn, syh, syw, syc, son, soh, sow, soc,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                       ACC: tl.constexpr):
    _phase2(x_ptr, dy_ptr, dx_ptr, a_ptr, b_ptr, mean_ptr, g_ptr, c1_ptr,
            c2_ptr, R, C, HW, W, sxn, sxh, sxw, sxc, syn, syh, syw, syc,
            son, soh, sow, soc, True, BLOCK_R, BLOCK_C, ACC)


@triton.jit
def bn_bwd_phase2(x_ptr, dy_ptr, dx_ptr, a_ptr, b_ptr, mean_ptr, g_ptr,
                  c1_ptr, c2_ptr, R, C, HW, W, sxn, sxh, sxw, sxc,
                  syn, syh, syw, syc, son, soh, sow, soc,
                  BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                  ACC: tl.constexpr):
    _phase2(x_ptr, dy_ptr, dx_ptr, a_ptr, b_ptr, mean_ptr, g_ptr, c1_ptr,
            c2_ptr, R, C, HW, W, sxn, sxh, sxw, sxc, syn, syh, syw, syc,
            son, soh, sow, soc, False, BLOCK_R, BLOCK_C, ACC)
