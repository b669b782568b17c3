"""Phase 1 of the port's BN backward with its fold (``bn_bwd_phase1``, one
CUDA C++ launch on the card, ``csrc/bn_bwd_reduce.cu``), on the CPU.

On the CPU the wrapper runs the kernel's plain version,
``phase1_fold_plain``. It is held to:

(a) ``fold(phase1_plain(...))`` followed by the casts to gamma's dtype,
    exactly (it is that composition);
(b) ``jax.grad`` of the JAX package's ``batchnorm_train`` (+ ``relu``) for
    dgamma and dbeta, from the same numpy-seeded inputs: 1e-5 of the
    largest magnitude in float32 and 1e-10 in float64 (the same function;
    only the order of the sums differs). ``batchnorm_train`` casts gamma
    and beta to float32 (``ops/nn_ops.py:355-357``), so in float64 its
    gamma and beta cotangents come back rounded to float32; the float64
    case therefore runs it with that cast read as float64 (its module's
    ``jnp.float32``, for the duration of the test), on a gamma and beta
    that float32 holds exactly, so the forward is unchanged.

The rest checks what surrounds the kernel without a card: the launch
plan, the vector-path test on strides, the ``nvcc`` build command and the
library's name, the ``ctypes`` declaration against the C source, the
checks that refuse what the kernel does not take, and that importing the
port needs no ``nvcc``. The kernel itself runs in
``tests/test_torch_card.py``.
"""
import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import nn_ops as jax_nn_ops
from deeplearning4j_tpu.ops.nn_ops import batchnorm_train as jax_bn_train
from deeplearning4j_tpu_torch.kernels import _cuda, bn_relu

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 1e-5
# the main path's BN inputs (ResNet-50 at 224x224, batch 128): (R, C)
PATH_SHAPES = [(128 * 112 * 112, 64), (128 * 55 * 55, 64),
               (128 * 55 * 55, 256), (128 * 28 * 28, 128),
               (128 * 28 * 28, 512), (128 * 14 * 14, 256),
               (128 * 14 * 14, 1024), (128 * 7 * 7, 512),
               (128 * 7 * 7, 2048)]


def _inputs(shape, dtype, seed=0):
    """NHWC numpy x with a per-channel offset, dy, gamma, beta."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) + rng.normal(size=(c,)) * 2.0).astype(dtype)
    dy = rng.normal(size=shape).astype(dtype)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, dy, gamma, beta


def _to_port(a):
    """An NHWC numpy array as the port's channels-last NCHW view."""
    t = torch.as_tensor(a)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _port_stats(x, gamma, beta, relu):
    _, mean, _, inv, a, b = bn_relu.bn_train_forward(x, gamma, beta, EPS,
                                                     relu)
    return mean, inv, a, b


class _Float64Stats:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float64, torch.float64)])
def test_plain_fused_is_fold_of_phase1_plain_then_casts(dtype, gdtype, relu):
    x, dy, gamma, beta = _inputs((3, 7, 9, 100), np.float64, seed=1)
    xt, dyt = _to_port(x).to(dtype), _to_port(dy).to(dtype)
    g, b = torch.as_tensor(gamma).to(gdtype), torch.as_tensor(beta).to(gdtype)
    mean, inv, a, bb = _port_stats(xt, g, b, relu)
    got = bn_relu.phase1_fold_plain(xt, dyt, a, bb, mean, inv, g, relu)
    s1, s2 = bn_relu.phase1_plain(xt, dyt, a, bb, mean, relu)
    dgamma, dbeta, gg, c1, c2 = bn_relu.fold(s1, s2, g, inv, 3 * 7 * 9)
    want = (dgamma.to(gdtype), dbeta.to(gdtype), gg, c1, c2)
    for k, w in zip(got, want):
        assert k.dtype == w.dtype and torch.equal(k, w)
    assert got[0].dtype == gdtype and got[2].dtype == mean.dtype
    # the fold's own algebra: c2 = inv^2 * s2 / R, g = gamma * inv
    torch.testing.assert_close(c2, inv * inv * s2 / (3 * 7 * 9))
    torch.testing.assert_close(gg, g.to(inv.dtype) * inv)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(3, 7, 9, 100), (4, 8, 8, 64),
                                   (189, 100)])
def test_plain_fused_matches_jax_grad_of_batchnorm_train(shape, relu, dtype,
                                                         rtol, monkeypatch):
    x, dy, gamma, beta = _inputs(shape, dtype, seed=2)
    if dtype == np.float64:
        monkeypatch.setattr(jax_nn_ops, "jnp", _Float64Stats())
    gamma, beta = gamma.astype(dtype), beta.astype(dtype)
    axis = x.ndim - 1            # a positive channel axis: per-channel stats

    def loss(g, b):
        out, _, _ = jax_bn_train(jnp.asarray(x), g, b, jnp.zeros_like(g),
                                 jnp.ones_like(g), 0.9, EPS, axis)
        return jnp.sum((jax.nn.relu(out) if relu else out) * dy)

    jdg, jdb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(gamma),
                                              jnp.asarray(beta))
    xt, dyt = _to_port(x), _to_port(dy)
    g, b = torch.as_tensor(gamma), torch.as_tensor(beta)
    mean, inv, a, bb = _port_stats(xt, g, b, relu)
    dg, db, _, _, _ = bn_relu.bn_bwd_phase1(xt, dyt, a, bb, mean, inv, g,
                                           relu)
    assert dg.dtype == db.dtype == g.dtype
    _close(dg.numpy(), np.asarray(jdg), rtol)
    _close(db.numpy(), np.asarray(jdb), rtol)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    x, dy, gamma, beta = _inputs((2, 5, 5, 48), np.float32, seed=3)
    xt = _to_port(x).to(torch.bfloat16)
    dyt = _to_port(dy).to(torch.bfloat16).contiguous()     # NCHW dy
    g, b = (torch.as_tensor(v).to(torch.bfloat16) for v in (gamma, beta))
    mean, inv, a, bb = _port_stats(xt, g, b, True)
    before = dict(bn_relu.LAUNCHES)
    got = bn_relu.bn_bwd_phase1(xt, dyt, a, bb, mean, inv, g, True)
    want = bn_relu.phase1_fold_plain(xt, dyt, a, bb, mean, inv, g, True)
    for k, w in zip(got, want):
        assert k.dtype == w.dtype and torch.equal(k, w)
    dx, dgamma, dbeta = bn_relu.bn_relu_bwd(xt, dyt, g, mean, inv, a, bb,
                                            True)
    assert dgamma.dtype == dbeta.dtype == torch.bfloat16
    assert dx.dtype == torch.bfloat16 and dx.stride() == xt.stride()
    assert bn_relu.LAUNCHES == before


def test_batchnorm_backward_returns_grads_in_gamma_dtype_without_casts():
    x, dy, gamma, beta = _inputs((2, 4, 4, 16), np.float32, seed=4)
    xt = _to_port(x).to(torch.bfloat16).requires_grad_(True)
    g = torch.as_tensor(gamma).to(torch.bfloat16).requires_grad_(True)
    b = torch.as_tensor(beta).to(torch.bfloat16).requires_grad_(True)
    out, _, _ = bn_relu.BatchNormTrain.apply(xt, g, b, EPS, True)
    dx, dg, db = torch.autograd.grad(out, (xt, g, b),
                                     _to_port(dy).to(torch.bfloat16))
    mean, inv, a, bb = _port_stats(xt.detach(), g.detach(), b.detach(), True)
    want = bn_relu.bn_relu_bwd_plain(xt.detach(), _to_port(dy).to(
        torch.bfloat16), g.detach(), mean, inv, a, bb, True)
    for k, w in zip((dx, dg, db), want):
        assert k.dtype == w.dtype and torch.equal(k, w)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x = torch.zeros(8, 4)
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="does not take"):
        h = torch.zeros(8, 4, dtype=torch.float16, device="meta")
        hv = torch.zeros(4, dtype=torch.float16, device="meta")
        fv = torch.zeros(4, device="meta")
        bn_relu.bn_bwd_phase1(h, h, hv, hv, fv, fv, fv, True)
    with pytest.raises(ValueError, match="does not match"):
        bn_relu.bn_bwd_phase1(x, torch.zeros(8, 5), v, v, v, v, v, True)
    with pytest.raises(ValueError, match="does not match"):
        bn_relu.bn_bwd_phase1(x, x.double(), v, v, v, v, v, False)
    with pytest.raises(ValueError, match="no kernel for device"):
        m, mv = torch.zeros(8, 4, device="meta"), torch.zeros(4, device="meta")
        bn_relu.bn_bwd_phase1(m, m, mv, mv, mv, mv, mv, True)
    with pytest.raises(ValueError, match="dy on meta"):
        bn_relu.bn_bwd_phase1(x, torch.zeros(8, 4, device="meta"), v, v, v,
                              v, v, True)
    with pytest.raises(ValueError, match="inv"):
        bn_relu.bn_bwd_phase1(x, x, v, v, v, torch.zeros(5), v, True)
    with pytest.raises(ValueError, match="gamma"):
        bn_relu.bn_bwd_phase1(x, x, v, v, v, v, torch.zeros(2, 4)[:, 0],
                              True)
    with pytest.raises(ValueError, match="empty"):
        e = torch.zeros(0, 4)
        bn_relu.bn_bwd_phase1(e, e, v, v, v, v, v, True)


@pytest.mark.parametrize("r,c", PATH_SHAPES)
@pytest.mark.parametrize("elsize", [2, 4, 8])
def test_launch_plan_fills_the_card_and_covers_every_row(r, c, elsize):
    acc = 8 if elsize == 8 else 4
    tx, n_cblk, splits, rows, ws = bn_relu._phase1_plan(r, c, elsize, acc,
                                                        132)
    vec = 16 // elsize
    assert tx in (1, 2, 4, 8) and n_cblk * tx * vec >= c
    assert (n_cblk - 1) * tx * vec < c
    # ~2 blocks on each of the 132 SMs at every path shape, in one wave:
    # never more than the 2 * 132 resident blocks
    assert 2 * 132 - n_cblk < n_cblk * splits <= 2 * 132
    assert splits * rows >= r and (splits - 1) * rows < r
    assert 1 <= splits <= 65535
    # the first workspace holds every path shape: no reallocation
    assert ws <= bn_relu._WS_MIN_BYTES
    assert n_cblk <= bn_relu._COUNTERS_MIN


def test_launch_plan_of_small_shapes():
    assert bn_relu._phase1_plan(189, 100, 4, 4, 132) == (
        8, 4, 6, 32, 6 * 2 * 4 * 32 * 4)
    tx, n_cblk, splits, rows, _ = bn_relu._phase1_plan(1, 3, 2, 4, 132)
    assert (tx, n_cblk, splits, rows) == (1, 1, 1, 1)


def test_row_stride_finds_channels_last_rows_only():
    x = torch.zeros(2, 16, 3, 5)

    def rs(t):
        return bn_relu._row_stride(bn_relu._nhwc_geometry(t))

    assert rs(x.contiguous(memory_format=torch.channels_last)) == 16
    assert rs(x) == 0                                         # NCHW
    assert rs(torch.zeros(30, 16)) == 16
    assert rs(torch.zeros(30, 40)[:, :16]) == 40              # padded rows
    sub = x.contiguous(memory_format=torch.channels_last)[:, :, :, :4]
    assert rs(sub) == 0                                       # W cut: uneven
    assert rs(torch.zeros(1, 16, 1, 1)) == 16
    assert rs(torch.zeros(30, 16).t().contiguous().t()) == 0  # C strided


def test_launch_arguments_pick_the_vector_path_for_aligned_nhwc_rows():
    cl = torch.zeros(2, 16, 3, 5).contiguous(
        memory_format=torch.channels_last)
    i64, i32, nbytes, n_cblk = bn_relu._phase1_args(
        tuple(cl.shape), cl.stride(), cl.stride(), 2, 4, True, 132)
    # R, C, HW, W, row strides, (N, H, W, C) strides of x and dy, rows
    assert i64 == (30, 16, 15, 5, 16, 16, 240, 80, 16, 1, 240, 80, 16, 1,
                   30)
    # vec, tx (16 channels = 2 vectors of 8), n_cblk, splits (30 rows < TY)
    assert i32 == (1, 2, 1, 1) and n_cblk == 1 and nbytes == 2 * 16 * 4
    nchw = torch.zeros(2, 16, 3, 5)
    assert bn_relu._phase1_args(tuple(cl.shape), cl.stride(), nchw.stride(),
                                2, 4, True, 132)[1][0] == 0
    assert bn_relu._phase1_args(tuple(cl.shape), cl.stride(), cl.stride(),
                                2, 4, False, 132)[1][0] == 0
    assert bn_relu._phase1_args((2, 12, 3, 5), (180, 1, 60, 12),
                                (180, 1, 60, 12), 2, 4, True,
                                132)[1][0] == 0               # C % 8 != 0


def test_nvcc_command_targets_sm90a_into_the_ignored_build_dir():
    out = _cuda.library_path("bn_bwd_reduce")
    cmd = _cuda.build_command("bn_bwd_reduce", out, "nvcc")
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == out
    assert cmd[-1] == str(ROOT / "deeplearning4j_tpu_torch" / "csrc" /
                          "bn_bwd_reduce.cu")
    build = pathlib.Path(out).parent
    assert build == ROOT / "deeplearning4j_tpu_torch" / "_build" / "cuda"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "deeplearning4j_tpu_torch/_build/" in ignored
    assert re.fullmatch(r"libbn_bwd_reduce-[0-9a-f]{16}\.so",
                        pathlib.Path(out).name)


def test_library_name_changes_with_its_source(tmp_path):
    src = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "bn_bwd_reduce.cu"
    shutil.copy(src, tmp_path / "bn_bwd_reduce.cu")
    same = _cuda.library_path("bn_bwd_reduce", str(tmp_path))
    assert same == _cuda.library_path("bn_bwd_reduce")
    with open(tmp_path / "bn_bwd_reduce.cu", "a") as f:
        f.write("\n// edited\n")
    assert _cuda.library_path("bn_bwd_reduce", str(tmp_path)) != same


def _c_entry_params():
    """(type, name) of the C entries' parameters, from the .cu source."""
    src = (ROOT / "deeplearning4j_tpu_torch" / "csrc" /
           "bn_bwd_reduce.cu").read_text()
    m = re.search(r'extern "C" int name\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in m.group(1).replace("\\", " ").split(",")]
    assert re.findall(r"DL4J_PHASE1_ENTRY\((\w+), (true|false)\)", src) == [
        ("dl4j_bn_relu_bwd_phase1", "true"), ("dl4j_bn_bwd_phase1", "false")]
    return [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params]


def test_ctypes_declaration_matches_the_c_entries():
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    params = _c_entry_params()
    assert [n for _, n in params] == [n for n, _ in bn_relu.PHASE1_ARGTYPES]
    assert [c_types[t] for t, _ in params] == [
        t for _, t in bn_relu.PHASE1_ARGTYPES]
    # every pointer and the stream go as c_void_p: never as a 32-bit int
    pointers = [n for t, n in params if t.endswith("*")]
    assert "stream" in pointers and len(pointers) == 15
    for n, t in bn_relu.PHASE1_ARGTYPES:
        assert (t is ctypes.c_void_p) == (n in pointers)


def test_declare_sets_argtypes_and_int_result():
    class Fn:
        pass
    fn = Fn()
    _cuda.declare(fn, bn_relu.PHASE1_ARGTYPES)
    assert fn.argtypes == [t for _, t in bn_relu.PHASE1_ARGTYPES]
    assert fn.restype is ctypes.c_int
    _cuda.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _cuda.check(1, "bn_relu_bwd_phase1")


def test_loading_the_library_declares_both_entries(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    class Lib:
        dl4j_bn_relu_bwd_phase1 = Entry()
        dl4j_bn_bwd_phase1 = Entry()

    lib = Lib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert bn_relu._phase1_lib() is lib
    want = [t for _, t in bn_relu.PHASE1_ARGTYPES]
    for fn in (lib.dl4j_bn_relu_bwd_phase1, lib.dl4j_bn_bwd_phase1):
        assert fn.argtypes == want and fn.restype is ctypes.c_int


def test_importing_and_running_on_the_cpu_needs_no_nvcc(tmp_path):
    code = (
        "import sys\n"
        "import torch\n"
        "from deeplearning4j_tpu_torch.kernels import _cuda, bn_relu\n"
        "import deeplearning4j_tpu_torch.zoo, deeplearning4j_tpu_torch.nn\n"
        "x = torch.randn(2, 8, 3, 3)\n"
        "g, b = torch.ones(8), torch.zeros(8)\n"
        "_, m, _, i, a, bb = bn_relu.bn_train_forward(x, g, b, 1e-5, True)\n"
        "bn_relu.bn_relu_bwd(x, torch.randn(2, 8, 3, 3), g, m, i, a, bb, "
        "True)\n"
        "try:\n"
        "    _cuda.nvcc()\n"
        "    print('found')\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
        "print(len(_cuda._LIBS), len(_cuda.BUILDS), 'triton' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)          # no nvcc on PATH
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    if not os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        assert lines[0] == "no nvcc"
    assert lines[1] == "0 0 False"
