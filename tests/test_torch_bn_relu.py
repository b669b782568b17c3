"""The port's BN(+ReLU) backward (kernels/bn_relu.py) against the TPU
kernel pair it replaces and against JAX autodiff.

On the CPU the wrappers run the kernels' plain versions. They are held to:

(a) the spike's ``bn_relu_bwd_pallas`` (``experiments/pallas_bn_spike.py``,
    loaded by path) run in Pallas interpret mode;
(b) ``jax.grad`` of the JAX package's ``batchnorm_train`` + ``relu``;
(c) torch autograd of the port's own plain forward.

float32 tolerances are 1e-5 relative to each result's largest magnitude:
the functions are the same and only the order of the f32 sums differs.
The kernels themselves (phase 1 in CUDA C++, phase 2 in Triton) run only
on the card (``tests/test_torch_card.py``); phase 1's fused contract is
held to JAX in ``tests/test_torch_bn_reduce.py``.
"""
import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deeplearning4j_tpu.ops.nn_ops import batchnorm_train as jax_bn_train
from deeplearning4j_tpu_torch.kernels import bn_relu
from deeplearning4j_tpu_torch.ops.nn_ops import batchnorm_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch here: the suite runs six test files at
    once, and timing-sensitive tests elsewhere must not starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spike():
    spec = importlib.util.spec_from_file_location(
        "pallas_bn_spike", ROOT / "experiments" / "pallas_bn_spike.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the spike's two pl.pallas_call sites, in interpret mode on the CPU
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def _inputs(shape, seed=0, dtype=np.float32):
    """x with a per-channel offset (biased convolutions give BN inputs a
    mean), dy, gamma, beta."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) + rng.normal(size=(c,)) * 2.0).astype(dtype)
    dy = rng.normal(size=shape).astype(dtype)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, dy, gamma, beta


def _to_nchw(a):
    a = torch.as_tensor(a)
    return a.permute(0, 3, 1, 2) if a.dim() == 4 else a


def _port(x, dy, gamma, beta, relu):
    """Port forward stats + plain backward on (R, C) or NHWC numpy input
    (given to the port as a channels-last NCHW view)."""
    xt, dyt = _to_nchw(x), _to_nchw(dy)
    g, b = torch.as_tensor(gamma), torch.as_tensor(beta)
    _, mean, _, inv, a, bb = bn_relu.bn_train_forward(xt, g, b, EPS, relu)
    dx, dg, db = bn_relu.bn_relu_bwd(xt, dyt, g, mean, inv, a, bb, relu)
    if dx.dim() == 4:
        dx = dx.permute(0, 2, 3, 1)
    return dx.numpy(), dg.numpy(), db.numpy(), mean.numpy(), inv.numpy()


def _jax_grad(x, dy, gamma, beta, relu):
    axis = x.ndim - 1            # a positive channel axis: per-channel stats

    def loss(xx, g, b):
        out, _, _ = jax_bn_train(xx, g, b, jnp.zeros_like(g),
                                 jnp.ones_like(g), 0.9, EPS, axis)
        return jnp.sum((jax.nn.relu(out) if relu else out) * dy)

    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))]


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    assert err <= rtol, err


SPIKE_SHAPES = [(4, 8, 8, 64), (2, 8, 8, 128)]


@pytest.mark.parametrize("shape", SPIKE_SHAPES)
def test_plain_matches_spike_pallas_kernel_interpreted(spike, shape):
    x, dy, gamma, beta = _inputs(shape)
    dx, dg, db, mean, inv = _port(x, dy, gamma, beta, relu=True)
    r = int(np.prod(shape[:-1]))
    sdx, sdg, sdb = spike.bn_relu_bwd_pallas(
        jnp.asarray(x.reshape(r, -1)), jnp.asarray(dy.reshape(r, -1)),
        jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(mean),
        jnp.asarray(inv), row_tile=64)
    _close(dx.reshape(r, -1), sdx, 1e-5)
    _close(dg, sdg, 1e-5)
    _close(db, sdb, 1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(4, 8, 8, 64), (3, 7, 9, 100),
                                   (189, 100)])
def test_plain_matches_jax_grad_of_batchnorm_train(shape, relu):
    x, dy, gamma, beta = _inputs(shape, seed=1)
    dx, dg, db, _, _ = _port(x, dy, gamma, beta, relu)
    jdx, jdg, jdb = _jax_grad(x, dy, gamma, beta, relu)
    _close(dx, jdx, 1e-5)
    _close(dg, jdg, 1e-5)
    _close(db, jdb, 1e-5)


@pytest.mark.parametrize("relu", [True, False])
def test_autograd_function_matches_torch_autograd_of_plain_forward(relu):
    x, dy, gamma, beta = _inputs((3, 7, 9, 24), seed=2)
    xt = _to_nchw(x).contiguous(memory_format=torch.channels_last)
    dyt = _to_nchw(dy)                     # NCHW-strided dy, as autograd
    grads = []                             # can hand it over
    for fused in (True, False):
        xx = xt.clone().requires_grad_(True)
        g = torch.as_tensor(gamma).requires_grad_(True)
        b = torch.as_tensor(beta).requires_grad_(True)
        if fused:
            out, _, _ = batchnorm_train(xx, g, b, torch.zeros(24),
                                        torch.ones(24), epsilon=EPS,
                                        relu=relu)
        else:
            out = bn_relu.bn_train_forward(xx, g, b, EPS, relu)[0]
        (out * dyt).sum().backward()
        grads.append([xx.grad, g.grad, b.grad])
    for mine, ref in zip(*grads):
        _close(mine.detach().numpy(), ref.numpy(), 1e-5)
    assert grads[0][0].is_contiguous(memory_format=torch.channels_last)


def test_bf16_plain_backward_against_f32_reference():
    """bf16 input. The ReLU mask is recomputed with the forward's own bf16
    rounding, so it equals the bf16 forward's mask exactly. Given that
    mask, the backward is the float32 math on the bf16 values: dgamma and
    dbeta (float32 sums of the same products) hold to 1e-5, dx (rounded
    to bf16, 8 bits) to 1e-2 of max |dx|.

    Against the float32 forward's mask, the bf16 mask differs where the
    bf16 pre-activation rounds across 0, on under 1% of the elements
    here. Many land there because a channel's ``x * a`` and ``b`` are
    large and of opposite sign, and bf16 spaces them 2^-5 apart near 4.
    Each flip moves its channel's dbeta by one dy, which is why a bf16
    step is held to its own mask and not to the float32 one."""
    shape = (4, 8, 8, 64)
    x, dy, gamma, beta = _inputs(shape, seed=3)
    xb = _to_nchw(torch.as_tensor(x).to(torch.bfloat16))
    dyb = _to_nchw(torch.as_tensor(dy).to(torch.bfloat16))
    g, b = torch.as_tensor(gamma), torch.as_tensor(beta)
    out, mean, _, inv, a, bb = bn_relu.bn_train_forward(xb, g, b, EPS, True)
    dx, dg, db = bn_relu.bn_relu_bwd(xb, dyb, g, mean, inv, a, bb, True)
    assert dx.dtype == torch.bfloat16 and dg.dtype == torch.float32
    mask = out > 0
    dz = bn_relu._masked_dy(xb, dyb, a, bb, True)
    np.testing.assert_array_equal((dz != 0).numpy(),
                                  (mask & (dyb != 0)).numpy())
    # the same math in float32, on the bf16 values, under the bf16 mask
    xf = xb.float()
    dzf = torch.where(mask, dyb.float(), 0.0)
    rdx, rdg, rdb = bn_relu.bn_relu_bwd(
        xf, dzf, g, mean, inv, (g * inv), (b - g * inv * mean), False)
    _close(dx.float().numpy(), rdx.numpy(), 1e-2)
    _close(dg.numpy(), rdg.numpy(), 1e-5)
    _close(db.numpy(), rdb.numpy(), 1e-5)
    z32 = xf * _c(g * inv) + _c(b - g * inv * mean)
    flipped = (mask != (z32 > 0)).float().mean().item()
    assert 0 < flipped < 1e-2


def _c(v):
    return v.view(1, -1, 1, 1)


def test_phase_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    x, dy, gamma, beta = _inputs((2, 4, 4, 16), seed=4)
    xt, dyt = _to_nchw(x), _to_nchw(dy)
    g, b = torch.as_tensor(gamma), torch.as_tensor(beta)
    _, mean, _, inv, a, bb = bn_relu.bn_train_forward(xt, g, b, EPS, True)
    before = dict(bn_relu.LAUNCHES)
    got = bn_relu.bn_bwd_phase1(xt, dyt, a, bb, mean, inv, g, True)
    want = bn_relu.phase1_fold_plain(xt, dyt, a, bb, mean, inv, g, True)
    for k, p in zip(got, want):
        torch.testing.assert_close(k, p, rtol=0, atol=0)
    g2, c1, c2 = want[2:]
    dx = bn_relu.bn_bwd_phase2(xt, dyt, a, bb, mean, g2, c1, c2, True)
    torch.testing.assert_close(
        dx, bn_relu.phase2_plain(xt, dyt, a, bb, mean, g2, c1, c2, True),
        rtol=0, atol=0)
    assert bn_relu.LAUNCHES == before


def test_wrappers_raise_on_what_they_do_not_take():
    x = torch.zeros(8, 4)
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="does not match"):
        bn_relu.bn_bwd_phase1(x, torch.zeros(8, 5), v, v, v, v, v, True)
    with pytest.raises(ValueError, match="mean"):
        bn_relu.bn_bwd_phase1(x, x, v, v, torch.zeros(4, dtype=torch.float64),
                              v, v, True)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.zeros(8, 4, device="meta")
        mv = torch.zeros(4, device="meta")
        bn_relu.bn_bwd_phase1(m, m, mv, mv, mv, mv, mv, True)
    with pytest.raises(ValueError, match=r"\(R, C\) or \(N, C, H, W\)"):
        bn_relu.bn_bwd_phase1(torch.zeros(2, 4, 3), torch.zeros(2, 4, 3),
                              v, v, v, v, v, True)
    with pytest.raises(ValueError, match="c1"):
        bn_relu.bn_bwd_phase2(x, x, v, v, v, v, torch.zeros(5), v, True)
