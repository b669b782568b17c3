"""The port's ops (the ResNet-50 slice's, then the SameDiff/GPT slice's)
against ``deeplearning4j_tpu.ops``.

The same seeded float32 inputs go through both; the port takes NCHW
tensors and OIHW weights, the JAX ops here run ``data_format="NCHW"`` with
HWIO weights. Tolerance 1e-5 (float32 sums in another order); 1e-4 for
the convolutions, whose outputs sum up to 245 products of unit-scale
inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import elementwise as jel
from deeplearning4j_tpu.ops import loss as jloss
from deeplearning4j_tpu.ops import nn_ops as jnn
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.ops import shape_ops as jshape
from deeplearning4j_tpu.ops.registry import get_op
from deeplearning4j_tpu_torch.ops import elementwise as pel
from deeplearning4j_tpu_torch.ops import loss as ploss
from deeplearning4j_tpu_torch.ops import nn_ops as pnn
from deeplearning4j_tpu_torch.ops import reduce as pred
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.ops import shape_ops as pshape

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("padding,stride,k,bias,size", [
    ("VALID", 1, 3, False, 9),
    ("SAME", 1, 3, True, 9),
    ("SAME", 2, 3, True, 9),        # total pad 2: (1, 1)
    ("SAME", 2, 4, False, 10),      # total pad 2, k even
    ("SAME", 1, 4, True, 8),        # total pad 3: (1, 2), extra at the end
    ("VALID", 2, 7, True, 21),      # the stem's conv
])
def test_conv2d(padding, stride, k, bias, size):
    rng = _rng(1)
    x = rng.normal(size=(2, 5, size, size + 1)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32) if bias else None
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b),
                      strides=(stride, stride), padding=padding,
                      data_format="NCHW")
    xt = torch.as_tensor(x).contiguous(memory_format=torch.channels_last)
    got = pnn.conv2d(xt, torch.as_tensor(w.transpose(3, 2, 0, 1)),
                     None if b is None else torch.as_tensor(b),
                     strides=(stride, stride), padding=padding)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("padding,k,stride,size", [
    ("VALID", 3, 2, 16), ("VALID", 2, 2, 9), ("SAME", 3, 2, 8),
    ("SAME", 2, 1, 7)])
def test_max_pool2d(padding, k, stride, size):
    x = _rng(2).normal(size=(2, 4, size, size)).astype(np.float32)
    want = jnn.max_pool2d(jnp.asarray(x), kernel=(k, k),
                          strides=(stride, stride), padding=padding,
                          data_format="NCHW")
    got = pnn.max_pool2d(torch.as_tensor(x), (k, k), (stride, stride),
                         padding)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_batchnorm_inference():
    rng = _rng(3)
    x = rng.normal(size=(3, 6, 4, 5)).astype(np.float32)
    mean, gamma, beta = (rng.normal(size=(6,)).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=(6,)).astype(np.float32)
    want = jnn.batchnorm(*map(jnp.asarray, (x, mean, var, gamma, beta)),
                         epsilon=1e-5, axis=1)
    got = pnn.batchnorm(*map(torch.as_tensor, (x, mean, var, gamma, beta)),
                        epsilon=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (16, 7)])
def test_batchnorm_train_out_and_running_stats(shape):
    rng = _rng(4)
    c = shape[1]
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    gamma = rng.normal(size=(c,)).astype(np.float32)
    beta = rng.normal(size=(c,)).astype(np.float32)
    rm = rng.normal(size=(c,)).astype(np.float32)
    rv = rng.uniform(0.5, 2, size=(c,)).astype(np.float32)
    want = jnn.batchnorm_train(*map(jnp.asarray, (x, gamma, beta, rm, rv)),
                               momentum=0.9, epsilon=1e-5, axis=1)
    got = pnn.batchnorm_train(*map(torch.as_tensor, (x, gamma, beta, rm, rv)),
                              momentum=0.9, epsilon=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_batchnorm_train_bf16_keeps_stats_f32_and_output_bf16():
    rng = _rng(5)
    x = rng.normal(size=(4, 8, 3, 3)).astype(np.float32)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    g, b = torch.ones(8, dtype=torch.bfloat16), torch.zeros(
        8, dtype=torch.bfloat16)
    out, m, v = pnn.batchnorm_train(xb, g, b, torch.zeros(8), torch.ones(8))
    assert out.dtype == torch.bfloat16
    assert m.dtype == torch.float32 and v.dtype == torch.float32
    want = jnn.batchnorm_train(jnp.asarray(x, jnp.bfloat16),
                               jnp.ones(8, jnp.bfloat16),
                               jnp.zeros(8, jnp.bfloat16),
                               jnp.zeros(8, jnp.float32),
                               jnp.ones(8, jnp.float32), axis=1)
    np.testing.assert_allclose(_np(m), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(_np(v), np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_softmax_cross_entropy(dtype):
    rng = _rng(6)
    logits = rng.normal(size=(8, 10)).astype(np.float32) * 3
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == "bfloat16" else None)
    pl = torch.as_tensor(logits).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = jloss.softmax_cross_entropy(jl, jnp.asarray(labels))
    got = ploss.softmax_cross_entropy(pl, torch.as_tensor(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_relu_softmax_pad_reduce_mean():
    x = _rng(7).normal(size=(2, 3, 4, 5)).astype(np.float32)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(_np(pel.relu(xt)),
                                  np.asarray(jel.relu(jnp.asarray(x))))
    np.testing.assert_allclose(_np(pel.softmax(xt)),
                               np.asarray(jel.softmax(jnp.asarray(x))),
                               **TOL)
    pads = ((0, 0), (0, 0), (3, 3), (1, 2))
    np.testing.assert_array_equal(
        _np(pshape.pad(xt, pads)),
        np.asarray(jshape.pad(jnp.asarray(x), pads)))
    np.testing.assert_allclose(
        _np(pred.reduce_mean(xt, axis=(2, 3))),
        np.asarray(get_op("reduce_mean")(jnp.asarray(x), axis=(2, 3))),
        **TOL)


# ----------------------------------------------------------------------
# the GPT / SameDiff slice's ops (registered by name on both sides)
SLICE_OPS = ["add", "relu", "gelu", "softmax", "matmul", "mmul", "einsum",
             "reshape", "permute", "split", "slice", "layer_norm",
             "embedding_lookup", "bias_add", "scaled_dot_product_attention",
             "softmax_cross_entropy", "sparse_softmax_cross_entropy"]


def test_registry_holds_the_slice_ops_under_the_jax_names():
    names = preg.op_names()
    for n in SLICE_OPS:
        assert preg.has_op(n) and jreg.has_op(n), n
        assert preg.get_op(n).category == jreg.get_op(n).category, n
    assert preg.get_op("mmul") is preg.get_op("matmul")
    assert set(names) <= set(jreg.op_names())
    with pytest.raises(KeyError, match="unknown op"):
        preg.get_op("no_such_op")


def _both(name, *arrays, **attrs):
    want = jreg.get_op(name)(*map(jnp.asarray, arrays), **attrs)
    got = preg.exec_op(name, *arrays, **attrs)
    return got, want


@pytest.mark.parametrize("name,shapes,attrs", [
    ("add", [(3, 4), (4,)], {}),
    ("gelu", [(5, 7)], {}),
    ("gelu", [(5, 7)], {"precise": True}),
    ("relu", [(5, 7)], {}),
    ("softmax", [(3, 4, 5)], {"axis": 1}),
    ("matmul", [(2, 3, 4), (4, 5)], {}),
    ("matmul", [(4, 3), (5, 4)], {"transpose_a": True, "transpose_b": True}),
    ("matmul", [(3, 4), (4, 5)], {"transpose_result": True}),
    ("einsum", [(2, 3, 4), (5, 4)], {"equation": "bsh,vh->bsv"}),
    ("reshape", [(2, 3, 4)], {"shape": (2, 12)}),
    ("permute", [(2, 3, 4, 5)], {"axes": (0, 2, 1, 3)}),
    ("slice", [(6, 5)], {"begin": (1, 0), "size": (3, -1)}),
    ("bias_add", [(2, 3, 4), (4,)], {}),
    ("bias_add", [(8, 10), (10,)], {}),
    ("layer_norm", [(2, 5, 8), (8,), (8,)], {"epsilon": 1e-5}),
    ("layer_norm", [(4, 8), (8,)], {}),
])
def test_slice_op_matches_jax(name, shapes, attrs):
    rng = _rng(11)
    arrays = [(rng.normal(size=s) * 2 + 0.5).astype(np.float32)
              for s in shapes]
    got, want = _both(name, *arrays, **attrs)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_split_returns_views():
    x = _rng(12).normal(size=(2, 3, 12)).astype(np.float32)
    got, want = _both("split", x, num_split=3, axis=2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert g.stride()[-1] == 1 and not g.is_contiguous()


def test_layer_norm_bf16_keeps_f32_moments_and_bf16_output():
    """bf16 input: one-pass float32 moments, output in bf16 (one bf16
    rounding per operation on each side: held to 2e-2 of max|out|)."""
    rng = _rng(13)
    x = (rng.normal(size=(4, 16, 32)) * 3 + 20).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    want = jnn.layer_norm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(g, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16))
    got = pnn.layer_norm(torch.as_tensor(x).bfloat16(),
                         torch.as_tensor(g).bfloat16(),
                         torch.as_tensor(b).bfloat16())
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    assert np.max(np.abs(_np(got) - w)) <= 2e-2 * np.max(np.abs(w))


def test_embedding_lookup_takes_int32_ids():
    rng = _rng(14)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = pnn.embedding_lookup(torch.as_tensor(table), torch.as_tensor(ids))
    want = jnn.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("tail", [None, "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_softmax_cross_entropy_and_its_tail_scope(dtype, tail):
    """Integer targets; the log-softmax tail in float32 unless the scope
    names bf16; the per-token losses reduced in float32. bf16 anywhere:
    held to 1e-2 (one bf16 rounding of each log-probability)."""
    rng = _rng(15)
    logits = (rng.normal(size=(4, 6, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jloss.softmax_dtype_scope(tail):
        want = jloss.sparse_softmax_cross_entropy(
            jnp.asarray(logits, jdt), jnp.asarray(labels))
    with ploss.softmax_dtype_scope(tail):
        got = ploss.sparse_softmax_cross_entropy(
            torch.as_tensor(logits).to(getattr(torch, dtype)),
            torch.as_tensor(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    tol = 1e-5 if dtype == "float32" and tail is None else 1e-2
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol)
    assert ploss.softmax_dtype() is None        # the scope is gone


def test_softmax_cross_entropy_tail_scope_in_bf16():
    rng = _rng(16)
    logits = (rng.normal(size=(8, 10)) * 3).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    with jloss.softmax_dtype_scope("bfloat16"):
        want = jloss.softmax_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels))
    with ploss.softmax_dtype_scope("bfloat16"):
        got = ploss.softmax_cross_entropy(torch.as_tensor(logits),
                                          torch.as_tensor(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-2)
