"""The port's ops (the ResNet-50 slice's, then the SameDiff/GPT slice's)
against ``deeplearning4j_tpu.ops``.

The same seeded float32 inputs go through both; the port takes NCHW
tensors and OIHW weights, the JAX ops here run ``data_format="NCHW"`` with
HWIO weights. Tolerance 1e-5 (float32 sums in another order); 1e-4 for
the convolutions, whose outputs sum up to 245 products of unit-scale
inputs.
"""
import jax
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
from deeplearning4j_tpu_torch.ops import dtypes as pdtypes
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


# ----------------------------------------------------------------------
# the ops the TF importer emits (BERT's graph and the import tests' graphs)
IMPORT_OPS = ["subtract", "sub", "multiply", "mul", "divide", "div",
              "squaredsubtract", "squareddifference", "greater", "gt",
              "rsqrt", "neg", "negative", "tanh", "erf", "cast",
              "reduce_mean", "mean", "reduce_sum", "sum", "argmax", "imax",
              "gather", "one_hot", "onehot", "concat", "stack",
              "where_op", "select", "batched_matmul", "batch_mmul",
              "strided_slice_masked", "tf_fused_batch_norm"]


def test_registry_holds_the_import_ops_under_the_jax_names():
    for n in IMPORT_OPS:
        assert preg.has_op(n) and jreg.has_op(n), n
        assert preg.get_op(n).name == jreg.get_op(n).name, n
        assert preg.get_op(n).category == jreg.get_op(n).category, n
    assert set(preg.op_names()) <= set(jreg.op_names())


def _same(got, want, tol=TOL, dtype=True):
    w = np.asarray(want)
    g = got.detach()
    g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
    if dtype:
        assert str(g.dtype) == str(w.dtype) or (
            got.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16), \
            (g.dtype, w.dtype)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w.astype(g.dtype), equal_nan=True, **tol)


@pytest.mark.parametrize("name,shapes,attrs", [
    ("subtract", [(3, 4), (4,)], {}),
    ("multiply", [(2, 3, 4), (3, 1)], {}),
    ("divide", [(3, 4), (3, 4)], {}),
    ("squaredsubtract", [(2, 5, 8), (2, 5, 1)], {}),
    ("greater", [(3, 4), (4,)], {}),
    ("rsqrt", [(4, 6)], {}),
    ("neg", [(4, 6)], {}),
    ("tanh", [(4, 6)], {}),
    ("erf", [(4, 6)], {}),
    ("reduce_mean", [(2, 5, 8)], {"axis": (-1,), "keep_dims": True}),
    ("reduce_mean", [(2, 5, 8)], {"axis": None}),
    ("reduce_mean", [(2, 5, 8)], {"axis": 1}),
    ("reduce_sum", [(2, 5, 8)], {"axis": (0, 2)}),
    ("reduce_sum", [(2, 5, 8)], {"axis": None, "keep_dims": True}),
    ("batched_matmul", [(2, 3, 5, 4), (2, 3, 5, 4)],
     {"transpose_b": True}),
    ("batched_matmul", [(2, 3, 4, 5), (2, 3, 4, 6)],
     {"transpose_a": True}),
    ("concat", [(2, 3), (2, 5)], {"axis": 1}),
    ("stack", [(2, 3), (2, 3), (2, 3)], {"axis": 1}),
    ("bias_add", [(2, 4, 3, 3), (4,)], {"data_format": "NCHW"}),
    ("bias_add", [(2, 3, 3, 4), (4,)], {"data_format": "NHWC"}),
])
def test_import_op_matches_jax(name, shapes, attrs):
    rng = _rng(21)
    arrays = [(np.abs(rng.normal(size=s)) + 0.1 if name == "rsqrt"
               else rng.normal(size=s) * 2).astype(np.float32)
              for s in shapes]
    got, want = _both(name, *arrays, **attrs)
    _same(got, want)


def test_argmax_gives_the_first_largest_index():
    x = np.array([[1., 5., 5., 0.], [7., 7., -1., 2.]], np.float32)
    for axis in (0, 1, -1, None):
        got, want = _both("argmax", x, axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32   # the default integer
    got, want = _both("argmax", x, axis=1, keep_dims=True)
    assert got.shape == want.shape == (2, 1)


def test_integer_reductions_and_division_take_the_jax_dtypes():
    ints = np.arange(12, dtype=np.int32).reshape(3, 4)
    bools = ints % 3 == 0
    with jax.enable_x64(False):          # the defaults the port takes
        for name, x, attrs in [("reduce_mean", ints, {"axis": 1}),
                               ("reduce_sum", ints, {}),
                               ("reduce_sum", bools, {"axis": 0})]:
            got, want = _both(name, x, **attrs)
            _same(got, want)
        got, want = _both("divide", ints, ints + 1)
        _same(got, want)
    got, want = _both("divide", ints.astype(np.int64), ints + 1)
    _same(got, want)                       # int64 divides in float64


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_cast(dtype):
    x = np.array([[-2.7, -0.5, 0.5, 1.99], [3.5, -3.5, 100.25, 0.0]],
                 np.float32)
    got, want = _both("cast", x, dtype=dtype)
    _same(got, want, tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("axis,table_shape,idx", [
    (0, (10, 6), [[1, 5, 3], [0, 2, 9]]),
    (0, (10, 6), [[-1, -10, 3], [10, 11, -11]]),   # wrapped, filled
    (1, (4, 7, 3), [6, -7, 7, 2, 2]),
    (0, (5,), [[4, 0], [5, -6]]),
])
def test_gather_keeps_jax_answers_for_any_index(axis, table_shape, idx):
    rng = _rng(22)
    x = rng.normal(size=table_shape).astype(np.float32)
    ind = np.asarray(idx, np.int32)
    got, want = _both("gather", x, ind, axis=axis)
    _same(got, want, tol=dict(rtol=0, atol=0))
    # the gradient: duplicates summed, wrapped indices to their row, an
    # out-of-range index to none
    w = rng.normal(size=np.asarray(want).shape).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jreg.get_op("gather")(
        t, jnp.asarray(ind), axis=axis) * w))(jnp.asarray(x))
    t = torch.as_tensor(x).requires_grad_(True)
    (pg,) = torch.autograd.grad(
        (pshape.gather(t, torch.as_tensor(ind), axis) * torch.as_tensor(w))
        .nansum(), [t])
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def test_gather_fills_integers_with_their_least_value():
    x = np.arange(12, dtype=np.int32).reshape(4, 3)
    got, want = _both("gather", x, np.array([3, 4, -5, -4], np.int32))
    _same(got, want, tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("attrs", [
    {"depth": 5},
    {"depth": 5, "axis": 0},
    {"depth": 4, "on_value": 3.0, "off_value": -1.0},
    {"depth": 3, "axis": 1},
])
def test_one_hot_gives_zero_rows_out_of_range(attrs):
    ind = np.array([[0, 4, -1], [5, 2, 7]], np.int32)
    got, want = _both("one_hot", ind, **attrs)
    _same(got, want, tol=dict(rtol=0, atol=0))


def test_one_hot_of_an_integer_dtype():
    ind = np.array([0, 2, 3], np.int32)
    got, want = _both("one_hot", ind, depth=3, dtype="int32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 4), dict(begin=(0, 1), end=(0, 3), strides=(1, 1),
                     begin_mask=1, end_mask=1)),
    ((2, 3, 4), dict(begin=(0, 0, 0), end=(0, 1, 0), strides=(1, 1, 1),
                     begin_mask=5, end_mask=5, shrink_axis_mask=2)),
    ((6, 5), dict(begin=(5, 1), end=(0, 5), strides=(-2, 2))),
    ((6, 5), dict(begin=(0, 0), end=(0, 0), strides=(-1, 1), begin_mask=3,
                  end_mask=3)),
    ((2, 3, 4), dict(begin=(0, 1), end=(0, 2), strides=(1, 1),
                     ellipsis_mask=1)),
    ((2, 3, 4), dict(begin=(0, 0, 1), end=(0, 0, 3), strides=(1, 1, 1),
                     new_axis_mask=2, begin_mask=1, end_mask=1)),
    ((3, 4), dict(begin=(-1,), end=(0,), strides=(1,),
                  shrink_axis_mask=1)),
    ((7,), dict(begin=(-2,), end=(-7,), strides=(-2,))),
])
def test_strided_slice_masked(shape, attrs):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got, want = _both("strided_slice_masked", x, **attrs)
    _same(got, want, tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
@pytest.mark.parametrize("is_training", [False, True])
def test_tf_fused_batch_norm(data_format, is_training):
    rng = _rng(23)
    shape = (2, 5, 6, 3) if data_format == "NHWC" else (2, 3, 5, 6)
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    c = [(rng.normal(size=3) * 0.5 + 1).astype(np.float32) for _ in range(2)]
    mean = rng.normal(size=3).astype(np.float32)
    var = (np.abs(rng.normal(size=3)) + 0.5).astype(np.float32)
    got, want = _both("tf_fused_batch_norm", x, *c, mean, var,
                      epsilon=1e-3, data_format=data_format,
                      is_training=is_training)
    for g, w in zip(got, want):
        _same(g, w)


def test_where_op_and_its_refusal():
    rng = _rng(24)
    c = rng.normal(size=(3, 4)) > 0
    x = rng.normal(size=(3, 4)).astype(np.float32)
    got, want = _both("where_op", c, x, np.float32(0.0))
    _same(got, want)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        preg.exec_op("where_op", c)


# ----------------------------------------------------------------------
# the dtype rule (ops/dtypes.py) against jnp.result_type
_DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "bfloat16",
           "float16", "float32", "float64"]


def _jt(name, ndim):
    return jnp.ones((2,) * ndim, getattr(jnp, name if name != "bool"
                                         else "bool_"))


def _pt(name, ndim):
    return torch.ones((2,) * ndim, dtype=getattr(torch, name))


@pytest.mark.parametrize("nd", [(0, 0), (0, 2), (2, 0), (2, 2)],
                         ids=["0d-0d", "0d-nd", "nd-0d", "nd-nd"])
def test_dtype_rule_agrees_with_jnp_result_type(nd):
    bad = []
    for a in _DTYPES:
        for b in _DTYPES:
            want = str(jnp.result_type(_jt(a, nd[0]), _jt(b, nd[1])))
            got = str(pdtypes.result_type(_pt(a, nd[0]), _pt(b, nd[1])))
            if got.replace("torch.", "") != want:
                bad.append((a, b, got, want))
    assert bad == []


def test_dtype_rule_takes_python_scalars_as_weak():
    scalars = [True, 3, 2.5]
    wide = ("int64", "float64")
    with jax.enable_x64(False):          # the port's default int and float
        for a in _DTYPES:
            for s in scalars:
                if a in wide:            # JAX has them only in 64-bit mode
                    continue
                want = str(jnp.result_type(_jt(a, 2), s))
                got = str(pdtypes.result_type(_pt(a, 2), s))
                assert got.replace("torch.", "") == want, (a, s)
    # a weak scalar of their kind or lower never widens the 64-bit types;
    # int64 with a float gives the port's default float (JAX has int64 only
    # in 64-bit mode, whose default float is float64)
    for a, s, want in [("int64", True, "int64"), ("int64", 3, "int64"),
                       ("int64", 2.5, "float32"), ("float64", True,
                                                   "float64"),
                       ("float64", 3, "float64"), ("float64", 2.5,
                                                   "float64")]:
        got = str(pdtypes.result_type(_pt(a, 2), s))
        assert got.replace("torch.", "") == want, (a, s)
        if want == a:
            assert str(jnp.result_type(_jt(a, 2), s)) == want


def test_zero_d_float32_times_bf16_is_float32_as_in_jax():
    """torch alone gives bfloat16 here, and raises on the matmul."""
    x = _rng(25).normal(size=(3, 4)).astype(np.float32)
    w = _rng(26).normal(size=(4, 5)).astype(np.float32)
    xb = torch.as_tensor(x).bfloat16()
    s = torch.tensor(0.125)
    assert (s * xb).dtype == torch.bfloat16            # torch's rule
    got = preg.exec_op("multiply", s, xb)
    want = jreg.get_op("multiply")(jnp.asarray(0.125, jnp.float32),
                                   jnp.asarray(x, jnp.bfloat16))
    _same(got, want)
    with pytest.raises(RuntimeError):
        torch.matmul(torch.as_tensor(x), torch.as_tensor(w).bfloat16())
    got = preg.exec_op("matmul", torch.as_tensor(x),
                       torch.as_tensor(w).bfloat16())
    want = jreg.get_op("matmul")(jnp.asarray(x),
                                 jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.float32
    _same(got, want)
    for name in ("add", "subtract", "divide", "squaredsubtract", "greater",
                 "bias_add", "concat"):
        args = (s, xb) if name != "concat" else (xb, torch.as_tensor(x))
        jargs = (jnp.asarray(0.125, jnp.float32),
                 jnp.asarray(x, jnp.bfloat16)) if name != "concat" else (
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(x))
        if name == "bias_add":
            args, jargs = args[::-1], jargs[::-1]
        got = preg.exec_op(name, *args)
        want = jreg.get_op(name)(*jargs)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
