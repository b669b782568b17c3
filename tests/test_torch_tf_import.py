"""The port's TF GraphDef importer (``deeplearning4j_tpu_torch.modelimport``)
against the JAX package's.

Every graph of ``tests/test_tf_import.py`` is written again here twice, by
the JAX package's ``GraphDefBuilder`` and by the port's copy, which must
write the same bytes; both packages import those bytes: the same recorded
graph outputs (float32, 1e-6 of the largest magnitude: the same arithmetic,
sums in another order), the same folded constants (dtypes, and values to
1e-6 relative: a folded float op may round its last bit otherwise), the
same split into trainable parameters and constants. Refusals name the
ROADMAP item that ports what they refuse.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import tf_builder as jbuilder
from deeplearning4j_tpu.modelimport import tf_import as jimport
from deeplearning4j_tpu.modelimport.tf_pb import GraphDef as JGraphDef
from deeplearning4j_tpu_torch.modelimport import (TFImportError,
                                                  import_tf_graph,
                                                  supported_tf_ops)
from deeplearning4j_tpu_torch.modelimport import protowire, tf_builder
from deeplearning4j_tpu_torch.modelimport import tf_import as pimport
from deeplearning4j_tpu_torch.modelimport.tf_pb import GraphDef


def _rng(seed):
    return np.random.RandomState(seed)


# --- the graphs of tests/test_tf_import.py, for either builder --------------
def g_wire_roundtrip(B):
    b = B()
    b.const("c", np.arange(6, dtype=np.float32).reshape(2, 3))
    b.placeholder("x", shape=[-1, 3], dtype=np.float32)
    b.node("Add", "y", "x", "c")
    return b.build(), {"x": _rng(0).randn(2, 3).astype(np.float32)}, ["y"]


def g_mlp_matmul_bias_relu(B):
    rng = _rng(0)
    W = rng.randn(4, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    x = rng.randn(2, 4).astype(np.float32)
    b = B()
    b.placeholder("x", shape=[-1, 4])
    b.const("W", W)
    b.const("b", bias)
    b.node("MatMul", "mm", "x", "W", transpose_a=False, transpose_b=False)
    b.node("BiasAdd", "ba", "mm", "b")
    b.node("Relu", "out", "ba")
    return b.build(), {"x": x}, ["out"]


def g_identity_and_control_deps(B):
    b = B()
    b.placeholder("x", shape=[2, 2])
    b.node("NoOp", "init")
    b.raw_node("y", "Identity", ["x", "^init"])
    b.node("Neg", "out", "y")
    return b.build(), {"x": np.ones((2, 2), np.float32)}, ["out"]


def g_shape_math_folds_to_reshape(B):
    b = B()
    b.placeholder("x", shape=[2, 3, 4])
    b.node("Shape", "sh", "x")
    b.const("b0", np.array([0], np.int32))
    b.const("b1", np.array([1], np.int32))
    b.const("st", np.array([1], np.int32))
    b.raw_node("batch", "StridedSlice", ["sh", "b0", "b1", "st"],
               {"shrink_axis_mask": 1})
    b.const("rest", np.array(12, np.int32))
    b.node("Pack", "newshape", "batch", "rest", axis=0)
    b.node("Reshape", "out", "x", "newshape")
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    return b.build(), {"x": x}, ["out"]


def g_reduce_and_softmax(B):
    b = B()
    b.placeholder("x", shape=[2, 5])
    b.const("axes", np.array([1], np.int32))
    b.node("Mean", "m", "x", "axes", keep_dims=True)
    b.node("Sub", "centered", "x", "m")
    b.node("Softmax", "out", "centered")
    return b.build(), {"x": _rng(1).randn(2, 5).astype(np.float32)}, ["out"]


def g_conv_pool_fused_batchnorm(B):
    rng = _rng(2)
    x = rng.randn(1, 8, 8, 3).astype(np.float32)
    b = B()
    b.placeholder("x", shape=[-1, 8, 8, 3])
    b.const("k", rng.randn(3, 3, 3, 4).astype(np.float32))
    b.const("scale", rng.rand(4).astype(np.float32) + 0.5)
    b.const("offset", rng.randn(4).astype(np.float32))
    b.const("mean", rng.randn(4).astype(np.float32))
    b.const("var", rng.rand(4).astype(np.float32) + 0.5)
    b.node("Conv2D", "conv", "x", "k", strides=[1, 1, 1, 1],
           padding=b"SAME", data_format=b"NHWC", dilations=[1, 1, 1, 1])
    b.node("FusedBatchNormV3", "bn", "conv", "scale", "offset", "mean",
           "var", epsilon=0.001, is_training=False, data_format=b"NHWC")
    b.raw_node("pool", "MaxPool", ["bn"],
               {"ksize": [1, 2, 2, 1], "strides": [1, 2, 2, 1],
                "padding": b"VALID", "data_format": b"NHWC"})
    return b.build(), {"x": x}, ["pool"]


def g_gather_one_hot_embedding(B):
    b = B()
    b.placeholder("ids", shape=[-1, 3], dtype=np.int32)
    b.const("table", _rng(3).randn(10, 6).astype(np.float32))
    b.const("axis", np.array(0, np.int32))
    b.node("GatherV2", "emb", "table", "ids", "axis")
    b.const("depth", np.array(10, np.int32))
    b.const("on", np.array(1.0, np.float32))
    b.const("off", np.array(0.0, np.float32))
    b.node("OneHot", "oh", "ids", "depth", "on", "off")
    ids = np.array([[1, 5, 3], [0, 2, 9]], np.int32)
    return b.build(), {"ids": ids}, ["emb", "oh"]


def g_concat_split_pack_transpose(B):
    b = B()
    b.placeholder("x", shape=[2, 4])
    b.const("axis1", np.array(1, np.int32))
    b.node("ConcatV2", "cc", "x", "x", "axis1")
    b.const("axis0", np.array(0, np.int32))
    b.node("Split", "sp", "axis0", "cc", num_split=2)
    b.node("Pack", "pk", "sp:0", "sp:1", axis=0)
    b.const("perm", np.array([1, 0, 2], np.int32))
    b.node("Transpose", "out", "pk", "perm")
    return b.build(), {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}, \
        ["out"]


def g_trainable_auto(B):
    b = B()
    b.placeholder("x", shape=[-1, 4])
    b.const("W", _rng(5).randn(4, 2).astype(np.float32))
    b.const("axes", np.array([1], np.int32))
    b.node("MatMul", "mm", "x", "W")
    b.node("Sum", "out", "mm", "axes")
    return b.build(), {"x": _rng(6).randn(3, 4).astype(np.float32)}, ["out"]


def g_strided_slice_masks(B):
    b = B()
    b.placeholder("x", shape=[2, 3, 4])
    b.const("begin", np.array([0, 1], np.int32))
    b.const("end", np.array([0, 3], np.int32))
    b.const("strides", np.array([1, 1], np.int32))
    b.raw_node("y", "StridedSlice", ["x", "begin", "end", "strides"],
               {"begin_mask": 1, "end_mask": 1, "shrink_axis_mask": 0})
    return b.build(), \
        {"x": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}, ["y"]


def g_cast_argmax_select(B):
    b = B()
    b.placeholder("x", shape=[2, 3])
    b.const("dim", np.array(1, np.int32))
    b.node("ArgMax", "am", "x", "dim", output_type=3)
    b.node("Cast", "amf", "am", DstT=1)
    b.const("zeros", np.zeros((2, 3), np.float32))
    b.node("Greater", "gt", "x", "zeros")
    b.node("Select", "sel", "gt", "x", "zeros")
    x = np.array([[1., -2., 3.], [-1., 5., 2.]], np.float32)
    return b.build(), {"x": x}, ["amf", "sel", "gt"]


def g_erf_gelu_pattern(B):
    b = B()
    b.placeholder("x", shape=[2, 4])
    b.const("sqrt2", np.array(np.sqrt(2.0), np.float32))
    b.node("RealDiv", "xd", "x", "sqrt2")
    b.node("Erf", "e", "xd")
    b.const("one", np.array(1.0, np.float32))
    b.node("AddV2", "e1", "e", "one")
    b.const("half", np.array(0.5, np.float32))
    b.node("Mul", "xh", "x", "half")
    b.node("Mul", "out", "xh", "e1")
    return b.build(), {"x": _rng(4).randn(2, 4).astype(np.float32)}, ["out"]


def g_dtype_attrs_in_tf_native_encoding(B):
    b = B()
    b.placeholder("x", shape=[2, 3])
    b.node("Cast", "xi", "x", DstT=("dtype", 3))          # -> int32
    b.const("dim", np.array(1, np.int32))
    b.node("ArgMax", "am", "x", "dim", output_type=("dtype", 3))
    x = np.array([[1.5, -2.0, 3.25], [0.5, 5.0, 2.0]], np.float32)
    return b.build(), {"x": x}, ["xi", "am"]


def g_placeholder_with_default(B):
    b = B()
    b.placeholder("x", shape=[2, 2])
    b.const("kp_default", np.array(0.75, np.float32))
    b.raw_node("keep_prob", "PlaceholderWithDefault", ["kp_default"],
               {"dtype": ("dtype", 1), "shape": ("shape", [])})
    b.node("Mul", "out", "x", "keep_prob")
    return b.build(), {"x": np.ones((2, 2), np.float32)}, ["out"]


def g_folded_weight_preprocessing(B):
    """Constant subgraphs fold at import: a scaled, transposed, sliced
    weight (the port runs its own ops on CPU tensors to fold them)."""
    rng = _rng(8)
    b = B()
    b.placeholder("x", shape=[3, 5])
    b.const("w", rng.randn(6, 5).astype(np.float32))
    b.const("two", np.array(2.0, np.float32))
    b.node("Mul", "w2", "w", "two")
    b.const("perm", np.array([1, 0], np.int32))
    b.node("Transpose", "wt", "w2", "perm")
    b.const("b0", np.array([0, 1], np.int32))
    b.const("e0", np.array([5, 5], np.int32))
    b.const("s0", np.array([1, 1], np.int32))
    b.raw_node("ws", "StridedSlice", ["wt", "b0", "e0", "s0"], {})
    b.const("three", np.array(3, np.int32))
    b.const("sq", np.array(1.5, np.float32))
    b.node("SquaredDifference", "sd", "ws", "sq")
    b.node("Rsqrt", "r", "sd")
    b.node("MatMul", "out", "x", "r")
    b.const("axes", np.array([0, 1], np.int32))
    b.node("Mean", "mean_all", "out", "axes")
    b.node("Tanh", "t", "mean_all")
    return b.build(), {"x": rng.randn(3, 5).astype(np.float32)}, \
        ["out", "t"]


GRAPHS = [g_wire_roundtrip, g_mlp_matmul_bias_relu,
          g_identity_and_control_deps, g_shape_math_folds_to_reshape,
          g_reduce_and_softmax, g_conv_pool_fused_batchnorm,
          g_gather_one_hot_embedding, g_concat_split_pack_transpose,
          g_trainable_auto, g_strided_slice_masks, g_cast_argmax_select,
          g_erf_gelu_pattern, g_dtype_attrs_in_tf_native_encoding,
          g_placeholder_with_default, g_folded_weight_preprocessing]
TRAINABLE = [None, "auto"]


def _importers(pb, trainable):
    jimp = jimport.TFImporter(JGraphDef(pb), trainable=trainable)
    jimp.run()
    pimp = pimport.TFImporter(GraphDef(pb), trainable=trainable,
                              device="cpu")
    pimp.run()
    return jimp, pimp


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(getattr(v, "data", v))


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: g.__name__[2:])
def test_builders_write_the_same_bytes(graph):
    jpb = graph(jbuilder.GraphDefBuilder)[0]
    ppb = graph(tf_builder.GraphDefBuilder)[0]
    assert jpb == ppb


@pytest.mark.parametrize("trainable", TRAINABLE)
@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: g.__name__[2:])
def test_graph_imports_like_jax(graph, trainable):
    pb, feeds, outputs = graph(tf_builder.GraphDefBuilder)
    jimp, pimp = _importers(pb, trainable)
    jsd, psd = jimp.sd, pimp.sd
    want = jsd.output(placeholders=feeds, outputs=outputs)
    got = psd.output(feeds, outputs)
    for o in outputs:
        w, g = _np(want[o]), _np(got[o])
        assert g.shape == w.shape and g.dtype == w.dtype, (o, g.dtype,
                                                            w.dtype)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))
    # the same split into trainables and constants, with the same values
    assert list(psd.trainable_params()) == list(jsd.trainable_params())
    assert sorted(psd.constants_map()) == sorted(jsd.constants_map())
    for n, a in {**jsd.trainable_params(), **jsd.constants_map()}.items():
        p, a = _np((psd.trainable_params() | psd.constants_map())[n]), _np(a)
        assert p.dtype == a.dtype, (n, p.dtype, a.dtype)
        # a folded float constant may differ in its last bits (torch's
        # rsqrt against XLA's): 1e-6 relative; the rest exactly
        np.testing.assert_allclose(p, a, rtol=1e-6, atol=0)
    assert pimp.placeholder_names == jimp.placeholder_names
    assert pimp.variable_names == jimp.variable_names
    assert pimp.placeholder_defaults.keys() == jimp.placeholder_defaults.keys()
    # every folded constant: same value, same dtype
    jconst = {k: np.asarray(v.const) for k, v in jimp._tensors.items()
              if v.is_const}
    pconst = {k: v.const for k, v in pimp._tensors.items() if v.is_const}
    assert pconst.keys() == jconst.keys()
    for k, w in jconst.items():
        assert pconst[k].dtype == w.dtype, (k, pconst[k].dtype, w.dtype)
        np.testing.assert_allclose(pconst[k], w, rtol=1e-6, atol=0)
    # the same recorded ops, in the same order
    assert [(n.op, n.inputs) for n in psd.ops()] == \
        [(jsd._ops[n].op, jsd._ops[n].inputs) for n in jsd._op_order]


def test_shape_math_folds_away():
    pb, _, _ = g_shape_math_folds_to_reshape(tf_builder.GraphDefBuilder)
    sd = import_tf_graph(pb, device="cpu")
    assert [n.op for n in sd.ops()] == ["reshape"]
    assert sd.ops()[0].attrs == {"shape": (2, 12)}


def test_trainable_auto_gradients_match_jax():
    pb, feeds, _ = g_trainable_auto(tf_builder.GraphDefBuilder)
    jsd = jimport.import_tf_graph(pb, trainable="auto")
    psd = import_tf_graph(pb, trainable="auto", device="cpu")
    assert list(psd.trainable_params()) == ["W"]
    want = jsd.calculate_gradients(feeds, wrt=["W"], loss="out")["W"]
    got = psd.calculate_gradients(feeds, wrt=["W"], loss="out")["W"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert np.abs(_np(got)).sum() > 0


def test_trainable_predicate():
    pb, feeds, _ = g_mlp_matmul_bias_relu(tf_builder.GraphDefBuilder)
    pick = lambda name, arr: name == "b"  # noqa: E731
    sd = import_tf_graph(pb, trainable=pick, device="cpu")
    jsd = jimport.import_tf_graph(pb, trainable=pick)
    assert list(sd.trainable_params()) == list(jsd.trainable_params()) == \
        ["b"]


def test_wire_roundtrip_and_varints():
    b = tf_builder.GraphDefBuilder()
    b.const("c", np.arange(6, dtype=np.float32).reshape(2, 3))
    b.placeholder("x", shape=[-1, 3], dtype=np.float32)
    b.node("Add", "y", "x", "c")
    g = GraphDef(b.build())
    assert [n.name for n in g.nodes] == ["c", "x", "y"]
    assert g.nodes[2].op == "Add"
    assert g.nodes[2].inputs == ["x", "c"]
    np.testing.assert_array_equal(g.nodes[0].attrs["value"].tensor,
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert g.nodes[1].attr("shape").shape == [-1, 3]
    for v in (0, 1, 127, 128, 300, 2 ** 35, -1, -(2 ** 40)):
        data = tf_builder.field_varint(3, v)
        f = protowire.Fields(data)
        assert f.svarint(3) == v
    with pytest.raises(ValueError, match="truncated"):
        protowire.Fields(tf_builder.field_bytes(1, b"abcdef")[:-2])


@pytest.mark.parametrize("op,attrs,match", [
    ("SomeExoticOp", {}, "unmapped TF op 'SomeExoticOp'.*queue 1 item 5"),
    ("Sqrt", {}, "unmapped TF op 'Sqrt'.*queue 1 item 5"),
    ("StatelessWhile", {}, "unmapped TF op 'StatelessWhile'.*queue 1 item 3"),
    ("If", {}, "unmapped TF op 'If'.*queue 1 item 3"),
])
def test_refusals_name_their_roadmap_item(op, attrs, match):
    b = tf_builder.GraphDefBuilder()
    b.placeholder("x", shape=[2])
    b.node(op, "y", "x", **attrs)
    with pytest.raises(TFImportError, match=match):
        import_tf_graph(b.build(), device="cpu")
    # the JAX importer takes every op the port refuses only by its item
    assert op == "SomeExoticOp" or op in jimport.supported_tf_ops()


def test_refusals_of_partly_ported_mappers():
    b = tf_builder.GraphDefBuilder()
    b.placeholder("x", shape=[4, 3])
    b.placeholder("i", shape=[4, 2], dtype=np.int32)
    b.const("axis", np.array(1, np.int32))
    b.raw_node("g", "GatherV2", ["x", "i", "axis"], {"batch_dims": 1})
    with pytest.raises(TFImportError, match="batch_dims.*queue 1 item 5"):
        import_tf_graph(b.build(), device="cpu")
    b = tf_builder.GraphDefBuilder()
    b.placeholder("v", shape=[], dtype=np.float32)
    b.const("dims", np.array([2, 2], np.int32))
    b.node("Fill", "f", "dims", "v")
    with pytest.raises(TFImportError, match="Fill.*queue 1 item 5"):
        import_tf_graph(b.build(), device="cpu")
    # a FunctionDef library (TF2 While/If bodies) is refused by name
    body = tf_builder.GraphDefBuilder()
    body.node("Identity", "o", "a")
    b = tf_builder.GraphDefBuilder()
    b.add_function(tf_builder.function_def("f", [("a", np.float32)],
                                           [("o", "o:output:0", np.float32)],
                                           body))
    b.placeholder("x", shape=[2])
    with pytest.raises(TFImportError, match="FunctionDef.*queue 1 item 3"):
        import_tf_graph(b.build(), device="cpu")


def test_data_dependent_structural_arg_reports_cleanly():
    b = tf_builder.GraphDefBuilder()
    b.placeholder("x", shape=[4])
    b.placeholder("shape", shape=[2], dtype=np.int32)
    b.node("Reshape", "y", "x", "shape")
    with pytest.raises(TFImportError, match="must be trace-time constant"):
        import_tf_graph(b.build(), device="cpu")


def test_unknown_placeholder_shape_names_input_shapes():
    b = tf_builder.GraphDefBuilder()
    b.placeholder("x", shape=[-1, 4])
    b.node("Shape", "sh", "x")
    b.node("Reshape", "y", "x", "sh")
    with pytest.raises(TFImportError, match="input_shapes="):
        import_tf_graph(b.build(), device="cpu")
    sd = import_tf_graph(b.build(), input_shapes={"x": (3, 4)},
                         device="cpu")
    assert sd.ops()[0].attrs == {"shape": (3, 4)}


def test_supported_ops_are_the_jax_importers():
    ours, theirs = supported_tf_ops(), jimport.supported_tf_ops()
    assert set(ours) <= set(theirs)
    assert len(ours) >= 60
    # BERT's graph and every graph above import
    for op in ("GatherV2", "OneHot", "StridedSlice", "BatchMatMulV2",
               "SquaredDifference", "Rsqrt", "Erf", "Cast", "Mean",
               "Conv2D", "FusedBatchNormV3", "MaxPool", "ArgMax", "Select"):
        assert op in ours


def test_keras_import_is_refused_by_name():
    from deeplearning4j_tpu_torch import modelimport
    for name in ("KerasModelImport", "import_keras_model_and_weights",
                 "import_keras_sequential_model_and_weights"):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            getattr(modelimport, name)
    with pytest.raises(AttributeError):
        modelimport.no_such_thing


def test_import_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    pb, _, _ = g_wire_roundtrip(tf_builder.GraphDefBuilder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_tf_graph(pb)


def test_jax_is_in_64_bit_mode_for_these_tests():
    # the folded constants are compared dtype for dtype: the graphs above
    # fold only int32 and float32 arithmetic, which x64 does not widen
    assert jax.config.jax_enable_x64
