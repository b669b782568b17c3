"""The rest of ``ComputationGraph``'s surface against the JAX package.

Two small graphs, built by the same DSL calls in both packages from the
same seed (the JAX one ``cnn_data_format="NCHW"``, the port's logical
NCHW body), so that their weights are equal by construction and checked:

- ff: two inputs, dense layers, every vertex (``ElementWiseVertex`` with
  each op, ``MergeVertex``, ``SubsetVertex``, ``ScaleVertex``,
  ``ShiftVertex``, ``L2NormalizeVertex``, ``DotProductVertex`` with and
  without normalisation) into a softmax head;
- cnn: convolutions, the element-wise op, a batch norm and its ReLU
  (fused in the port), ``MergeVertex``, ``SubsetVertex``, ``ScaleVertex``,
  ``ShiftVertex`` and ``L2NormalizeVertex`` over channels, global
  pooling, a softmax head.

In float64: ``output`` and ``feed_forward`` (inference and training
forward), every gradient (one ``Sgd(1.0)`` step: each parameter's change
is minus its gradient), ``output(training=True)`` leaving the running
statistics as they are, and ``summary`` character for character. The ff
graph agrees to 1e-10 of each tensor's magnitude. The cnn graph's batch
norm casts gamma and beta to float32 in the JAX package, so the cnn
graph agrees to float32's rounding: 1e-6. Then
``MixedPrecision(loss_scale, softmax_dtype)`` against the JAX bf16 step.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jax_nn
import deeplearning4j_tpu_torch.nn as port_nn
from deeplearning4j_tpu.autodiff.training import \
    MixedPrecision as JaxMixedPrecision
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JaxIterator
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch.autodiff import MixedPrecision
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import Sgd

OPS = ["Add", "Subtract", "Product", "Average", "Max"]
B = 6


def _np(v):
    v = v.to_numpy() if hasattr(v, "to_numpy") else v
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _ff_conf(nn, sgd, op, lr=1.0):
    g = (nn.NeuralNetConfiguration.builder().seed(3)
         .updater(sgd(learning_rate=lr)).graph_builder()
         .add_inputs("inA", "inB")
         .set_input_types(nn.InputType.feed_forward(5),
                          nn.InputType.feed_forward(4))
         .add_layer("dA", nn.DenseLayer(n_out=6, activation="relu"), "inA")
         .add_layer("dB", nn.DenseLayer(n_out=6, activation="identity"),
                    "inB")
         .add_layer("dA2", nn.DenseLayer(n_out=6, activation="identity"),
                    "inA")
         .add_vertex("ew", nn.ElementWiseVertex(op=op), "dA", "dB", "dA2")
         .add_vertex("merge", nn.MergeVertex(), "ew", "dA")
         .add_vertex("sub", nn.SubsetVertex(from_idx=2, to_idx=9), "merge")
         .add_vertex("scale", nn.ScaleVertex(scale_factor=0.5), "sub")
         .add_vertex("shift", nn.ShiftVertex(shift_factor=0.25), "scale")
         .add_vertex("l2", nn.L2NormalizeVertex(), "shift")
         .add_layer("dC", nn.DenseLayer(n_out=8, activation="relu"), "l2")
         .add_vertex("dot", nn.DotProductVertex(normalize=True), "dC",
                     "shift")
         .add_vertex("dot2", nn.DotProductVertex(), "dC", "l2")
         .add_vertex("m2", nn.MergeVertex(), "l2", "dot", "dot2")
         .add_layer("out", nn.OutputLayer(n_out=3, loss_function="MCXENT"),
                    "m2")
         .set_outputs("out"))
    conf = g.build()
    conf.dtype = "float64"
    return conf


def _cnn_conf(nn, sgd, op, lr=1.0):
    g = (nn.NeuralNetConfiguration.builder().seed(4)
         .updater(sgd(learning_rate=lr)).graph_builder()
         .add_inputs("input")
         .set_input_types(nn.InputType.convolutional(6, 6, 3))
         .add_layer("c1", nn.ConvolutionLayer(
             n_out=4, kernel_size=(3, 3), convolution_mode="SAME"), "input")
         .add_layer("c2", nn.ConvolutionLayer(
             n_out=4, kernel_size=(1, 1), convolution_mode="VALID"),
             "input")
         .add_vertex("ew", nn.ElementWiseVertex(op=op), "c1", "c2")
         .add_layer("bn", nn.BatchNormalization(), "ew")
         .add_layer("act", nn.ActivationLayer(activation="relu"), "bn")
         .add_vertex("merge", nn.MergeVertex(), "act", "c2")
         .add_vertex("sub", nn.SubsetVertex(from_idx=1, to_idx=6), "merge")
         .add_vertex("scale", nn.ScaleVertex(scale_factor=1.5), "sub")
         .add_vertex("shift", nn.ShiftVertex(shift_factor=-0.1), "scale")
         .add_vertex("l2", nn.L2NormalizeVertex(), "shift")
         .add_layer("gap", nn.GlobalPoolingLayer(pooling_type="AVG"), "l2")
         .add_layer("out", nn.OutputLayer(n_out=3, loss_function="MCXENT"),
                    "gap")
         .set_outputs("out"))
    conf = g.build()
    conf.dtype = "float64"
    return conf


GRAPHS = {"ff": (_ff_conf, 1e-10), "cnn": (_cnn_conf, 1e-6)}


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ff":
        xs = [rng.normal(size=(B, 5)), rng.normal(size=(B, 4))]
    else:
        xs = [rng.normal(size=(B, 3, 6, 6))]
    return xs, np.eye(3)[rng.integers(0, 3, B)]


def _pair(kind, op, mp=None, dtype="float64"):
    make = GRAPHS[kind][0]
    jconf = make(jax_nn, JSgd, op)
    jconf.cnn_data_format, jconf.dtype = "NCHW", dtype
    jconf.mixed_precision = None if mp is None else JaxMixedPrecision(**mp)
    pconf = make(port_nn, Sgd, op)
    pconf.dtype = dtype
    pconf.mixed_precision = None if mp is None else MixedPrecision(**mp)
    jnet = jax_nn.ComputationGraph(jconf).init()
    pnet = port_nn.ComputationGraph(pconf).init(device="cpu")
    return jnet, pnet


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["ff", "cnn"])
def test_forward_and_every_gradient_match_jax_f64(kind, op):
    """Same weights from the same seed; the outputs and every
    intermediate value of the inference forward; then one Sgd(1.0) step
    on the same batch: every parameter's change (minus its gradient) and
    the loss."""
    tol = GRAPHS[kind][1]
    jnet, pnet = _pair(kind, op)
    w = jnet.params()
    got = pnet.params()
    assert set(got) == set(w)
    for k, v in w.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    xs, y = _inputs(kind)
    for o_p, o_j in zip(pnet.output(*xs), jnet.output(*xs)):
        _close(o_p, o_j, tol, "output")
    ff_p, ff_j = pnet.feed_forward(*xs), jnet.feed_forward(*xs)
    assert set(ff_p) == set(ff_j)
    for n, v in ff_j.items():
        _close(ff_p[n], v, tol, n)
    it = (JaxIterator, DeviceCachedIterator)
    feats = xs if len(xs) > 1 else xs[0]
    jl = jnet.fit(it[0](feats, y, batch_size=B)).final_loss()
    pl = pnet.fit(it[1](feats, y, batch_size=B, device="cpu")).final_loss()
    assert pl == pytest.approx(jl, rel=1e-6)      # summed in float32
    after_j, after_p = jnet.params(), pnet.params()
    trained = [k for k in w if not k.endswith(("_mean", "_var"))]
    moved = 0
    for k in trained:
        dj, dp = after_j[k] - w[k], after_p[k] - w[k]
        if np.max(np.abs(dj)) < 1e-8:
            # c1_b into the batch norm through a sum: its true gradient
            # is 0, and each side holds rounding noise
            assert kind == "cnn" and k == "c1_b" and \
                op in ("Add", "Subtract", "Average"), k
            assert np.max(np.abs(dp - dj)) < 1e-9, k
            continue
        _close(dp, dj, 10 * tol, f"gradient of {k}")
        moved += bool(np.any(dj != 0))
    assert moved >= len(trained) - 3


@pytest.mark.parametrize("kind", ["ff", "cnn"])
def test_training_forward_matches_jax_and_keeps_the_running_stats(kind):
    """``output(training=True)`` and ``feed_forward(training=True)``:
    the batch statistics normalise, as in the JAX training graph, and the
    running statistics stay as they were."""
    tol = GRAPHS[kind][1]
    jnet, pnet = _pair(kind, "Add")
    xs, _ = _inputs(kind, seed=5)
    before = pnet.params()
    for o_p, o_j in zip(pnet.output(*xs, training=True),
                        jnet.output(*xs, training=True)):
        _close(o_p, o_j, tol, "output(training=True)")
    ff_p = pnet.feed_forward(*xs, training=True)
    for n, v in jnet.feed_forward(*xs, training=True).items():
        _close(ff_p[n], v, tol, n)
    after = pnet.params()
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    if kind == "cnn":
        # the batch statistics differ from the running ones at init, so
        # the two forwards must differ
        assert not np.allclose(_np(pnet.output(*xs)[0]),
                               _np(pnet.output(*xs, training=True)[0]))


@pytest.mark.parametrize("kind", ["ff", "cnn"])
def test_summary_equals_jax(kind):
    jnet, pnet = _pair(kind, "Max")
    assert pnet.summary() == jnet.summary()
    assert pnet.num_params() == jnet.num_params()


def test_dot_product_vertex_refuses_cnn_input_as_jax_does():
    cnn = port_nn.InputType.convolutional(4, 4, 2)
    conf = (port_nn.NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("a", "b").set_input_types(cnn, cnn)
            .add_vertex("dot", port_nn.DotProductVertex(), "a", "b")
            .set_outputs("dot").build())
    with pytest.raises(ValueError, match="ff/rnn"):
        port_nn.ComputationGraph(conf).init(device="cpu")


MP_POLICIES = {"plain": {}, "tail": {"softmax_dtype": "bfloat16"},
               "pow2": {"loss_scale": 1024.0}, "scale": {"loss_scale": 1000.0},
               "both": {"loss_scale": 1000.0, "softmax_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def bf16_steps():
    """One bf16 step of the ff graph (float32 masters, Sgd(1.0)) in both
    packages under each policy, from the same weights on the same batch:
    (package, policy) -> (loss, every parameter's change)."""
    xs, y = _inputs("ff", seed=9)
    xs = [x.astype(np.float32) for x in xs]
    y = y.astype(np.float32)
    out = {}
    for tag, mp in MP_POLICIES.items():
        jnet, pnet = _pair("ff", "Add", mp=mp, dtype="float32")
        for pkg, net, it in (("jax", jnet, JaxIterator(xs, y, batch_size=B)),
                             ("port", pnet, DeviceCachedIterator(
                                 xs, y, batch_size=B, device="cpu"))):
            w = net.params()
            loss = net.fit(it).final_loss()
            out[pkg, tag] = (loss, {k: net.params()[k] - w[k] for k in w})
    return out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_loss_scale_and_softmax_dtype_act_as_in_jax(bf16_steps, pkg):
    """In each package: a power-of-two ``loss_scale`` divides back out
    exactly (the same bits as no scale); 1000 rounds the bf16 backward
    otherwise (other bits); ``softmax_dtype="bfloat16"`` moves the loss
    by a bf16 rounding of the log-probabilities, not more."""
    plain, pow2 = bf16_steps[pkg, "plain"], bf16_steps[pkg, "pow2"]
    assert pow2[0] == plain[0]
    assert all(np.array_equal(pow2[1][k], v) for k, v in plain[1].items())
    scale = bf16_steps[pkg, "scale"]
    assert any(not np.array_equal(scale[1][k], v)
               for k, v in plain[1].items())
    tail = bf16_steps[pkg, "tail"][0]
    assert 0 < abs(tail - plain[0]) / plain[0] <= 1e-2


@pytest.mark.parametrize("tag", list(MP_POLICIES))
def test_mixed_precision_step_matches_the_jax_bf16_step(bf16_steps, tag):
    """The port's bf16 step against the JAX package's under the same
    policy: the loss to 1e-2 (one bf16 rounding of each log-probability,
    as ``test_torch_ops`` holds the bf16 tail; readings on this seed 0 to
    1.8e-4), each parameter's change to 2e-2 of its magnitude (bf16
    forwards and backwards of both packages; readings 7.7e-3 to
    1.5e-2)."""
    (lp, dp), (lj, dj) = bf16_steps["port", tag], bf16_steps["jax", tag]
    assert abs(lp - lj) / abs(lj) <= 1e-2, (lp, lj)
    for k, v in dj.items():
        err = float(np.max(np.abs(dp[k] - v))) / max(
            float(np.max(np.abs(v))), 1e-30)
        assert err <= 2e-2, (k, err)
