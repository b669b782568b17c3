"""The port's MultiLayerNetwork and LeNet against the JAX package's, on
the CPU.

The same seeded numpy inputs go to both packages; each network starts
from its own seed's draws, which are the same arrays on both sides
(checked), and the JAX network's weights are also handed to the port by
name through ``convert.samediff_arrays_from_jax``. float32, tolerance
1e-5 of each tensor's largest magnitude (``tests/test_torch_samediff.py``'s):
``output``, every gradient, and 3 Adam steps (each step's loss; every
parameter after them to 2e-2 of the learning rate, the rule and reason
of ``test_torch_samediff.py``'s Adam test, with a stated exception for
elements whose gradients cancelled, see the test), for LeNet at full
width (batch 8) and a dense-only network. Also: the conv and pooling ops by
name against the JAX ops, ``params()`` names and shapes, the MNIST
arrays, a control (a CHW flatten before the dense layer misses the JAX
output by far more than the tolerance) and what is refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.dataset import mnist as jmnist
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.dataset import (DeviceCachedIterator,
                                              load_mnist, synthetic_mnist)
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (CenterLossOutputLayer, DenseLayer,
                                         GlobalPoolingLayer, InputType,
                                         MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn import ConvLSTM2DLayer
from deeplearning4j_tpu_torch.nn.layers import BaseLayer
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.zoo import LeNet

BATCH = 8
TOL = 1e-5


def _dense_conf(pkg):
    nnc, dense, out, itype, adam = {
        "port": (NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
                 Adam),
        "jax": (JNNC, JDense, JOutput, JInputType, JAdam)}[pkg]
    return (nnc.builder().seed(11).updater(adam(learning_rate=1e-3)).list()
            .layer(dense(n_out=64, activation="relu"))
            .layer(dense(n_out=32, activation="relu"))
            .layer(out(n_out=10, loss_function="MCXENT"))
            .set_input_type(itype.feed_forward(784)).build())


MODELS = {
    "lenet": (lambda: JLeNet().build(),
              lambda: LeNet().build(device="cpu"), (1, 28, 28)),
    "dense": (lambda: JMLN(_dense_conf("jax")).init(),
              lambda: MultiLayerNetwork(_dense_conf("port")).init(
                  device="cpu"), (784,)),
}


def _data(model, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + MODELS[model][2]).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _pair(model):
    jnet, pnet = MODELS[model][0](), MODELS[model][1]()
    samediff_arrays_from_jax(jnet.params(), pnet.samediff)
    return jnet, pnet


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


# ----------------------------------------------------------------------
# the ops by name
CONV_CASES = [
    ("NHWC", "SAME", (1, 1), (1, 1), (2, 9, 9, 3), (5, 5, 3, 4)),
    ("NHWC", "SAME", (2, 2), (1, 1), (2, 10, 7, 3), (3, 3, 3, 4)),
    ("NHWC", "VALID", (1, 2), (2, 1), (1, 9, 11, 2), (3, 2, 2, 5)),
    ("NCHW", "SAME", (2, 1), (1, 1), (2, 3, 9, 8), (4, 4, 3, 2)),
    ("NCHW", "VALID", (1, 1), (1, 2), (1, 2, 8, 9), (2, 3, 2, 3)),
]


@pytest.mark.parametrize("fmt,pad,strides,dil,xs,ws", CONV_CASES)
def test_conv2d_op_matches_jax(fmt, pad, strides, dil, xs, ws):
    rng = np.random.default_rng(1)
    x, w = rng.normal(size=xs).astype(np.float32), \
        rng.normal(size=ws).astype(np.float32)
    b = rng.normal(size=ws[-1]).astype(np.float32)
    attrs = dict(strides=strides, padding=pad, dilation=dil,
                 data_format=fmt)
    want = jreg.get_op("conv2d")(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), **attrs)
    got = preg.exec_op("conv2d", x, w, b, **attrs)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("name", ["max_pool2d", "maxpool2d", "avg_pool2d",
                                  "avgpool2d"])
@pytest.mark.parametrize("fmt,pad,kernel,strides,xs", [
    ("NHWC", "VALID", (2, 2), (2, 2), (2, 8, 8, 3)),
    ("NHWC", "SAME", (3, 3), (2, 2), (2, 7, 9, 2)),
    ("NCHW", "SAME", (2, 3), (1, 2), (1, 3, 7, 8)),
    ("NCHW", "VALID", (3, 2), None, (1, 2, 9, 8)),
])
def test_pool_ops_match_jax(name, fmt, pad, kernel, strides, xs):
    x = np.random.default_rng(2).normal(size=xs).astype(np.float32)
    attrs = dict(kernel=kernel, strides=strides, padding=pad,
                 data_format=fmt)
    want = jreg.get_op(name)(jnp.asarray(x), **attrs)
    got = preg.exec_op(name, x, **attrs)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    assert preg.get_op(name).category == jreg.get_op(name).category


# ----------------------------------------------------------------------
# the network
@pytest.mark.parametrize("model", sorted(MODELS))
def test_params_are_the_jax_networks(model):
    """Names, shapes and the seed's initial values (no hand-over)."""
    jnet, pnet = MODELS[model][0](), MODELS[model][1]()
    jp, pp = jnet.params(), pnet.params()
    assert list(pp) == list(jp)
    for n in jp:
        assert pp[n].shape == np.asarray(jp[n]).shape, n
        assert pp[n].dtype == np.float32
        assert _rel(pp[n], jp[n]) <= 1e-7, n
    assert pnet.num_params() == jnet.num_params()
    assert pnet.summary() == jnet.summary()


def test_graph_records_the_jax_op_sequence():
    jnet, pnet = MODELS["lenet"][0](), MODELS["lenet"][1]()
    jops = [(n.name, n.op) for n in jnet.samediff.ops()]
    pops = [(n.name, n.op) for n in pnet.samediff.ops()]
    assert pops == jops
    assert pops[0] == ("input_nhwc", "permute")
    assert ("layer4_cnn2ff", "reshape") in pops


@pytest.mark.parametrize("model", sorted(MODELS))
def test_output_matches_jax(model):
    jnet, pnet = _pair(model)
    x, _ = _data(model, BATCH, 1)
    want = np.asarray(jnet.output(x).to_numpy())
    got = pnet.output(x)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL
    assert np.array_equal(pnet.predict(x), want.argmax(-1))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_gradient_matches_jax(model):
    jnet, pnet = _pair(model)
    x, y = _data(model, BATCH, 2)
    feed = {"input": x, "labels": y}
    want = jnet.samediff.calculate_gradients(feed)
    got = pnet.samediff.calculate_gradients(feed)
    assert set(got) == set(want) == set(pnet.params())
    for n in want:
        assert _rel(got[n].numpy(), np.asarray(want[n].to_numpy())) <= TOL, n


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_adam_steps_match_jax(model):
    """Each step's loss to 1e-5; every parameter element to 2e-2 of the
    learning rate (``test_torch_samediff.py``'s rule), except an element
    whose gradient was a cancelled sum in every step (under 1e-6 of its
    tensor's largest): Adam divides such a gradient by about ``eps``, so
    its step carries the two sides' rounding of the sum at up to full
    size. Those are held to one learning rate a step and to 1e-5 of the
    tensor's elements (measured: one of LeNet's 1,225,000 dense weights,
    gradients 6.3e-8 then 0, at 2.96e-2 of the rate)."""
    jnet, pnet = _pair(model)
    jl, pl, grads = [], [], []
    for s in range(3):
        x, y = _data(model, BATCH, 10 + s)
        grads.append({n: g.abs().numpy() for n, g in
                      pnet.samediff.calculate_gradients(
                          {"input": x, "labels": y}).items()})
        jl.append(jnet.fit(x, y, batch_size=BATCH).final_loss())
        pl.append(pnet.fit(DeviceCachedIterator(
            x, y, BATCH, device="cpu")).final_loss())
    for j, p in zip(jl, pl):
        assert abs(p - j) <= TOL * abs(j), (jl, pl)
    got, lr = pnet.params(), 1e-3
    for n, a in jnet.params().items():
        d = np.abs(got[n] - np.asarray(a))
        cancelled = np.all([g[n] < 1e-6 * g[n].max() for g in grads], axis=0)
        assert float(np.max(d[~cancelled], initial=0.0)) <= 2e-2 * lr, n
        assert float(np.max(d, initial=0.0)) <= 3 * lr, n
        assert int(np.sum(d[cancelled] > 2e-2 * lr)) <= 1e-5 * d.size, n
    assert pnet.samediff.training_config.iteration_count == 3
    assert pnet.score() == pl[-1]


def test_a_chw_flatten_misses_the_jax_output():
    """Control: the same weights with the body in NCHW (no input permute,
    so the flatten before the dense layer is in C, H, W order) miss the
    JAX output by far more than the tolerance."""
    jnet = JLeNet().build()
    conf = LeNet().conf()
    conf.cnn_data_format = "NCHW"
    pnet = MultiLayerNetwork(conf).init(device="cpu")
    samediff_arrays_from_jax(jnet.params(), pnet.samediff)
    assert "input_nhwc" not in [n.name for n in pnet.samediff.ops()]
    x, _ = _data("lenet", BATCH, 1)
    want = np.asarray(jnet.output(x).to_numpy())
    assert _rel(pnet.output(x).numpy(), want) > 1000 * TOL


def test_fit_on_arrays_and_float64():
    """``fit(X, labels=Y)`` batches arrays on the host (the per-step
    tier); a float64 configuration trains in float64."""
    conf = _dense_conf("port")
    conf.dtype = "float64"
    net = MultiLayerNetwork(conf).init(device="cpu")
    x, y = _data("dense", 20, 4)
    hist = net.fit(x, labels=y, batch_size=8, epochs=2)
    st = net.samediff.last_fit_stats
    assert st["tier"] == "per_step" and st["steps_per_epoch"] == 3
    assert len(hist.step_losses) == 6 and np.isfinite(hist.final_loss())
    assert all(a.dtype == np.float64 for a in net.params().values())
    assert net.output(x[:2]).dtype == torch.float64


def test_mnist_arrays_are_the_jax_packages(monkeypatch, tmp_path):
    for n, seed in ((64, 0), (33, 5)):
        for a, b in zip(synthetic_mnist(n, seed),
                        jmnist.synthetic_mnist(n, seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.delenv("MNIST_DIR", raising=False)
    for train in (True, False):
        for a, b in zip(load_mnist(train, n_synthetic=40),
                        jmnist.load_mnist(train, data_dir=str(tmp_path),
                                          n_synthetic=40)):
            assert np.array_equal(a, b)
    # idx files in a named directory are read (the reference's names)
    imgs = np.arange(2 * 28 * 28, dtype=np.uint8).reshape(2, 28, 28)
    (tmp_path / "t10k-images-idx3-ubyte").write_bytes(
        bytes([0, 0, 8, 3]) + np.array([2, 28, 28], ">u4").tobytes()
        + imgs.tobytes())
    (tmp_path / "t10k-labels-idx1-ubyte").write_bytes(
        bytes([0, 0, 8, 1]) + np.array([2], ">u4").tobytes()
        + bytes([3, 7]))
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    for a, b in zip(load_mnist(False), jmnist.load_mnist(False)):
        assert np.array_equal(a, b)
    assert load_mnist(False)[1].tolist() == [3, 7]


def test_what_is_not_ported_is_refused_by_name():
    net = MultiLayerNetwork(_dense_conf("port")).init(device="cpu")
    x, y = _data("dense", 8, 0)
    bad_json = net.conf.to_json().replace('"DenseLayer"',
                                          '"EmbeddingLayer"', 1)
    for call, item in ((lambda: net.capture_training_state(
                           normalizer=object()), "7"),
                       (lambda: MultiLayerConfiguration.from_json(bad_json),
                        "10"),
                       (lambda: BaseLayer.from_json(
                           {"@class": "VariationalAutoencoderLayer"}), "10"),
                       (lambda: ConvLSTM2DLayer(), "10"),
                       (lambda: CenterLossOutputLayer(n_out=4).build_sd(
                           None, None, None), "10")):
        with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
            call()
    for layers in ([SubsamplingLayer(pooling_type="PNORM")],
                   [GlobalPoolingLayer(pooling_type="PNORM")],
                   [ZeroPaddingLayer(), CenterLossOutputLayer(n_out=2)]):
        conf = (NeuralNetConfiguration.builder().list())
        for layer in layers + [OutputLayer(n_out=2)]:
            conf.layer(layer)
        conf = conf.set_input_type(InputType.convolutional(4, 4, 1)).build()
        with pytest.raises(NotImplementedError, match="queue 1 item"):
            MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="set_input_type"):
        NeuralNetConfiguration.builder().list().layer(
            DenseLayer(n_out=2)).build()
