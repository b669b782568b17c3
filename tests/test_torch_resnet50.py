"""The port's ResNet-50 training slice against the JAX package.

Both packages build the zoo ResNet-50 at full width (32x32 input, 4
classes), start from the same weights and train two ``fit`` steps of
Nesterovs(0.1, 0.9) on the same seeded batches of 8.

The JAX networks here run ``cnn_data_format="NCHW"``. With its default
NHWC body, the JAX package's ``BatchNormalization`` passes ``axis=-1`` to
``batchnorm_train``, whose ``red = tuple(i for i in range(x.ndim) if i !=
axis)`` then reduces over every axis, channels included: batch statistics
per tensor instead of per channel. With NCHW the axis is 1 and the
statistics are per channel, which is what the layer documents, what the
BN+ReLU backward kernels compute and what the port implements.

Tolerances:

- float64 holds the algorithm: every parameter and running statistic
  agrees to 1e-4 of its magnitude (the JAX float64 step still rounds the
  loss and the ``gamma``/``beta`` casts to float32).
- float32 cannot hold a parameter after a step to a useful tolerance at
  this size, in either package: this network at init grows a rounding
  difference through its depth, in the forward and more in a step's
  parameter changes. The JAX float32 run itself ends more than its
  parameters' magnitude away from the JAX float64 run on these batches
  (the test's ``jax_err``). So the float32 test holds the first
  step's loss to 1e-3 relative, the second's to 5e-2 (it is computed
  with the first step's diverging parameters), the outputs to 1e-5, and
  the port's float32 parameters and statistics to at most twice the JAX
  float32 run's own distance from the float64 result.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jax_nn
import deeplearning4j_tpu_torch.nn as port_nn
from deeplearning4j_tpu.autodiff.training import \
    MixedPrecision as JaxMixedPrecision
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JaxIterator
from deeplearning4j_tpu.learning.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.nn import ComputationGraph as JaxGraph
from deeplearning4j_tpu.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.autodiff import MixedPrecision
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.kernels import bn_relu
from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.zoo import ResNet50

B, STEPS = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch here: the suite runs six test files at
    once, and timing-sensitive tests elsewhere must not starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(STEPS * B, 3, 32, 32)).astype(dtype)
    y = np.eye(4, dtype=dtype)[rng.integers(0, 4, STEPS * B)]
    return x, y


def _jax_net(dtype):
    conf = JaxResNet50(height=32, width=32, num_classes=4).conf()
    conf.cnn_data_format = "NCHW"
    conf.dtype = dtype
    return JaxGraph(conf).init()


def _port_net(dtype):
    conf = ResNet50(height=32, width=32, num_classes=4).conf()
    conf.dtype = dtype
    return ComputationGraph(conf).init(device="cpu")


def _run(dtype):
    """Same weights into both packages; output() before training, then
    STEPS one-batch fits. Returns the records of both."""
    x, y = _data(dtype)
    jnet, pnet = _jax_net(dtype), _port_net(dtype)
    rec = {"init_jax": jnet.params(), "init_port": pnet.params()}
    pnet.model.load_state_dict(params_from_jax(rec["init_jax"]))
    rec["out_jax"] = np.asarray(jnet.output(x[:B])[0].to_numpy())
    rec["out_port"] = pnet.output(x[:B])[0].numpy()
    rec["loss_jax"], rec["loss_port"] = [], []
    for s in range(STEPS):
        xs, ys = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        rec["loss_jax"].append(jnet.fit(JaxIterator(xs, ys, batch_size=B))
                               .final_loss())
        rec["loss_port"].append(pnet.fit(DeviceCachedIterator(
            xs, ys, batch_size=B, device="cpu")).final_loss())
    rec["jax"], rec["port"] = jnet.params(), pnet.params()
    return rec


@pytest.fixture(scope="module")
def runs():
    return {dt: _run(dt) for dt in ("float32", "float64")}


def _rel(a, b):
    """max |a - b| over max |b|, per tensor."""
    return {k: float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
            / max(float(np.max(np.abs(b[k]))), 1e-30) for k in b}


def test_init_weights_equal_jax_from_same_seed(runs):
    r = runs["float32"]
    assert set(r["init_port"]) == set(r["init_jax"])
    for k, v in r["init_jax"].items():
        assert r["init_port"][k].dtype == np.float32, k
        np.testing.assert_array_equal(r["init_port"][k], v, err_msg=k)


def test_output_matches_jax_f32(runs):
    r = runs["float32"]
    assert r["out_port"].shape == (B, 4)
    np.testing.assert_allclose(r["out_port"], r["out_jax"], rtol=0,
                               atol=1e-5)


def test_fit_matches_jax_f64_every_param_and_stat(runs):
    r = runs["float64"]
    np.testing.assert_allclose(r["loss_port"], r["loss_jax"], rtol=1e-6)
    assert set(r["port"]) == set(r["jax"])
    rel = _rel(r["port"], r["jax"])
    # conv biases feed a batch norm, so their true gradient is 0 and what
    # both packages hold there is rounding noise: held absolutely
    for k, e in rel.items():
        if k.endswith("_b") and k != "output_b":
            assert np.max(np.abs(r["port"][k] - r["jax"][k])) < 1e-9, k
        else:
            assert e < 1e-4, (k, e)
    for k in r["jax"]:
        if k.endswith(("_mean", "_var")):
            assert not np.allclose(r["jax"][k], r["init_jax"][k]), k


def test_fit_matches_jax_f32(runs):
    r32, r64 = runs["float32"], runs["float64"]
    np.testing.assert_allclose(r32["loss_port"][0], r32["loss_jax"][0],
                               rtol=1e-3)
    np.testing.assert_allclose(r32["loss_port"][1], r32["loss_jax"][1],
                               rtol=5e-2)
    assert all(np.isfinite(r32["loss_port"]))
    port_err = _rel(r32["port"], r64["jax"])
    jax_err = _rel(r32["jax"], r64["jax"])
    trained = [k for k in r64["jax"]
               if not (k.endswith("_b") and k != "output_b")]
    worst = (max(port_err[k] for k in trained),
             max(jax_err[k] for k in trained))
    assert worst[0] <= 2 * worst[1], worst
    for k in r32["port"]:
        assert r32["port"][k].dtype == np.float32, k


def test_num_params_at_imagenet_size_equals_jax():
    conf = JaxResNet50(height=224, width=224, channels=3,
                       num_classes=1000).conf()
    n_jax = JaxGraph(conf).init().num_params()
    net = ResNet50(height=224, width=224, num_classes=1000).build(
        device="cpu")
    assert net.num_params() == n_jax
    assert 25_000_000 < net.num_params() < 26_200_000


def test_graph_fuses_33_bn_relu_and_keeps_20_plain_bn():
    net = ResNet50(height=32, width=32, num_classes=4).build(device="cpu")
    bns = [m for m in net.model.values() if isinstance(m, torch.nn.Module)
           and hasattr(m, "relu") and hasattr(m, "gamma")]
    assert sum(m.relu for m in bns) == 33
    assert sum(not m.relu for m in bns) == 20
    assert sum(isinstance(m, torch.nn.Identity)
               for m in net.model.values()) == 33


def test_every_bn_backward_goes_through_the_kernel_wrapper(monkeypatch):
    calls = []
    real = bn_relu.bn_relu_bwd

    def counting(x, dy, gamma, mean, inv, a, b, relu):
        calls.append(bool(relu))
        return real(x, dy, gamma, mean, inv, a, b, relu)

    monkeypatch.setattr(bn_relu, "bn_relu_bwd", counting)
    x, y = _data("float32")
    net = ResNet50(height=32, width=32, num_classes=4).build(device="cpu")
    net.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"))
    assert len(calls) == 53 * STEPS
    assert sum(calls) == 33 * STEPS


def test_bf16_mixed_precision_step_is_close_to_f32():
    """One bf16 step of the full network from the same weights: the loss
    is finite and within 50% of the float32 loss, the masters stay
    float32 and move. The bound is loose because bf16 is, here: 8 bits of
    mantissa through 53 conv + batch-norm layers at init move this batch's
    loss by tens of percent (the JAX package's bf16 step as well as the
    port's). The cast policy itself is held to the JAX package's by
    ``test_bf16_mixed_precision_step_matches_jax``."""
    x, y = _data("float32")
    losses = {}
    for mp in (None, MixedPrecision()):
        conf = ResNet50(height=32, width=32, num_classes=4).conf()
        conf.mixed_precision = mp
        net = ComputationGraph(conf).init(device="cpu")
        before = net.params()
        losses[mp is None] = net.fit(DeviceCachedIterator(
            x[:B], y[:B], batch_size=B, device="cpu")).final_loss()
        after = net.params()
        assert all(v.dtype == np.float32 for v in after.values())
        assert not np.allclose(after["res2a_2b_W"], before["res2a_2b_W"])
    assert np.isfinite(losses[False])
    assert losses[False] == pytest.approx(losses[True], rel=0.5)


def _resnet_head_conf(nn, resnet, nesterovs, hw):
    """ResNet-50's stem, stage 2's projection block and one identity
    block, then its head, through the zoo model's own block helpers."""
    r = resnet(height=hw, width=hw, num_classes=4)
    g = (nn.NeuralNetConfiguration.builder().seed(42)
         .updater(nesterovs(learning_rate=0.1, momentum=0.9))
         .graph_builder().add_inputs("input")
         .set_input_types(nn.InputType.convolutional(hw, hw, 3)))
    (g.add_layer("stem_zero", nn.ZeroPaddingLayer(padding=(3, 3, 3, 3)),
                 "input")
     .add_layer("stem_conv", nn.ConvolutionLayer(
         n_out=64, kernel_size=(7, 7), stride=(2, 2),
         convolution_mode="VALID"), "stem_zero")
     .add_layer("stem_bn", nn.BatchNormalization(), "stem_conv")
     .add_layer("stem_act", nn.ActivationLayer(activation="relu"),
                "stem_bn")
     .add_layer("stem_pool", nn.SubsamplingLayer(
         pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2)),
         "stem_act"))
    cur = r._conv_block(g, (3, 3), (64, 64, 256), 2, "a", "stem_pool",
                        stride=(1, 1))
    cur = r._identity_block(g, (3, 3), (64, 64, 256), 2, "b", cur)
    (g.add_layer("gap", nn.GlobalPoolingLayer(pooling_type="AVG"), cur)
     .add_layer("output", nn.OutputLayer(n_out=4, loss_function="MCXENT"),
                "gap")
     .set_outputs("output"))
    return g.build()


def test_bf16_mixed_precision_step_matches_jax():
    """The bf16 MixedPrecision cast policy against the JAX package's
    (``samediff.py`` ``_build_step_parts``): one step of both packages
    from the same weights (``gamma``/``beta`` drawn off 1/0, so that
    their cast to bf16 rounds) on the same batch, compared in the loss,
    every batch-norm running statistic and every tensor's parameter
    change, beside the JAX package's own bf16-vs-f32 distance.

    The network is ResNet-50's stem, stage 2's first two blocks and its
    head, at 16x16, which keeps the readings apart. Readings on this
    seed: port bf16 vs JAX bf16 loss 1.1e-7 of its value, statistics
    8.0e-7 of their magnitude at worst, parameter change 1.6e-2 (median
    tensor) and 7.8e-2 (worst); JAX bf16 vs JAX f32 1.2e-3, 8.4e-3, 0.25
    and 0.50. Each tolerance lies between its two readings. The parameter changes differ more than the forward
    does because the backward is another algorithm: the port's BN
    backward works in f32 and rounds dx to bf16 once, the JAX package
    differentiates its bf16 forward op by op. At the full network's
    depth, or at 32x32 (where the XLA CPU bf16 stem convolution rounds
    otherwise and the JAX bf16 step lies farther from its f32 step than
    the port's does), the two distances are of one size, and no
    tolerance could tell a wrong cast from a sound one."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 3, 16, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    res, w = {}, None
    for tag, mp in (("jax_bf16", JaxMixedPrecision()), ("jax_f32", None)):
        conf = _resnet_head_conf(jax_nn, JaxResNet50, JaxNesterovs, 16)
        conf.cnn_data_format, conf.dtype = "NCHW", "float32"
        conf.mixed_precision = mp
        net = JaxGraph(conf).init()
        if w is None:
            w = net.params()
            for k in w:
                if k.endswith(("_gamma", "_beta")):
                    w[k] = (float(k.endswith("_gamma")) + 0.2 * rng.normal(
                        size=w[k].shape)).astype(np.float32)
        for k, v in w.items():
            net._sd_train.set_arr_for_var(k, v)
        loss = net.fit(JaxIterator(x, y, batch_size=B)).final_loss()
        res[tag] = (loss, net.params())
    conf = _resnet_head_conf(port_nn, ResNet50, Nesterovs, 16)
    conf.mixed_precision = MixedPrecision()
    net = ComputationGraph(conf).init(device="cpu")
    net.model.load_state_dict(params_from_jax(w))
    loss = net.fit(DeviceCachedIterator(x, y, batch_size=B,
                                        device="cpu")).final_loss()
    res["port_bf16"] = (loss, net.params())
    assert all(v.dtype == np.float32 for v in res["port_bf16"][1].values())

    def dist(a, b):
        (la, pa), (lb, pb) = res[a], res[b]
        stats = {k for k in w if k.endswith(("_mean", "_var"))}
        # conv biases feed a batch norm: their true gradient is 0
        trained = {k for k in w if k not in stats
                   and not (k.endswith("_b") and k != "output_b")}
        da = {k: pa[k] - w[k] for k in trained}
        db = {k: pb[k] - w[k] for k in trained}
        change = _rel(da, db)
        return (abs(la - lb) / abs(lb), max(_rel(pa, pb)[k] for k in stats),
                float(np.median(list(change.values()))),
                max(change.values()))

    port, upper = dist("port_bf16", "jax_bf16"), dist("jax_bf16", "jax_f32")
    tols = (1e-5, 1e-4, 6e-2, 0.2)
    for name, got, tol, up in zip(("loss", "statistics", "median change",
                                   "worst change"), port, tols, upper):
        assert got <= tol < up, (name, got, tol, up)
def test_fit_takes_dataset_batches_like_the_device_iterator():
    from deeplearning4j_tpu_torch.dataset import DataSet
    x, y = _data("float32")
    losses = []
    for batches in (lambda: [DataSet(x[:B], y[:B])],
                    lambda: DeviceCachedIterator(x[:B], y[:B], batch_size=B,
                                                 device="cpu")):
        net = ResNet50(height=32, width=32, num_classes=4).build(
            device="cpu")
        losses.append(net.fit(batches()).final_loss())
        assert net.score() == losses[-1]
    assert losses[0] == losses[1]
