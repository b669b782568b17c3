"""``ComputationGraph.fit`` on SameDiff's fit tiers, on the CPU.

ResNet-50 at 32x32, 4 classes, batch 8, from one set of weights: the
port's scanned epoch and its fused windows (K = 4 over 11 steps: windows
4 + 4 + 2 + 1) against its per-step tier, bit for bit (on the CPU a
window runs its steps eagerly, so the tiers run the same arithmetic):
every parameter, every running statistic and every step's loss. The
port's scanned fit against the JAX package's ``ComputationGraph.fit(it,
epochs=2)`` in float64, from the same weights carried across with
``convert.params_from_jax``, at the tolerance of
``test_torch_resnet50.test_fit_matches_jax_f64_every_param_and_stat``;
the JAX network is built NCHW (its NHWC batch norm takes per-tensor
statistics, ROADMAP queue 3).

A small convolutional graph (batch norm, ReLU, a residual add, global
pooling, two dense layers) in float64 holds ``fit(X, Y, batch_size=4)``
and the listeners' burst delivery to the JAX calls. Also:
``last_fit_stats`` against ``SameDiff``'s, the refusals, and the set of
tensors a capture's warm-up restores (every batch-norm buffer), read
through the function that builds it, since the CPU does not capture.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jax_nn
import deeplearning4j_tpu_torch.nn as port_nn
from deeplearning4j_tpu.autodiff import Listener as JListener
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JaxIterator
from deeplearning4j_tpu.learning.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.nn import ComputationGraph as JaxGraph
from deeplearning4j_tpu.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.autodiff import Listener, TrainingConfig
from deeplearning4j_tpu_torch.checkpoint import TrainingState
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_jax
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import Nesterovs
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import BatchNorm
from deeplearning4j_tpu_torch.zoo import ResNet50

B, STEPS = 8, 11
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch here: the suite runs six test files at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(steps, dtype="float32", seed=7, hw=32, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, 3, hw, hw)).astype(dtype)
    y = np.eye(classes, dtype=dtype)[rng.integers(0, classes, steps * B)]
    return x, y


@pytest.fixture(scope="module")
def weights():
    """One set of ResNet-50 (32x32, 4 classes) weights, a state dict."""
    return ResNet50(height=32, width=32, num_classes=4).build(
        device="cpu").model.state_dict()


def _resnet(weights, dtype="float32"):
    conf = ResNet50(height=32, width=32, num_classes=4).conf()
    conf.dtype = dtype
    net = ComputationGraph(conf).init(device="cpu")
    net.model.load_state_dict(weights)
    return net


def _recorder(base, frequency=10 ** 9):
    class Rec(base):
        def __init__(self):
            self.frequency = frequency
            self.calls = []

        def iterations_done(self, sd, epoch, iterations, losses):
            self.calls.append((epoch, list(iterations),
                               [float(v) for v in losses]))
    return Rec()


def _losses(rec):
    return [v for _, _, vals in rec.calls for v in vals]


@pytest.fixture(scope="module")
def tiers(weights):
    """Two epochs of 11 steps on each tier from the same weights: the
    per-step tier (a listener), the scanned epoch (none) and windows of
    4 (a listener). Returns tier -> (net, step losses, history)."""
    x, y = _data(STEPS)
    it = DeviceCachedIterator(x, y, batch_size=B, device="cpu")
    out = {}
    for tier, k, listen in (("per_step", 1, True), ("scanned", 1, False),
                            ("windows", 4, True)):
        net = _resnet(weights)
        rec = _recorder(Listener)
        hist = net.fit(it, epochs=2, listeners=[rec] if listen else [],
                       fused_steps=k)
        out[tier] = (net, _losses(rec) if listen else hist.step_losses,
                     hist, dict(net.last_fit_stats))
    return out


@pytest.mark.parametrize("tier", ["scanned", "windows"])
def test_graph_tiers_equal_the_per_step_tier_bit_for_bit(tiers, tier,
                                                         weights):
    ref, ref_losses, _, _ = tiers["per_step"]
    net, losses, hist, _ = tiers[tier]
    assert losses == ref_losses and len(losses) == 2 * STEPS
    assert hist.step_losses == ref_losses
    got, want = net.params(), ref.params()
    assert set(got) == set(want)
    stats = [k for k in want if k.endswith(("_mean", "_var"))]
    assert len(stats) == 2 * 53
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    init = params_to_jax(weights)
    assert all(not np.array_equal(want[k], init[k]) for k in stats)
    assert net.training_config.iteration_count == 2 * STEPS
    assert net.training_config.epoch_count == 2
    assert net.score() == hist.final_loss()


@pytest.mark.parametrize("tier,stats", [
    ("per_step", {"tier": "per_step", "fused_steps": 1,
                  "dispatches_per_epoch": STEPS,
                  "eager_steps_per_epoch": STEPS, "window_sizes": {1: STEPS},
                  "window_captures": 0}),
    ("scanned", {"tier": "scanned_epoch", "fused_steps": 1,
                 "dispatches_per_epoch": 1, "eager_steps_per_epoch": 0,
                 "window_sizes": {STEPS: 1}, "window_captures": 0}),
    ("windows", {"tier": "windowed", "fused_steps": 4,
                 "dispatches_per_epoch": 4, "eager_steps_per_epoch": 0,
                 "window_sizes": {4: 2, 2: 1, 1: 1}, "window_captures": 0})])
def test_last_fit_stats_keys_and_values(tiers, tier, stats):
    """The keys ``SameDiff.last_fit_stats`` has; the second epoch's
    values (its windows were captured in the first: none new); no
    replay on the CPU, where a window runs eagerly."""
    from deeplearning4j_tpu_torch.zoo import LeNet
    lenet = LeNet().build(device="cpu")
    rng = np.random.default_rng(0)
    lenet.fit(DeviceCachedIterator(
        rng.random((16, 1, 28, 28)).astype(np.float32),
        np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)], 8,
        device="cpu"))
    got = tiers[tier][3]
    assert set(got) == set(lenet.samediff.last_fit_stats)
    assert got["steps_per_epoch"] == STEPS
    assert got["graph_replays_per_epoch"] == 0
    for k, v in stats.items():
        assert got[k] == v, k


def test_scanned_fit_matches_jax_fit_f64(weights):
    """Two epochs of one step through both packages' ``fit`` on a device
    iterator (both take their scanned tier), float64, from the JAX
    network's weights: every step's loss (an epoch's mean here),
    parameter and running statistic. More steps leave the tolerance: at
    this learning rate the network at init amplifies the float32
    rounding of the JAX batch norm's gamma and beta step by step."""
    x, y = _data(1, "float64", seed=3)
    conf = JaxResNet50(height=32, width=32, num_classes=4).conf()
    conf.cnn_data_format, conf.dtype = "NCHW", "float64"
    jnet = JaxGraph(conf).init()
    init = jnet.params()
    jhist = jnet.fit(JaxIterator(x, y, batch_size=B), epochs=2)
    assert jnet.samediff.last_fit_stats["tier"] == "scanned_epoch"
    pnet = _resnet(params_from_jax(init), "float64")
    phist = pnet.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"),
                     epochs=2)
    assert pnet.last_fit_stats["tier"] == "scanned_epoch"
    assert phist.step_losses == phist.epoch_losses
    np.testing.assert_allclose(phist.epoch_losses, jhist.loss_curve.losses,
                               rtol=1e-6)
    want, got = jnet.params(), pnet.params()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_b") and k != "output_b":
            # conv biases feed a batch norm: their true gradient is 0
            assert np.max(np.abs(got[k] - v)) < 1e-9, k
        else:
            err = np.max(np.abs(got[k] - v)) / max(np.max(np.abs(v)), 1e-30)
            assert err < 1e-4, (k, err)
        if k.endswith(("_mean", "_var")):
            assert not np.allclose(v, init[k]), k


def test_warmup_restore_set_holds_every_batch_norm_buffer(weights):
    """A capture's warm-up steps undo what they write: the set holds
    every parameter, its Nesterovs velocity and both running statistics
    of each of the 53 batch norms."""
    net = _resnet(weights)
    names, state = net._fit_state()
    got = {id(t) for t in net.warmup_restore_set(names, state)}
    bns = [m for m in net.model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 53
    assert all(id(m.mean) in got and id(m.var) in got for m in bns)
    assert all(id(p) in got for p in net.model.parameters())
    assert all(id(v) in got for (v,) in state)
    assert len(got) == 2 * len(names) + 2 * 53
    assert set(dict(net.model.named_buffers())) <= {
        f"{n}.{s}" for n, m in net.model.named_children()
        if isinstance(m, BatchNorm) for s in ("mean", "var")}


# ----------------------------------------------------------------------
# a small convolutional graph in both packages
def _small_conf(nn, nesterovs, dtype="float64"):
    conf = (nn.NeuralNetConfiguration.builder().seed(5)
            .updater(nesterovs(learning_rate=0.05, momentum=0.9))
            .graph_builder().add_inputs("input")
            .set_input_types(nn.InputType.convolutional(8, 8, 3))
            .add_layer("conv", nn.ConvolutionLayer(
                n_out=6, kernel_size=(3, 3), convolution_mode="SAME"),
                "input")
            .add_layer("bn", nn.BatchNormalization(), "conv")
            .add_layer("act", nn.ActivationLayer(activation="relu"), "bn")
            .add_layer("proj", nn.ConvolutionLayer(
                n_out=6, kernel_size=(1, 1), convolution_mode="VALID"),
                "input")
            .add_vertex("add", nn.ElementWiseVertex(op="Add"), "act",
                        "proj")
            .add_layer("gap", nn.GlobalPoolingLayer(pooling_type="AVG"),
                       "add")
            .add_layer("dense", nn.DenseLayer(n_out=5, activation="relu"),
                       "gap")
            .add_layer("output", nn.OutputLayer(n_out=3,
                                                loss_function="MCXENT"),
                       "dense")
            .set_outputs("output").build())
    conf.dtype = dtype
    return conf


def _small_pair():
    jconf = _small_conf(jax_nn, JNesterovs)
    jconf.cnn_data_format = "NCHW"
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(_small_conf(port_nn, Nesterovs)).init(
        device="cpu")
    pnet.model.load_state_dict(params_from_jax(jnet.params()))
    return jnet, pnet


def _small_data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 8, 8))
    return x, np.eye(3)[rng.integers(0, 3, n)]


def _close_params(got, want, tol=1e-6):
    """Each tensor within ``tol`` of its largest magnitude. The JAX
    float64 batch norm casts gamma and beta to float32, so the packages
    part at float32's rounding; the conv bias before the batch norm has a
    true gradient of 0 and is held absolutely."""
    assert set(got) == set(want)
    for k, v in want.items():
        err = np.max(np.abs(got[k] - v))
        if k != "conv_b":
            err /= max(np.max(np.abs(v)), 1e-30)
        assert err <= tol, (k, err)


@pytest.mark.parametrize("fused_steps,tier,eager", [
    (None, "per_step", 3), (2, "windowed", 1)])
def test_fit_arrays_with_labels_matches_jax(fused_steps, tier, eager):
    """``fit(X, Y, batch_size=4)``: 10 rows are batches of 4, 4 and 2 (a
    ragged last batch), two epochs, per-step in both packages, or with
    ``fused_steps=2`` one window of the two full batches and the ragged
    batch as one eager step."""
    x, y = _small_data(10)
    jnet, pnet = _small_pair()
    jhist = jnet.fit(x, y, epochs=2, batch_size=4, fused_steps=fused_steps)
    phist = pnet.fit(x, y, epochs=2, batch_size=4, fused_steps=fused_steps)
    assert pnet.last_fit_stats["tier"] == tier
    assert pnet.last_fit_stats["eager_steps_per_epoch"] == eager
    assert pnet.last_fit_stats["steps_per_epoch"] == 3
    # the loss is summed in float32 in both packages: one unit in its
    # last place apart
    np.testing.assert_allclose(phist.epoch_losses, jhist.loss_curve.losses,
                               rtol=1e-6)
    _close_params(pnet.params(), jnet.params())
    assert pnet.score() == pytest.approx(jnet.score(), rel=1e-6)


@pytest.mark.parametrize("k,frequency", [(1, 5), (4, 5), (8, 3), (4, 4)])
def test_listener_bursts_match_jax(k, frequency):
    """A listener gets the same iterations and losses, in the same calls
    (at the first window boundary at or after each multiple of its
    frequency, and at an epoch's end), as from the JAX fit: 11 batches,
    two epochs."""
    x, y = _small_data(11 * 4, seed=2)

    class Stream:
        def __iter__(self):
            for i in range(0, len(x), 4):
                yield x[i:i + 4], y[i:i + 4]

    jnet, pnet = _small_pair()
    jrec, prec = _recorder(JListener, frequency), _recorder(Listener,
                                                           frequency)
    jnet.fit(Stream(), epochs=2, listeners=[jrec], fused_steps=k)
    pnet.fit(Stream(), epochs=2, listeners=[prec], fused_steps=k)
    assert [(e, its) for e, its, _ in prec.calls] == \
        [(e, its) for e, its, _ in jrec.calls]
    np.testing.assert_allclose(_losses(prec), _losses(jrec), rtol=1e-6)
    _close_params(pnet.params(), jnet.params())
    jst, pst = jnet.samediff.last_fit_stats, pnet.last_fit_stats
    for key in ("tier", "steps_per_epoch", "dispatches_per_epoch",
                "window_sizes"):
        assert pst[key] == jst[key], key


def test_fused_steps_sticks_for_later_fits():
    x, y = _small_data(24)
    _, pnet = _small_pair()
    it = DeviceCachedIterator(x, y, batch_size=4, device="cpu")
    pnet.fit(it, fused_steps=4)
    assert pnet.training_config.fused_steps == 4
    pnet.fit(it)
    assert pnet.last_fit_stats["tier"] == "windowed"
    assert pnet.last_fit_stats["window_sizes"] == {4: 1, 2: 1}
    pnet.fit(it, fused_steps=1)
    assert pnet.last_fit_stats["tier"] == "scanned_epoch"


@pytest.mark.parametrize("kwargs,item", [
    ({"accum_steps": 2}, "queue 1 item 3"),
    ({"sentinel": True}, "queue 1 item 3")])
def test_fit_refuses_what_is_not_ported_by_name(kwargs, item):
    """``accum_steps`` and ``sentinel`` (ROADMAP queue 1 item 3) are
    ported: ``fit`` takes them into the config for this and later fits;
    what is left of the item's config fields is not accepted."""
    x, y = _small_data(8)
    _, pnet = _small_pair()
    before = pnet.params()
    pnet.fit(x, y, batch_size=4, **kwargs)
    for k, v in kwargs.items():
        assert getattr(pnet.training_config, k) == v
        assert pnet.last_fit_stats[k] == v
    assert pnet.last_fit_stats["tier"] == (
        "windowed" if "accum_steps" in kwargs else "per_step")
    assert any(not np.array_equal(v, before[k])
               for k, v in pnet.params().items())
    for field in ("tensorstats", "nan_panic"):
        with pytest.raises(TypeError):
            TrainingConfig(updater=Nesterovs(), **{field: True})


@pytest.mark.parametrize("method,item", [
    ("evaluate", "item 10"), ("save", "item 10"), ("load", "item 10"),
    ("capture_training_state", "item 7"),
    ("restore_training_state", "item 7")])
def test_graph_refuses_what_is_not_ported_by_name(method, item,
                                                  tmp_path):
    """The checkpoint methods are ported; their normalizer statistics
    are not (queue 1 item 7). ``evaluate``, ``save`` and ``load`` are
    ported too (``tests/test_torch_graph_serde.py`` holds them to JAX):
    each works on the small graph, and what is left around them, a zip
    whose configuration names a layer not ported, is refused by name
    when it is read (queue 1 item 10)."""
    jnet, pnet = _small_pair()
    if method in ("evaluate", "save", "load"):
        x, y = _small_data(6)
        path = tmp_path / "g.zip"
        pnet.save(path)
        back = ComputationGraph.load(path, device="cpu")
        if method == "evaluate":
            ev = back.evaluate([(x, y)])
            jev = jnet.evaluate([(x, y)])
            assert np.array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
        else:
            assert torch.equal(back.output(x)[0], pnet.output(x)[0])
        import json
        import zipfile
        bad = tmp_path / "bad.zip"
        with zipfile.ZipFile(path) as src, zipfile.ZipFile(bad, "w") as dst:
            for n in src.namelist():
                data = src.read(n)
                if n == "configuration.json":
                    d = json.loads(data)
                    d["nodes"][0]["op"] = {"@class": "ConvLSTM2DLayer"}
                    data = json.dumps(d)
                dst.writestr(n, data)
        with pytest.raises(NotImplementedError, match=item):
            ComputationGraph.load(bad, device="cpu")
        return
    args = {"capture_training_state": lambda: {"normalizer": object()},
            "restore_training_state": lambda: {"state": TrainingState(
                arrays={}, normalizer_state={"mean": np.zeros(1)})}}
    kwargs = args[method]() if method in args else {}
    with pytest.raises(NotImplementedError,
                       match=f"ComputationGraph.{method} .*{item}"):
        getattr(pnet, method)(**kwargs)


@pytest.mark.parametrize("vertex", [
    port_nn.MergeVertex(), port_nn.ElementWiseVertex(op="Max"),
    port_nn.SubsetVertex(0, 1), port_nn.ScaleVertex(2.0),
    port_nn.ShiftVertex(1.0), port_nn.DotProductVertex(),
    port_nn.L2NormalizeVertex()], ids=lambda v: type(v).__name__)
def test_a_vertex_refuses_recurrent_input_by_name(vertex):
    """Vertices on recurrent input were refused by name; they are ported
    now (the feature axis of a (B, T, C) sequence is 2, as in the JAX
    graph): each vertex's output on two sequences equals the JAX
    graph's, float64."""
    def conf(nn, v):
        rnn = nn.InputType.recurrent(4, 6)
        c = (nn.NeuralNetConfiguration.builder().graph_builder()
             .add_inputs("a", "b").set_input_types(rnn, rnn)
             .add_vertex("v", v,
                         *(("a", "b") if type(v).__name__ in (
                             "MergeVertex", "ElementWiseVertex",
                             "DotProductVertex") else ("a",)))
             .set_outputs("v").build())
        c.dtype = "float64"
        return c
    jv = getattr(jax_nn, type(vertex).__name__)(
        **{f.name: getattr(vertex, f.name)
           for f in __import__("dataclasses").fields(vertex)})
    jconf = conf(jax_nn, jv)
    jconf.cnn_data_format = "NCHW"
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(3, 6, 4)), rng.normal(size=(3, 6, 4))
    got = ComputationGraph(conf(port_nn, vertex)).init(
        device="cpu").output(a, b)[0]
    want = np.asarray(JaxGraph(jconf).init().output(a, b)[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_no_tier_calls_the_per_leaf_update(monkeypatch):
    """The fit's updates are the ``_foreach`` ones on every tier: the
    per-leaf plain version is never called."""
    def refuse(*a, **k):
        raise AssertionError("the per-leaf update ran")

    monkeypatch.setattr(Nesterovs, "_leaf_apply_", refuse)
    x, y = _small_data(12)
    _, pnet = _small_pair()
    it = DeviceCachedIterator(x, y, batch_size=4, device="cpu")
    for listeners, k in (([], 1), ([_recorder(Listener)], 1),
                         ([_recorder(Listener)], 2)):
        pnet.fit(it, listeners=listeners, fused_steps=k)
    assert pnet.training_config.iteration_count == 9
