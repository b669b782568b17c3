"""``ComputationGraph`` JSON, ``save``/``load`` and ``evaluate`` in the
port against the JAX package's, on the CPU, and every ``evaluation/``
class against the JAX class on the same predictions.

- The configuration's JSON (and each vertex's) equals the JAX package's
  for the same graph (built NCHW), and each package reads the other's.
- A zip written by either package loads in the other: the outputs
  (float64: 1e-12 of their largest magnitude, 1e-6 through a batch norm
  as ``tests/test_torch_graph.py`` holds cnn graphs; the arrays themselves
  bit for bit), the updater state's leaves in the JAX order and the iteration
  equal; a port zip loaded back in the port gives the same output and the
  same next fit step, bit for bit.
- ``evaluate`` streams ``output`` into ``Evaluation`` (default),
  ``ROCMultiClass`` or ``EvaluationCalibration`` and equals the same
  statistics computed from ``output`` by hand; each class equals the JAX
  class fed the same predictions (counts exactly; AUCs and calibration
  statistics to 1e-12).
"""
import json

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.evaluation as jev
import deeplearning4j_tpu.evaluation.calibration as jcal
import deeplearning4j_tpu.nn as jax_nn
import deeplearning4j_tpu_torch.evaluation as pev
import deeplearning4j_tpu_torch.evaluation.calibration as pcal
import deeplearning4j_tpu_torch.nn as port_nn
from deeplearning4j_tpu.checkpoint import \
    capture_training_state as jcapture
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.nn import layers_ext as jext
from deeplearning4j_tpu.nn import noise_layers as jnoise
from deeplearning4j_tpu.nn import recurrent_layers as jrec
from deeplearning4j_tpu_torch.checkpoint import \
    capture_training_state as pcapture
from deeplearning4j_tpu_torch.learning import Adam

F, T, B = 5, 6, 4


def _ns(nn, jax):
    """The layer classes of either package under one namespace."""
    ns = type("NS", (), {})()
    mods = (nn, jext, jrec, jnoise) if jax else (nn,)
    for mod in mods:
        for k in dir(mod):
            if not k.startswith("_"):
                setattr(ns, k, getattr(mod, k))
    return ns


def _sentiment(nn, adam, dtype="float64"):
    """A small copy of the sentiment graph: noise, a bidirectional GRU,
    a peephole LSTM, the last step, a softmax head; and a vertex."""
    conf = (nn.NeuralNetConfiguration.builder().seed(21)
            .updater(adam(learning_rate=0.01)).graph_builder()
            .add_inputs("in")
            .set_input_types(nn.InputType.recurrent(F, T))
            .add_layer("noise", nn.GaussianNoiseLayer(stddev=0.1), "in")
            .add_layer("bigru", nn.Bidirectional(
                layer=nn.GRULayer(n_out=6), mode="CONCAT"), "noise")
            .add_layer("glstm", nn.GravesLSTMLayer(n_out=5), "bigru")
            .add_vertex("scale", nn.ScaleVertex(scale_factor=2.0), "glstm")
            .add_layer("last", nn.LastTimeStepLayer(), "scale")
            .add_layer("out", nn.OutputLayer(n_out=3), "last")
            .set_outputs("out").build())
    conf.dtype = dtype
    return conf


def _pair():
    jconf = _sentiment(_ns(jax_nn, True), JAdam)
    jconf.cnn_data_format = "NCHW"
    pconf = _sentiment(port_nn, Adam)
    return (jax_nn.ComputationGraph(jconf).init(),
            port_nn.ComputationGraph(pconf).init(device="cpu"))


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, T, F)),
            np.eye(3)[rng.integers(0, 3, n)])


def _np(v):
    v = v.to_numpy() if hasattr(v, "to_numpy") else v
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, tol=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


# ----------------------------------------------------------------------
def test_graph_json_is_the_jax_one_both_ways():
    jnet, pnet = _pair()
    pj, jj = pnet.conf.to_json(), jnet.conf.to_json()
    assert json.loads(pj) == json.loads(jj)
    back = port_nn.ComputationGraphConfiguration.from_json(jj)
    assert json.loads(back.to_json()) == json.loads(jj)
    jback = jax_nn.graph.ComputationGraphConfiguration.from_json(pj)
    assert json.loads(jback.to_json()) == json.loads(jj)
    # a graph built from the read configuration draws the same weights
    net = port_nn.ComputationGraph(back).init(device="cpu")
    for n, a in jnet.params().items():
        assert np.array_equal(net.params()[n], np.asarray(a)), n


@pytest.mark.parametrize("vertex", [
    port_nn.MergeVertex(), port_nn.ElementWiseVertex(op="Max"),
    port_nn.SubsetVertex(from_idx=1, to_idx=3),
    port_nn.ScaleVertex(scale_factor=0.5),
    port_nn.ShiftVertex(shift_factor=-1.0),
    port_nn.L2NormalizeVertex(eps=1e-6, dimensions=(1,)),
    port_nn.DotProductVertex(normalize=True)])
def test_vertex_json_is_the_jax_one(vertex):
    d = vertex.to_json()
    jv = jax_nn.graph.GraphVertex.from_json(d)
    assert jv.to_json() == d
    assert port_nn.GraphVertex.from_json(jv.to_json()) == vertex


def _trained_pair():
    jnet, pnet = _pair()
    x, y = _data()
    jnet.fit(x, y, epochs=2, batch_size=B)
    pnet.fit(x, y, epochs=2, batch_size=B)
    return jnet, pnet, x, y


def _leaves(state):
    return [np.asarray(a) for a in state.updater_leaves]


def test_port_zip_loads_in_jax(tmp_path):
    _, pnet, x, _ = _trained_pair()
    path = tmp_path / "port.zip"
    pnet.save(path)
    jnet = jax_nn.ComputationGraph.load(path)
    for n, a in pnet.params().items():
        assert np.array_equal(np.asarray(jnet.params()[n]), a), n
    _close(pnet.output(x)[0], jnet.output(x)[0])
    assert jnet._sd_train.training_config.iteration_count == \
        pnet.training_config.iteration_count == 4
    for a, b in zip(_leaves(jcapture(jnet)), _leaves(pcapture(pnet))):
        assert np.array_equal(a, b)


def test_jax_zip_loads_in_the_port(tmp_path):
    jnet, _, x, _ = _trained_pair()
    path = tmp_path / "jax.zip"
    jnet.save(path)
    pnet = port_nn.ComputationGraph.load(path, device="cpu")
    for n, a in jnet.params().items():
        assert np.array_equal(pnet.params()[n], np.asarray(a)), n
    _close(pnet.output(x)[0], jnet.output(x)[0])
    assert pnet.training_config.iteration_count == 4
    ja, pa = _leaves(jcapture(jnet)), _leaves(pcapture(pnet))
    assert len(ja) == len(pa) > 0
    for a, b in zip(ja, pa):
        assert np.array_equal(a, b)


def test_port_zip_round_trip_is_bit_equal_and_trains_on(tmp_path):
    _, pnet, x, y = _trained_pair()
    path = tmp_path / "p.zip"
    pnet.save(path)
    back = port_nn.ComputationGraph.load(path, device="cpu")
    assert torch.equal(back.output(x)[0], pnet.output(x)[0])
    back._seed = pnet._seed        # the next fit draws the same noise
    ha = pnet.fit(x[:B], y[:B], batch_size=B)
    hb = back.fit(x[:B], y[:B], batch_size=B)
    assert ha.step_losses == hb.step_losses
    for n, a in pnet.params().items():
        assert np.array_equal(back.params()[n], a), n
    # without the updater state the zip holds none, and a load starts it
    # at zero
    pnet.save(tmp_path / "n.zip", include_updater_state=False)
    import zipfile
    assert "updater.npz" not in zipfile.ZipFile(tmp_path / "n.zip").namelist()


def test_cnn_graph_zip_both_ways(tmp_path):
    """A graph with a convolution, a batch norm and a flatten: the HWIO
    weights and the running statistics cross in both directions."""
    def conf(nn, adam):
        c = (nn.NeuralNetConfiguration.builder().seed(2)
             .updater(adam(learning_rate=0.01)).graph_builder()
             .add_inputs("in")
             .set_input_types(nn.InputType.convolutional(5, 5, 2))
             .add_layer("c", nn.ConvolutionLayer(n_out=3, kernel_size=(3, 3)),
                        "in")
             .add_layer("bn", nn.BatchNormalization(), "c")
             .add_layer("d", nn.DenseLayer(n_out=4), "bn")
             .add_layer("out", nn.OutputLayer(n_out=2), "d")
             .set_outputs("out").build())
        c.dtype = "float64"
        return c
    jconf = conf(jax_nn, JAdam)
    jconf.cnn_data_format = "NCHW"
    jnet = jax_nn.ComputationGraph(jconf).init()
    pnet = port_nn.ComputationGraph(conf(port_nn, Adam)).init(device="cpu")
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(6, 2, 5, 5)), np.eye(2)[rng.integers(0, 2, 6)]
    jnet.fit(x, y, batch_size=3)
    pnet.fit(x, y, batch_size=3)
    pnet.save(tmp_path / "p.zip")
    jnet.save(tmp_path / "j.zip")
    jback = jax_nn.ComputationGraph.load(tmp_path / "p.zip")
    pback = port_nn.ComputationGraph.load(tmp_path / "j.zip", device="cpu")
    # the batch norm's arithmetic differs between the packages at 1e-8
    # (tests/test_torch_graph.py holds cnn graphs to 1e-6)
    _close(jback.output(x)[0], pnet.output(x)[0], 1e-6)
    _close(pback.output(x)[0], jnet.output(x)[0], 1e-6)
    for n, a in pnet.params().items():
        assert np.array_equal(np.asarray(jback.params()[n]), a), n
    for n, a in jnet.params().items():
        assert np.array_equal(pback.params()[n], np.asarray(a)), n
    for a, b in zip(_leaves(jcapture(jback)), _leaves(pcapture(pnet))):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# evaluate and the evaluation classes
def test_evaluate_streams_output_into_each_evaluation():
    _, pnet, x, y = _trained_pair()
    it = [(x[:4], y[:4]), (x[4:], y[4:])]
    p = pnet.output(x)[0].numpy()
    ev = pnet.evaluate(it)
    assert isinstance(ev, pev.Evaluation)
    want = pev.Evaluation()
    want.eval(y, p)
    assert np.array_equal(ev.confusion_matrix(), want.confusion_matrix())
    roc = pnet.evaluate(it, pev.ROCMultiClass())
    jroc = jev.ROCMultiClass()
    jroc.eval(y, p)
    assert roc.average_auc() == pytest.approx(jroc.average_auc(), abs=1e-12)
    cal = pnet.evaluate(it, pcal.EvaluationCalibration())
    jc = jcal.EvaluationCalibration()
    jc.eval(y, p)
    assert cal.expected_calibration_error() == pytest.approx(
        jc.expected_calibration_error(), abs=1e-12)


def _preds(seed, n=200, c=4):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(c), n)
    y = np.eye(c)[rng.integers(0, c, n)]
    return y, p


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_and_roc_classes_equal_jax(seed):
    y, p = _preds(seed)
    eb, jeb = pev.EvaluationBinary(threshold=0.3), \
        jev.EvaluationBinary(threshold=0.3)
    for a, b in ((y[:90], p[:90]), (y[90:], p[90:])):
        eb.eval(a, torch.tensor(b))
        jeb.eval(a, b)
    for i in range(4):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(eb, m)(i) == getattr(jeb, m)(i)
    roc, jroc = pev.ROC(), jev.ROC()
    yy = y[:, :2] / np.maximum(y[:, :2].sum(1, keepdims=True), 1)
    pp = p[:, :2] / p[:, :2].sum(1, keepdims=True)
    roc.eval(yy, pp)
    jroc.eval(yy, pp)
    for a, b in zip(roc.roc_curve(), jroc.roc_curve()):
        np.testing.assert_array_equal(a, b)
    assert roc.auc() == jroc.auc() and roc.auprc() == jroc.auprc()
    rb, jrb = pev.ROCBinary(), jev.ROCBinary()
    rb.eval(y, p)
    jrb.eval(y, p)
    assert [rb.auc(i) for i in range(4)] == [jrb.auc(i) for i in range(4)]
    rm, jrm = pev.ROCMultiClass(), jev.ROCMultiClass()
    rm.eval(y.argmax(1), p)
    jrm.eval(y.argmax(1), p)
    assert rm.average_auc() == jrm.average_auc()


def test_calibration_classes_equal_jax():
    y, p = _preds(3, n=300, c=3)
    pc = pcal.EvaluationCalibration(reliability_bins=7, histogram_bins=13)
    jc = jcal.EvaluationCalibration(reliability_bins=7, histogram_bins=13)
    mask = (np.arange(300) % 5 != 0).astype(np.float32)
    pc.eval(torch.tensor(y), torch.tensor(p), mask=mask)
    jc.eval(y, p, mask=mask)
    other = pcal.EvaluationCalibration(reliability_bins=7, histogram_bins=13)
    other.eval(y[:50], p[:50])
    jo = jcal.EvaluationCalibration(reliability_bins=7, histogram_bins=13)
    jo.eval(y[:50], p[:50])
    pc.merge(other)
    jc.merge(jo)
    for c in range(3):
        a, b = pc.reliability_diagram(c), jc.reliability_diagram(c)
        np.testing.assert_array_equal(a.bin_counts, b.bin_counts)
        np.testing.assert_allclose(a.mean_predicted_value,
                                   b.mean_predicted_value, rtol=1e-12)
        np.testing.assert_allclose(a.frac_positives, b.frac_positives,
                                   rtol=1e-12)
        assert pc.expected_calibration_error(c) == pytest.approx(
            jc.expected_calibration_error(c), abs=1e-12)
        np.testing.assert_array_equal(pc.residual_plot(c).bin_counts,
                                      jc.residual_plot(c).bin_counts)
        np.testing.assert_array_equal(
            pc.probability_histogram(c).bin_counts,
            jc.probability_histogram(c).bin_counts)
    np.testing.assert_array_equal(pc.label_counts_each_class(),
                                  jc.label_counts_each_class())
    np.testing.assert_array_equal(pc.prediction_counts_each_class(),
                                  jc.prediction_counts_each_class())
    h, jh = pc.residual_plot_all_classes(), jc.residual_plot_all_classes()
    np.testing.assert_array_equal(h.bin_counts, jh.bin_counts)
    np.testing.assert_array_equal(h.bin_edges(), jh.bin_edges())
    assert repr(h) == repr(jh)
    hp = pc.probability_histogram_all_classes()
    assert pcal.histogram_quantile(hp, 0.5) == jcal.histogram_quantile(
        jc.probability_histogram_all_classes(), 0.5)
    assert pc.stats() == jc.stats()


def test_a_jax_nhwc_graph_that_flattens_is_refused_by_name(tmp_path):
    """The JAX graph's default layout is NHWC; a dense layer after its
    cnn input's flatten holds rows in (h, w, c) order, which the port's
    NCHW graph does not read: its zip is refused by name. Without a
    flatten the NHWC zip loads and computes the same."""
    from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
    from deeplearning4j_tpu_torch.learning import Sgd

    def conf(nn, sgd, flatten):
        g = (nn.NeuralNetConfiguration.builder().seed(2)
             .updater(sgd(learning_rate=0.1)).graph_builder()
             .add_inputs("in")
             .set_input_types(nn.InputType.convolutional(5, 5, 2))
             .add_layer("c", nn.ConvolutionLayer(n_out=3, kernel_size=(3, 3)),
                        "in"))
        if not flatten:
            g = g.add_layer("gap", nn.GlobalPoolingLayer(), "c")
        g = (g.add_layer("out", nn.OutputLayer(n_out=2),
                         "c" if flatten else "gap")
             .set_outputs("out"))
        c = g.build()
        c.dtype = "float64"
        return c
    x = np.random.default_rng(0).normal(size=(3, 2, 5, 5))
    for flatten in (True, False):
        jnet = jax_nn.ComputationGraph(conf(jax_nn, JSgd, flatten)).init()
        assert jnet.conf.cnn_data_format == "NHWC"
        path = tmp_path / f"nhwc_{flatten}.zip"
        jnet.save(path)
        if flatten:
            with pytest.raises(NotImplementedError, match="queue 1 item 1"):
                port_nn.ComputationGraph.load(path, device="cpu")
        else:
            pnet = port_nn.ComputationGraph.load(path, device="cpu")
            _close(pnet.output(x)[0], jnet.output(x)[0], 1e-10)
