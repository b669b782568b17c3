"""The configuration's JSON, the ModelSerializer zip and ``evaluate`` in
the port against the JAX package's, on the CPU.

JSON: each package's ``to_json`` read by the other's ``from_json``, and
the parsed documents equal. Zip: a network saved by either package after
a few Adam steps loads in the other with the same outputs (float32, 1e-6
of the largest magnitude: the same weights, the same ops), bit-equal
weights, updater leaves and iteration. ``evaluate``: the port's
``Evaluation`` and ``RegressionEvaluation`` hold the JAX objects'
accuracy, F1, precision, recall, MCC, confusion matrix and ``stats``
text, and MSE, MAE, RMSE, R^2 and Pearson, on the same arrays (host
float64 arithmetic on both sides: to 1e-12).
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.evaluation import \
    RegressionEvaluation as JRegressionEvaluation
from deeplearning4j_tpu.learning.regularization import \
    L2Regularization as JL2
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu.zoo.models import TextGenLSTM as JTextGen
from deeplearning4j_tpu_torch.checkpoint.state import _live_leaves
from deeplearning4j_tpu_torch.evaluation import (ROC, Evaluation,
                                                 EvaluationBinary,
                                                 RegressionEvaluation,
                                                 ROCBinary, ROCMultiClass)
from deeplearning4j_tpu_torch.learning import L2Regularization
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork)
from deeplearning4j_tpu_torch.zoo import LeNet, TextGenLSTM

V, U, T = 12, 8, 6


def _chars(n, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _confs(model):
    if model == "textgen":
        return (JTextGen(vocab_size=V, units=U, timesteps=T).conf(),
                TextGenLSTM(vocab_size=V, units=U, timesteps=T).conf())
    j, p = JLeNet(height=12, width=12).conf(), LeNet(height=12,
                                                      width=12).conf()
    j.regularization = [JL2(1e-4)]
    p.regularization = [L2Regularization(1e-4)]
    j.grad_clip_value = p.grad_clip_value = 0.5
    return j, p


@pytest.mark.parametrize("model", ["textgen", "lenet"])
def test_configuration_json_reads_both_ways(model):
    jconf, pconf = _confs(model)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    jback = JMLConf.from_json(pconf.to_json())
    assert json.loads(jback.to_json()) == json.loads(jconf.to_json())
    # a network built from the read configuration draws the same weights
    pnet = MultiLayerNetwork(back).init(device="cpu")
    jnet = JMLN(jconf).init()
    for n, a in jnet.params().items():
        assert np.array_equal(pnet.params()[n], np.asarray(a)), n


@pytest.mark.parametrize("name,item", [
    ("VariationalAutoencoderLayer", "queue 1 item 10: nn/ layers"),
    # Bidirectional and SimpleRnnLayer are ported now
    ("ConvLSTM2DLayer", "queue 1 item 10: recurrent_layers"),
    ("RecurrentAttentionLayer", "queue 1 item 10: nn/ layers"),
])
def test_json_naming_a_layer_not_ported_is_refused_by_name(name, item):
    d = json.loads(_confs("textgen")[1].to_json())
    d["layers"][0] = {"@class": name, "n_out": 4}
    with pytest.raises(NotImplementedError, match=item):
        MultiLayerConfiguration.from_json(json.dumps(d))


def _trained_pair():
    jnet = JTextGen(vocab_size=V, units=U, timesteps=T, seed=4).build()
    pnet = TextGenLSTM(vocab_size=V, units=U, timesteps=T,
                       seed=4).build(device="cpu")
    x, y = _chars(8, T, 1)
    jnet.fit(x, y, epochs=1, batch_size=4)
    pnet.fit(x, y, epochs=1, batch_size=4)
    return jnet, pnet, x


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_a_jax_zip_loads_in_the_port(tmp_path):
    jnet, _, x = _trained_pair()
    path = str(tmp_path / "jax.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    _close(net.output(x).numpy(), jnet.output(x).to_numpy())
    for n, a in jnet.params().items():
        assert np.array_equal(net.params()[n], np.asarray(a)), n
    leaves = jax.tree_util.tree_leaves(jnet._sd_train._updater_state)
    got = _live_leaves(net.samediff)
    assert len(got) == len(leaves) == 16
    for (_, t), a in zip(got, leaves):
        assert np.array_equal(t.numpy(), np.asarray(a))
    assert net.samediff.training_config.iteration_count == \
        jnet._sd_train.training_config.iteration_count == 2


def test_a_port_zip_loads_in_jax(tmp_path):
    _, pnet, x = _trained_pair()
    path = str(tmp_path / "port.zip")
    pnet.save(path)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["configuration.json",
                                         "iteration.json", "parameters.npz",
                                         "updater.npz"]
    jnet = JMLN.load(path)
    _close(jnet.output(x).to_numpy(), pnet.output(x).numpy())
    for n, a in pnet.params().items():
        assert np.array_equal(np.asarray(jnet.params()[n]), a), n
    leaves = jax.tree_util.tree_leaves(jnet._sd_train._updater_state)
    for (_, t), a in zip(_live_leaves(pnet.samediff), leaves):
        assert np.array_equal(t.numpy(), np.asarray(a))
    assert jnet._sd_train.training_config.iteration_count == 2


def test_save_load_resumes_training_bit_equal(tmp_path):
    """A loaded network's next steps (fit, then fit_tbptt) equal the saved
    network's, bit for bit; without the updater state there is no
    ``updater.npz`` and a loaded network starts a new Adam state."""
    _, pnet, x = _trained_pair()
    path = str(tmp_path / "net.zip")
    pnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    assert torch.equal(net.output(x), pnet.output(x))
    _, y = _chars(8, T, 1)
    pnet.fit(x, y, epochs=1, batch_size=4)
    net.fit(x, y, epochs=1, batch_size=4)
    xs, ys = _chars(8, 11, 2)
    pnet.fit_tbptt(xs, ys, 4, epochs=1, batch_size=4)
    net.fit_tbptt(xs, ys, 4, epochs=1, batch_size=4)
    for n, a in pnet.params().items():
        assert np.array_equal(net.params()[n], a), n
    pnet.save(path, include_updater_state=False)
    with zipfile.ZipFile(path) as zf:
        assert "updater.npz" not in zf.namelist()
    assert MultiLayerNetwork.load(path, device="cpu").samediff \
        ._updater_state is None


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails midway leaves the previous zip as it was."""
    _, pnet, _ = _trained_pair()
    path = str(tmp_path / "net.zip")
    pnet.save(path)
    before = open(path, "rb").read()
    from deeplearning4j_tpu_torch.nn import model_serde

    def boom(arrays):
        raise OSError("disk full")

    monkeypatch.setattr(model_serde, "_npz", boom)
    with pytest.raises(OSError, match="disk full"):
        pnet.save(path)
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["net.zip"]


# ----------------------------------------------------------------------
# evaluation
def _classes(n, c, seed):
    rng = np.random.default_rng(seed)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    p = rng.random((n, c)).astype(np.float32) + 0.8 * y
    return y, p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_jax(top_n):
    pe, je = Evaluation(top_n=top_n), JEvaluation(top_n=top_n)
    for seed in (0, 1):
        y, p = _classes(50, 6, seed)
        pe.eval(torch.tensor(y), torch.tensor(p))
        je.eval(y, p)
    assert np.array_equal(pe.confusion_matrix(), je.confusion_matrix())
    for m in ("accuracy", "precision", "recall", "f1", "top_n_accuracy",
              "matthews_correlation"):
        assert getattr(pe, m)() == pytest.approx(getattr(je, m)(), abs=1e-12)
    for c in range(6):
        assert pe.f1(c) == pytest.approx(je.f1(c), abs=1e-12)
    assert pe.stats() == je.stats()
    with pytest.raises(ValueError, match=r"predictions must be \(N, C\)"):
        pe.eval(np.zeros((2, 3, 6)), np.zeros((2, 3, 6)))


def test_regression_evaluation_matches_jax():
    pe, je = RegressionEvaluation(), JRegressionEvaluation()
    rng = np.random.default_rng(2)
    for _ in range(2):
        y = rng.normal(size=(40, 3)).astype(np.float32)
        p = (y + 0.3 * rng.normal(size=y.shape)).astype(np.float32)
        pe.eval(torch.tensor(y), torch.tensor(p))
        je.eval(y, p)
    for c in range(3):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "r_squared",
                  "pearson_correlation"):
            assert getattr(pe, m)(c) == pytest.approx(getattr(je, m)(c),
                                                      abs=1e-12)
    assert pe.stats() == je.stats()


def test_network_evaluate_matches_jax():
    """``evaluate`` on a classifier (arrays and an iterator), and on
    TextGenLSTM, whose (B, T, C) output both packages' ``Evaluation``
    rejects; its outputs flattened to (N, C) evaluate alike."""
    jnet, pnet = JLeNet(height=12, width=12).build(), LeNet(
        height=12, width=12).build(device="cpu")
    rng = np.random.default_rng(3)
    x = rng.random((20, 1, 12, 12)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 20)]
    pe = pnet.evaluate(x, y, batch_size=8)
    je = jnet.evaluate(x, y, batch_size=8)
    assert np.array_equal(pe.confusion_matrix(), je.confusion_matrix())
    assert pe.stats() == je.stats()
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    pr = pnet.evaluate(DeviceCachedIterator(x, y, 4, device="cpu"),
                       evaluation=RegressionEvaluation())
    jr = JRegressionEvaluation()
    jr.eval(y, jnet.output(x).to_numpy())
    assert pr.mean_squared_error(3) == pytest.approx(
        jr.mean_squared_error(3), rel=1e-5)
    jt, pt, xs = _trained_pair()
    _, ys = _chars(8, T, 1)
    for net in (jt, pt):
        with pytest.raises(ValueError, match=r"must be \(N, C\)"):
            net.evaluate(xs, ys)
    pe, je = Evaluation(), JEvaluation()
    pe.eval(ys.reshape(-1, V), pt.output(xs).reshape(-1, V))
    je.eval(ys.reshape(-1, V), jt.output(xs).to_numpy().reshape(-1, V))
    assert np.array_equal(pe.confusion_matrix(), je.confusion_matrix())


@pytest.mark.parametrize("cls", [EvaluationBinary, ROC, ROCBinary,
                                 ROCMultiClass])
def test_evaluations_not_ported_are_refused_by_name(cls):
    """These four are ported now (they were refused by name): each equals
    the JAX class on the trained TextGenLSTM's predictions."""
    import deeplearning4j_tpu.evaluation as jev
    jt, pt, xs = _trained_pair()
    _, ys = _chars(8, T, 1)
    y = ys.reshape(-1, V)
    pp = pt.output(xs).reshape(-1, V)
    jp = jt.output(xs).to_numpy().reshape(-1, V)
    if cls is ROC:      # binary: class 0 against the rest
        y = np.stack([1 - y[:, 0], y[:, 0]], 1)
        pp = torch.stack([1 - pp[:, 0], pp[:, 0]], 1)
        jp = np.stack([1 - jp[:, 0], jp[:, 0]], 1)
    pe, je = cls(), getattr(jev, cls.__name__)()
    pe.eval(y, pp)
    je.eval(y, jp)
    if cls is EvaluationBinary:
        for i in range(V):
            assert pe.accuracy(i) == je.accuracy(i)
            assert pe.f1(i) == pytest.approx(je.f1(i), abs=1e-12)
    elif cls is ROC:
        assert pe.auc() == pytest.approx(je.auc(), abs=1e-6)
    elif cls is ROCBinary:
        for i in range(V):
            assert pe.auc(i) == pytest.approx(je.auc(i), abs=1e-6)
    else:
        assert pe.average_auc() == pytest.approx(je.average_auc(), abs=1e-6)
