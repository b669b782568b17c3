"""Dropout in the port (``ops/random.py``, ``kernels/dropout.py``,
``csrc/dropout.cu``), on the CPU through the kernel's plain version.

- The generator: Philox4x32-10 against Random123's known-answer vectors,
  its 16-bit-split products against Python's integers past 2^32 (the
  iteration's high word), and the mask's element order (4 words a draw).
- The function: the JAX op's ``where(keep, x / p, 0)`` on the same mask
  (division, not a multiplication by 1/p: they round apart at p = 0.8),
  in bf16, float32 and float64; zeros where dropped; the kept fraction
  within 5 standard deviations of p; the backward the same mask on dy.
- Keys: one (seed, iteration, node) one mask; a new iteration, node or
  seed a new one.
- The fits: a network with dropout trains the same on the per-step, the
  windowed and the scanned tiers (the same masks, the same losses, bit
  for bit on the CPU); each fit takes a new base seed as the JAX fit does;
  a run resumed from ``capture_training_state`` is the uninterrupted one;
  dropout sits in the training graph only; LSTM and convolution input
  dropout and ``DropoutLayer`` in both network kinds; a random op not yet
  ported is still refused by name on the graph tiers.
- The C entry's ctypes declarations against the source.
"""
import ctypes
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch.autodiff import (SameDiff,
                                               ScoreIterationListener,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.kernels import dropout as dk
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.ops import random as rops
from deeplearning4j_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _words(ctr, key):
    out = dk.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64)
                                 for c in ctr), key)
    return [int(o) for o in out]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answer_vectors(ctr, key, want):
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    assert _words(ctr, key) == list(want)


def _philox_py(ctr, key):
    """Philox4x32-10 in Python integers (no splitting)."""
    c, k = list(ctr), list(key)
    m = 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & m]
        k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
    return c


def test_split_products_equal_python_integers_at_high_words():
    rng = np.random.default_rng(0)
    for _ in range(50):
        ctr = tuple(int(v) for v in rng.integers(0, 2 ** 32, 4))
        key = tuple(int(v) for v in rng.integers(0, 2 ** 32, 2))
        assert _words(ctr, key) == _philox_py(ctr, key)


def test_mask_is_word_i_mod_4_of_draw_i_div_4():
    seed, it, node, p = (3 << 32) + 17, (1 << 33) + 5, 9, 0.7
    keep = dk.keep_mask_plain(10, seed, it, node, p)
    t = dk.keep_threshold(p)
    want = []
    for g in range(3):
        r = _philox_py((g, 0, it & 0xFFFFFFFF, it >> 32),
                       (seed & 0xFFFFFFFF, (seed >> 32) ^ node))
        want += [(w >> 8) < t for w in r]
    assert keep.tolist() == want[:10]
    assert dk.keep_threshold(0.5) == 1 << 23
    assert dk.keep_threshold(1.0) == 1 << 24


def _rng(seed=0, it=0, dev="cpu"):
    return rops.host_rng(seed, it, dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("p", [0.5, 0.8, 0.9])
def test_dropout_is_the_jax_function_on_its_mask(p, dtype):
    """``where(keep, x / p, 0)`` in x's dtype, as the JAX op computes it
    given the same mask: a division (for bf16, in float32 and rounded)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(37, 29))).to(dtype)
    seed, it = _rng(5, 3)
    y = dk.dropout_plain(x, p, seed, it, 2)
    keep = dk.keep_mask_plain(x.numel(), 5, 3, 2, p).reshape(x.shape)
    xd = x.double().numpy()
    scaled = (xd / p) if dtype == torch.float64 else \
        (x.float().numpy() / np.float32(p))
    want = torch.from_numpy(np.where(keep.numpy(), scaled, 0.0)).to(dtype)
    assert torch.equal(y, want)
    assert torch.all(y[~keep] == 0)


def test_division_not_reciprocal_at_p_08():
    """For p = 0.8 ``x / p`` and ``x * (1 / p)`` differ in float32 on
    some inputs: the port divides."""
    x = torch.arange(1, 4097, dtype=torch.float32) / 97
    by_div = dk._divide(x, 0.8)
    by_mul = x * torch.tensor(1 / 0.8, dtype=torch.float32)
    assert torch.equal(by_div, x / torch.tensor(0.8, dtype=torch.float32))
    assert not torch.equal(by_div, by_mul)


@pytest.mark.parametrize("p", [0.5, 0.8])
def test_kept_fraction_and_scale(p):
    n = 1 << 18
    x = torch.ones(n, dtype=torch.float64)
    y = dk.dropout_plain(x, p, 7, 11, 4)
    kept = float((y != 0).double().mean())
    assert abs(kept - p) < 5 * math.sqrt(p * (1 - p) / n)
    assert torch.all((y == 0) | (y == 1 / p))
    assert abs(float(y.mean()) - 1.0) < 5 * math.sqrt((1 - p) / p / n)


def test_masks_follow_seed_iteration_and_node():
    n, p = 4096, 0.5
    base = dk.keep_mask_plain(n, 1, 2, 3, p)
    assert torch.equal(base, dk.keep_mask_plain(n, 1, 2, 3, p))
    for other in ((2, 2, 3), (1, 3, 3), (1, 2, 4), (1 + (1 << 32), 2, 3)):
        m = dk.keep_mask_plain(n, *other, p)
        assert not torch.equal(base, m), other
        # independent draws agree on about half the elements
        assert abs(float((m == base).double().mean()) - 0.5) < 0.05


def test_backward_drops_the_same_elements():
    x = torch.randn(64, 33, dtype=torch.float64, requires_grad=True)
    seed, it = _rng(3, 9)
    y = dk.dropout(x, 0.6, seed, it, 1)
    dy = torch.randn_like(y)
    y.backward(dy)
    assert torch.equal(x.grad, dk.dropout_plain(dy, 0.6, seed, it, 1))
    assert torch.equal(x.grad == 0, y == 0)


def test_op_needs_a_scope_and_is_identity_when_off():
    x = torch.ones(8)
    op = registry.get_op("dropout")
    assert op.category == "random"
    assert op.fn(x, 0.5, training=False) is x
    assert op.fn(x, 1.0) is x
    with pytest.raises(RuntimeError, match="rng_scope"):
        op.fn(x, 0.5)
    with rops.rng_scope(*_rng(1, 2)):
        y = op.fn(x, 0.5, node=3)
    assert torch.equal(y, dk.dropout_plain(x, 0.5, 1, 2, 3))


# ----------------------------------------------------------------------
# in networks
def _mlp_conf(dropout=0.5, updater=None):
    return (pnn.NeuralNetConfiguration.builder().seed(3)
            .updater(updater or Sgd(0.1)).list()
            .layer(pnn.DenseLayer(n_out=16, activation="relu"))
            .layer(pnn.DenseLayer(n_out=16, activation="relu",
                                  dropout=dropout))
            .layer(pnn.DropoutLayer(dropout=0.7))
            .layer(pnn.OutputLayer(n_out=3))
            .set_input_type(pnn.InputType.feed_forward(6)).build())


def _mlp_data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _fit(net, tier, x, y, b=4, epochs=1):
    it = DeviceCachedIterator(x, y, batch_size=b, device="cpu")
    listen = [ScoreIterationListener(10 ** 9, lambda *a: None)]
    if tier == "scanned":
        return net.fit(it, epochs=epochs)
    if tier == "windowed":
        return net.fit(it, epochs=epochs, fused_steps=4, listeners=listen)
    return net.fit(it, epochs=epochs, fused_steps=1, listeners=listen)


def test_training_graph_records_dropout_and_inference_graph_does_not():
    net = pnn.MultiLayerNetwork(_mlp_conf()).init(device="cpu")
    train = [(op.name, op.attrs) for op in net.samediff.ops()
             if op.op == "dropout"]
    assert [a["p"] for _, a in train] == [0.5, 0.7]
    assert len({a["node"] for _, a in train}) == 2
    assert not [op for op in net._sd_infer.ops() if op.op == "dropout"]
    x, _ = _mlp_data(4)
    a, b = net.output(x), net.output(x)
    assert torch.equal(a, b)                   # inference: no dropout


def test_tiers_draw_the_same_masks_and_train_the_same():
    x, y = _mlp_data()
    out = {}
    for tier in ("per_step", "windowed", "scanned"):
        net = pnn.MultiLayerNetwork(_mlp_conf()).init(device="cpu")
        h = _fit(net, tier, x, y)
        assert net.samediff.last_fit_stats["tier"] == (
            "scanned_epoch" if tier == "scanned" else tier)
        out[tier] = (h.step_losses, net.params())
    for tier in ("windowed", "scanned"):
        assert out[tier][0] == out["per_step"][0]
        for k, v in out["per_step"][1].items():
            np.testing.assert_array_equal(out[tier][1][k], v, err_msg=k)


def test_each_fit_takes_a_new_base_seed_and_masks_change():
    x, y = _mlp_data(8)
    net = pnn.MultiLayerNetwork(_mlp_conf()).init(device="cpu")
    sd = net.samediff
    assert sd._seed == 0 and sd._fit_base_seed is None
    _fit(net, "scanned", x, y)
    assert sd._fit_base_seed == 0 and int(sd.rng_seed_tensor()) == 0
    _fit(net, "per_step", x, y)
    assert sd._fit_base_seed == 1 and int(sd.rng_seed_tensor()) == 1
    # the same batch at iterations 0..3 drops other units each step
    node = [op.attrs["node"] for op in sd.ops() if op.op == "dropout"][0]
    masks = [dk.keep_mask_plain(4 * 16, 0, i, node, 0.5) for i in range(4)]
    assert all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))


def test_resumed_run_equals_the_uninterrupted_one():
    from deeplearning4j_tpu_torch.checkpoint.state import (
        capture_training_state, restore_training_state)
    x, y = _mlp_data(32)
    whole = pnn.MultiLayerNetwork(_mlp_conf(updater=Adam(1e-2))).init(
        device="cpu")
    hw = _fit(whole, "scanned", x, y)
    first = pnn.MultiLayerNetwork(_mlp_conf(updater=Adam(1e-2))).init(
        device="cpu")
    h1 = _fit(first, "scanned", x[:16], y[:16])
    state = capture_training_state(first)
    assert state.rng_seed == 0 and state.iteration == 4
    second = pnn.MultiLayerNetwork(_mlp_conf(updater=Adam(1e-2))).init(
        device="cpu")
    _fit(second, "per_step", x[:4], y[:4])     # moves its seed on
    restore_training_state(second, state)
    h2 = _fit(second, "windowed", x[16:], y[16:])
    assert h1.step_losses + h2.step_losses == hw.step_losses
    for k, v in whole.params().items():
        np.testing.assert_array_equal(second.params()[k], v, err_msg=k)


def test_lstm_and_conv_input_dropout_in_a_multilayer_network():
    conf = (pnn.NeuralNetConfiguration.builder().seed(2).list()
            .layer(pnn.LSTMLayer(n_out=5, dropout=0.8))
            .layer(pnn.RnnOutputLayer(n_out=3))
            .set_input_type(pnn.InputType.recurrent(4, 6)).build())
    net = pnn.MultiLayerNetwork(conf).init(device="cpu")
    assert [op.op for op in net.samediff.ops()][0] == "dropout"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 6, 4)).astype(np.float32)
    yy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 6))]
    assert np.isfinite(net.fit(x, yy, batch_size=4,
                               fused_steps=2).final_loss())
    conf = (pnn.NeuralNetConfiguration.builder().seed(2).list()
            .layer(pnn.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                        dropout=0.6))
            .layer(pnn.OutputLayer(n_out=2))
            .set_input_type(pnn.InputType.convolutional(5, 5, 2)).build())
    net = pnn.MultiLayerNetwork(conf).init(device="cpu")
    assert net.samediff.ops()[1].op == "dropout"


def _graph_conf(p=0.5):
    return (pnn.NeuralNetConfiguration.builder().seed(4)
            .updater(Sgd(0.1)).graph_builder()
            .add_inputs("in")
            .set_input_types(pnn.InputType.convolutional(6, 6, 2))
            .add_layer("c", pnn.ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), activation="relu",
                dropout=p), "in")
            .add_layer("gap", pnn.GlobalPoolingLayer(), "c")
            .add_layer("d", pnn.DenseLayer(n_out=8, dropout=p), "gap")
            .add_layer("drop", pnn.DropoutLayer(dropout=0.8), "d")
            .add_layer("out", pnn.OutputLayer(n_out=3), "drop")
            .set_outputs("out").build())


def test_graph_dropout_per_node_and_tiers_equal():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 2, 6, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    out = {}
    for tier in ("per_step", "windowed", "scanned"):
        net = pnn.ComputationGraph(_graph_conf()).init(device="cpu")
        assert [m.drop.node for m in (net.model["c"], net.model["d"])] == \
            [0, 2] and net.model["drop"].node == 3
        h = _fit(net, tier, x, y)
        out[tier] = (h.step_losses, net.params())
    for tier in ("windowed", "scanned"):
        assert out[tier][0] == out["per_step"][0]
        for k, v in out["per_step"][1].items():
            np.testing.assert_array_equal(out[tier][1][k], v, err_msg=k)
    net = pnn.ComputationGraph(_graph_conf()).init(device="cpu")
    a = net.output(x[:4])[0]
    assert torch.equal(a, net.output(x[:4])[0])       # inference
    t1 = net.output(x[:4], training=True)[0]
    t2 = net.output(x[:4], training=True)[0]          # the next seed
    assert not torch.equal(t1, t2)


def test_unported_random_op_is_still_refused_on_the_graph_tiers(
        monkeypatch):
    registry.op_names()
    monkeypatch.setitem(registry._REGISTRY, "test_noise", registry.Op(
        "test_noise", lambda a: a + torch.randn_like(a), "random", 1))
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(-1, 6))
    h = sd.invoke("dropout", [x], {"p": 0.5}, name="drop")
    h = sd.invoke("test_noise", [h], name="noisy")
    w = sd.var("w", value=np.zeros((6, 3), np.float32))
    sd.loss.softmax_cross_entropy(h.mmul(w), sd.placeholder(
        "labels", shape=(-1, 3)), name="loss")
    sd.training_config = TrainingConfig(
        updater=Sgd(0.1), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], fused_steps=2)
    xs, ys = _mlp_data(8)
    with pytest.raises(NotImplementedError,
                       match="'noisy' .*ROADMAP queue 1 item 5"):
        sd.fit(DeviceCachedIterator(xs, ys, 4, device="cpu"))


def test_ctypes_declarations_match_the_c_source():
    src = (ROOT / "deeplearning4j_tpu_torch" / "csrc" / "dropout.cu"
           ).read_text()
    m = re.search(r'extern "C" int dl4j_dropout\(([^)]*)\)', src)
    params = [p.strip().split()[-1].lstrip("*") for p in
              m.group(1).split(",")]
    assert params == [n for n, _ in dk.ARGTYPES]
    types = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
             "int": ctypes.c_int, "double": ctypes.c_double}
    for decl, (_, t) in zip(m.group(1).split(","), dk.ARGTYPES):
        words = decl.replace("const", "").replace("*", " * ").split()[:-1]
        assert types["".join(words)] is t, decl
    assert "__fdiv_rn" in src and "__ddiv_rn" in src
    assert "kM0 = 0xD2511F53u" in src and "kW1 = 0xBB67AE85u" in src


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises; here,
    with no card, it raises where the kernel would launch."""
    class CardTensor(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")
    x = torch.zeros(8).as_subclass(CardTensor)
    seed = torch.zeros(1, dtype=torch.int64).as_subclass(CardTensor)
    monkeypatch.setattr(dk, "dropout_plain", None)
    with pytest.raises(Exception):
        dk.dropout_apply(x, 0.5, seed, seed, 0)
