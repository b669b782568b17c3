"""The port's LSTM (ops, cell kernels' plain versions, layers, TextGenLSTM)
against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages. Tolerances: float64
1e-12 of each tensor's largest magnitude (the same arithmetic, sums in
another order); float32 1e-5 (the recurrence compounds rounding over
the timesteps; the hoisted ``x @ W_ih`` rounds where JAX's per-step
product does). Sizes are tiny: vocab 12, units 8, T 6.

Also: the C source's entries against the wrappers' ctypes declarations
and the nvcc command, the recurrence's launches (one forward and one
backward cell a timestep and layer, counted with the cell stubbed), the
layer rules on rnn input, and what is refused by name.
"""
import ctypes
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGPool
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.recurrent_layers import \
    LastTimeStepLayer as JLast
from deeplearning4j_tpu.nn.recurrent_layers import \
    RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.zoo.models import TextGenLSTM as JTextGen
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.kernels import _cuda, lstm
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (Bidirectional, ConvLSTM2DLayer,
                                         DenseLayer, GlobalPoolingLayer,
                                         InputType, LastTimeStepLayer,
                                         LSTMLayer, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         RnnOutputLayer, SimpleRnnLayer)
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.zoo import TextGenLSTM

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "lstm_cell.cu"
TOL = {np.float32: 1e-5, np.float64: 1e-12}
V, U, T, B = 12, 8, 6, 4


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _lstm_inputs(dtype, seed=0, b=B, t=T, n_in=5, u=U):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, n_in), (b, u), (b, u), (n_in, 4 * u), (u, 4 * u),
              (4 * u,)]
    return [rng.normal(0, 0.7, s).astype(dtype) for s in shapes]


# ----------------------------------------------------------------------
# the ops
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_layer_forward_and_every_gradient_match_jax(dtype,
                                                         return_sequences):
    arrs = _lstm_inputs(dtype)
    attrs = {"return_sequences": return_sequences}
    jfn = jreg.get_op("lstm_layer").fn
    pfn = preg.get_op("lstm_layer").fn
    jouts = jfn(*map(jnp.asarray, arrs), **attrs)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    pouts = pfn(*ts, **attrs)
    for p, j in zip(pouts, jouts):
        _close(p, j, TOL[dtype])
    # a loss reading all three outputs, so every path back is taken
    w = [np.random.default_rng(9).normal(size=np.shape(o)).astype(dtype)
         for o in jouts]

    def jloss(*a):
        o = jfn(*a, **attrs)
        return sum(jnp.sum(oi * wi) for oi, wi in zip(o, w))

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    ploss = sum((o * torch.tensor(wi)).sum() for o, wi in zip(pouts, w))
    pgrads = torch.autograd.grad(ploss, ts)
    for p, j in zip(pgrads, jgrads):
        _close(p, j, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lstm_cell_op_and_its_gradients_match_jax(dtype):
    x, h, c, wi, wh, b = _lstm_inputs(dtype)
    args = [x[:, 0], h, c, wi, wh, b]
    jfn, pfn = jreg.get_op("lstm_cell").fn, preg.get_op("lstm_cell").fn
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ph, pc = pfn(*ts)
    jh, jc = jfn(*map(jnp.asarray, args))
    _close(ph, jh, TOL[dtype])
    _close(pc, jc, TOL[dtype])
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a)[0] * 1.5 + jfn(*a)[1] ** 2),
                  argnums=tuple(range(6)))(*map(jnp.asarray, args))
    pg = torch.autograd.grad((ph * 1.5 + pc ** 2).sum(), ts)
    for p, j in zip(pg, jg):
        _close(p, j, TOL[dtype])


def test_recurrent_ops_are_registered_under_the_jax_names():
    for n in ("lstm_cell", "lstm_layer", "lstmLayer", "rnn_init_state",
              "reduce_max", "amax_reduce", "strided_slice"):
        assert preg.has_op(n) and jreg.has_op(n), n
        assert preg.get_op(n).name == jreg.get_op(n).name
        assert preg.get_op(n).category == jreg.get_op(n).category
    assert preg.get_op("lstmLayer") is preg.get_op("lstm_layer")
    x = np.zeros((3, 7, 2), np.float32)
    for tm in (False, True):
        got = preg.exec_op("rnn_init_state", x, units=5, time_major=tm)
        want = jreg.get_op("rnn_init_state").fn(jnp.asarray(x), units=5,
                                                time_major=tm)
        assert tuple(got.shape) == want.shape and not got.any()


def test_time_major_lstm_layer_matches_jax():
    arrs = _lstm_inputs(np.float64)
    arrs[0] = np.ascontiguousarray(arrs[0].swapaxes(0, 1))
    for p, j in zip(preg.exec_op("lstm_layer", *arrs, time_major=True),
                    jreg.get_op("lstm_layer").fn(*map(jnp.asarray, arrs),
                                                 time_major=True)):
        _close(p, j, 1e-12)


# ----------------------------------------------------------------------
# the cell's plain versions (what the CUDA kernels compute)
def _jax_cell(z, c_prev):
    i, f, g, o = jnp.split(z, 4, axis=-1)
    i, f, g, o = (jax.nn.sigmoid(i), jax.nn.sigmoid(f), jnp.tanh(g),
                  jax.nn.sigmoid(o))
    c = f * c_prev + i * g
    return o * jnp.tanh(c), c


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b,u", [(3, 5), (32, 16)])
def test_cell_plain_versions_match_jax_and_its_vjp(dtype, b, u):
    rng = np.random.default_rng(3)
    z = rng.normal(0, 2, (b, 4 * u)).astype(dtype)
    cp, dh_up, dh_next, dc_next = (rng.normal(size=(b, u)).astype(dtype)
                                   for _ in range(4))
    gates, h, c = lstm.lstm_cell_fwd_plain(torch.tensor(z),
                                           torch.tensor(cp))
    jh, jc = _jax_cell(jnp.asarray(z), jnp.asarray(cp))
    _close(h, jh, TOL[dtype])
    _close(c, jc, TOL[dtype])
    (_, _), vjp = jax.vjp(_jax_cell, jnp.asarray(z), jnp.asarray(cp))
    jdz, jdc = vjp((jnp.asarray(dh_up + dh_next), jnp.asarray(dc_next)))
    dz, dcp = lstm.lstm_cell_bwd_plain(gates, torch.tensor(cp), c,
                                       torch.tensor(dh_up),
                                       torch.tensor(dh_next),
                                       torch.tensor(dc_next))
    _close(dz, jdz, TOL[dtype])
    _close(dcp, jdc, TOL[dtype])
    # None is zero, and the wrappers write in place (dc_prev over dc_next)
    zt, out_h, out_c = torch.tensor(z), torch.empty(b, u, dtype=c.dtype), \
        torch.empty(b, u, dtype=c.dtype)
    lstm.lstm_cell_fwd(zt, torch.tensor(cp), out_h, out_c)
    assert torch.equal(zt, gates) and torch.equal(out_h, h)
    dc_buf, dz_buf = torch.tensor(dc_next), torch.empty_like(gates)
    lstm.lstm_cell_bwd(gates, torch.tensor(cp), c, None, None, dc_buf,
                       dz_buf, dc_buf)
    want = lstm.lstm_cell_bwd_plain(gates, torch.tensor(cp), c,
                                     dc_next=torch.tensor(dc_next))
    assert torch.equal(dz_buf, want[0]) and torch.equal(dc_buf, want[1])


def test_the_recurrence_launches_one_cell_a_timestep_and_layer(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = lstm.lstm_cell_fwd, lstm.lstm_cell_bwd

    def count(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(lstm, "lstm_cell_fwd", count("fwd", fwd))
    monkeypatch.setattr(lstm, "lstm_cell_bwd", count("bwd", bwd))
    ts = [torch.tensor(a, requires_grad=True)
          for a in _lstm_inputs(np.float32, t=9)]
    out = preg.exec_op("lstm_layer", *ts)
    assert calls == {"fwd": 9, "bwd": 0}
    out[0].sum().backward()
    assert calls == {"fwd": 9, "bwd": 9}


def test_cell_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="c_prev"):
        lstm.lstm_cell_fwd(z, torch.zeros(2, 3), torch.zeros(2, 2),
                           torch.zeros(2, 2))
    with pytest.raises(NotImplementedError, match="queue 2b item 11"):
        lstm.lstm_cell_fwd(z.half(), *(torch.zeros(2, 2).half(),) * 3)
    x = [torch.tensor(a) for a in _lstm_inputs(np.float32)]
    with pytest.raises(NotImplementedError, match="queue 2b item 11"):
        lstm.lstm_sequence(*[t.bfloat16() for t in x])


def _c_entries():
    text = SRC.read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        params = [p.strip().rsplit(" ", 1) for p in m.group(2).split(",")]
        out[m.group(1)] = [(t.strip(), n.strip()) for t, n in params]
    return out


def test_ctypes_declarations_match_the_c_entries():
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    entries = _c_entries()
    assert sorted(entries) == sorted(lstm.ARGTYPES)
    for name, params in entries.items():
        assert [n for _, n in params] == [n for n, _ in lstm.ARGTYPES[name]]
        assert [c_types[t] for t, _ in params] == \
            [t for _, t in lstm.ARGTYPES[name]]


def test_loading_the_library_declares_both_entries(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    lib = types.SimpleNamespace(dl4j_lstm_cell_fwd=Entry(),
                                dl4j_lstm_cell_bwd=Entry())
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert lstm._lib() is lib
    for name, args in lstm.ARGTYPES.items():
        assert getattr(lib, name).argtypes == [t for _, t in args]


def test_nvcc_command_builds_the_source_for_sm90a():
    out = _cuda.library_path("lstm_cell")
    cmd = _cuda.build_command("lstm_cell", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == str(SRC)
    text = SRC.read_text()
    # one thread a (b, j) unit, templated over float32 and float64, and no
    # library kernel
    for want in ("lstm_cell_fwd_kernel<float>", "lstm_cell_fwd_kernel<double>",
                 "lstm_cell_bwd_kernel<float>", "lstm_cell_bwd_kernel<double>"):
        assert want in text
    assert re.findall(r"#include <(\S+)>", text) == ["cuda_runtime.h",
                                                     "stdint.h"]


# ----------------------------------------------------------------------
# the layers and TextGenLSTM
def _textgen_pair(seed=5):
    jnet = JTextGen(vocab_size=V, timesteps=T, units=U, seed=seed).build()
    pnet = TextGenLSTM(vocab_size=V, timesteps=T, units=U,
                       seed=seed).build(device="cpu")
    return jnet, pnet


def _chars(n, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def test_textgen_draws_the_jax_weights_and_its_output_matches():
    jnet, pnet = _textgen_pair()
    jp, pp = jnet.params(), pnet.params()
    assert sorted(jp) == sorted(pp) == [
        "layer0_lstm_Whh", "layer0_lstm_Wih", "layer0_lstm_b",
        "layer1_lstm_Whh", "layer1_lstm_Wih", "layer1_lstm_b",
        "layer2_rnnout_W", "layer2_rnnout_b"]
    for n in jp:
        assert np.array_equal(np.asarray(jp[n]), pp[n]), n
    b = pp["layer0_lstm_b"]
    assert np.all(b[U:2 * U] == 1.0) and not b[:U].any() and \
        not b[2 * U:].any()
    assert pnet.num_params() == jnet.num_params()
    # the zoo's full width: 887,117 parameters
    assert TextGenLSTM().conf().layers[0].n_out == 256
    x, _ = _chars(B, T, 0)
    _close(pnet.output(x), jnet.output(x).to_numpy(), 1e-5)


def test_textgen_output_from_carried_weights_matches():
    jnet, _ = _textgen_pair(seed=1)
    pnet = TextGenLSTM(vocab_size=V, timesteps=T, units=U,
                       seed=99).build(device="cpu")
    samediff_arrays_from_jax({n: np.asarray(a) for n, a in
                              jnet.params().items()}, pnet.samediff)
    x, _ = _chars(B, T, 2)
    _close(pnet.output(x), jnet.output(x).to_numpy(), 1e-5)


def test_textgen_fit_steps_match_jax():
    """Per-step tier (arrays), then the scanned epoch (a device-cached
    iterator), 2 epochs of 2 steps: losses and parameters to 1e-5."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    jnet, pnet = _textgen_pair()
    x, y = _chars(2 * B, T, 4)
    jh = jnet.fit(x, y, epochs=2, batch_size=B)
    ph = pnet.fit(x, y, epochs=2, batch_size=B)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=1e-5)
    assert pnet.samediff.last_fit_stats["tier"] == "per_step"
    ph2 = pnet.fit(DeviceCachedIterator(x, y, B, device="cpu"), epochs=1)
    jh2 = jnet.fit(x, y, epochs=1, batch_size=B)
    assert pnet.samediff.last_fit_stats["tier"] == "scanned_epoch"
    np.testing.assert_allclose(ph2.epoch_losses, jh2.loss_curve.losses,
                               rtol=1e-5)
    jp, pp = jnet.params(), pnet.params()
    for n in jp:
        _close(pp[n], jp[n], 1e-5)


def _rnn_conf(pkg, head, pool=None):
    (nnc, lstm_l, out, itype, adam, dense, last, gpool, rnnout) = {
        "port": (NeuralNetConfiguration, LSTMLayer, OutputLayer, InputType,
                 Adam, DenseLayer, LastTimeStepLayer, GlobalPoolingLayer,
                 RnnOutputLayer),
        "jax": (JNNC, JLSTM, JOutput, JInputType, JAdam, JDense, JLast,
                JGPool, JRnnOut)}[pkg]
    b = nnc.builder().seed(3).updater(adam(learning_rate=1e-2)).list()
    b.layer(lstm_l(n_out=U))
    if head == "last":
        b.layer(last())
    elif head == "pool":
        b.layer(gpool(pooling_type=pool))
    elif head == "hT":
        b.layer(lstm_l(n_out=U, return_sequences=False))
    if head == "dense_rnn":
        b.layer(dense(n_out=5, activation="tanh"))
        b.layer(rnnout(n_out=3))
    else:
        b.layer(out(n_out=3))
    return b.set_input_type(itype.recurrent(V, T)).build()


@pytest.mark.parametrize("head,pool", [("last", None), ("pool", "AVG"),
                                       ("pool", "MAX"), ("pool", "SUM"),
                                       ("hT", None), ("dense_rnn", None)])
def test_layers_on_rnn_input_match_jax(head, pool):
    """LastTimeStepLayer, GlobalPoolingLayer (AVG, MAX, SUM),
    return_sequences=False and a DenseLayer a timestep: output and two
    Adam steps against the JAX network."""
    jnet = JMLN(_rnn_conf("jax", head, pool)).init()
    pnet = MultiLayerNetwork(_rnn_conf("port", head, pool)).init(
        device="cpu")
    x, _ = _chars(2 * B, T, 6)
    rng = np.random.default_rng(7)
    if head == "dense_rnn":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2 * B, T))]
    else:
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 2 * B)]
    _close(pnet.output(x), jnet.output(x).to_numpy(), 1e-5)
    jh = jnet.fit(x, y, epochs=1, batch_size=B)
    ph = pnet.fit(x, y, epochs=1, batch_size=B)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=1e-5)
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a, 1e-5)


def test_a_sequence_before_a_flat_layer_is_refused_as_in_jax():
    conf = (NeuralNetConfiguration.builder().list()
            .layer(LSTMLayer(n_out=4)).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.recurrent(V, T)).build())
    with pytest.raises(ValueError, match=r"return_sequences=False\) or "
                                         r"GlobalPoolingLayer"):
        MultiLayerNetwork(conf).init(device="cpu")


@pytest.mark.parametrize("make,item", [
    (lambda: LSTMLayer(n_out=4, dropout=0.5), "queue 1 item 5"),
    (lambda: SimpleRnnLayer(n_out=4), "queue 1 item 10"),
    (lambda: Bidirectional(), "queue 1 item 10"),
    (lambda: ConvLSTM2DLayer(), "queue 1 item 10"),
])
def test_recurrent_layers_not_ported_are_refused_by_name(make, item):
    with pytest.raises(NotImplementedError, match=item):
        layer = make()
        conf = (NeuralNetConfiguration.builder().list().layer(layer)
                .layer(RnnOutputLayer(n_out=2))
                .set_input_type(InputType.recurrent(V, T)).build())
        MultiLayerNetwork(conf).init(device="cpu")


def test_input_type_rnn_is_the_jax_one():
    for p, j in ((InputType.recurrent(7, 11), JInputType.recurrent(7, 11)),
                 (InputType.feed_forward(3), JInputType.feed_forward(3)),
                 (InputType.convolutional(4, 5, 2),
                  JInputType.convolutional(4, 5, 2))):
        assert p.placeholder_shape() == j.placeholder_shape()
        assert p.to_json() == j.to_json()
        assert InputType.from_json(j.to_json()) == p
    with pytest.raises(ValueError, match="cannot flatten"):
        InputType.recurrent(7, 11).flat_size
