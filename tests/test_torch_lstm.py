"""The port's LSTM (ops, the recurrence kernels' plain versions, layers,
TextGenLSTM) against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages. Tolerances: float64
1e-12 of each tensor's largest magnitude (the same arithmetic, sums in
another order); float32 1e-5 (the recurrence compounds rounding over
the timesteps; the hoisted ``x @ W_ih`` rounds where JAX's per-step
product does). Sizes are tiny: vocab 12, units 8, T 6.

Also: the C source's entries against the wrappers' ctypes declarations
and the nvcc command, the recurrence's launches (one forward and one
backward recurrence a layer, counted on the plain versions), the launch
plan's invariants (shared memory, blocks a cluster, every unit and row
covered once), the layer rules on rnn input, and what is refused by name.
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
from deeplearning4j_tpu_torch.nn import (ConvLSTM2DLayer, DenseLayer,
                                         GlobalPoolingLayer, InputType,
                                         LastTimeStepLayer, LSTMLayer,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers import BaseLayer
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.zoo import TextGenLSTM

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "lstm_recurrence.cu"
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
    # one step of the recurrence wrappers on the CPU is the cell: gx
    # overwritten by the gates (h0 = 0, so z = gx), None is zero
    gx, zero = torch.tensor(z)[None], torch.zeros(b, u, dtype=c.dtype)
    w_hh = torch.ones(u, 4 * u, dtype=c.dtype)
    out = lstm.lstm_recurrence_fwd(gx, w_hh, zero, torch.tensor(cp))
    assert out[0] is gx and torch.equal(gx[0], gates)
    assert torch.equal(out[1][0], h) and torch.equal(out[2][0], c)
    got = lstm.lstm_recurrence_bwd(gx, c[None], torch.tensor(cp), w_hh,
                                   dc_T=torch.tensor(dc_next))
    want = lstm.lstm_cell_bwd_plain(gates, torch.tensor(cp), c,
                                    dc_next=torch.tensor(dc_next))
    assert torch.equal(got[0][0], want[0]) and torch.equal(got[2], want[1])
    assert torch.equal(got[1], want[0] @ w_hh.t())


def test_the_recurrence_launches_one_cell_a_timestep_and_layer(monkeypatch):
    """One recurrence a layer each way, whatever T: the wrappers' plain
    versions are called once for the forward and once for the backward
    of a 9-step sequence (the card's kernels are one launch each)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = lstm.lstm_recurrence_fwd_plain, lstm.lstm_recurrence_bwd_plain

    def count(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(lstm, "lstm_recurrence_fwd_plain", count("fwd", fwd))
    monkeypatch.setattr(lstm, "lstm_recurrence_bwd_plain", count("bwd", bwd))
    ts = [torch.tensor(a, requires_grad=True)
          for a in _lstm_inputs(np.float32, t=9)]
    out = preg.exec_op("lstm_layer", *ts)
    assert calls == {"fwd": 1, "bwd": 0}
    out[0].sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}
    assert all(t.grad is not None for t in ts)


def test_cell_wrappers_refuse_what_the_kernels_do_not_take():
    gx, w = torch.zeros(3, 2, 8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="c0"):
        lstm.lstm_recurrence_fwd(gx, w, torch.zeros(2, 2), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="gx"):
        lstm.lstm_recurrence_fwd(torch.zeros(3, 2, 7), w, torch.zeros(2, 2),
                                 torch.zeros(2, 2))
    with pytest.raises(ValueError, match="d_hs"):
        lstm.lstm_recurrence_bwd(gx, torch.zeros(3, 2, 2), torch.zeros(2, 2),
                                 w, d_hs=torch.zeros(2, 3, 2))
    with pytest.raises(NotImplementedError, match="queue 2b item 11"):
        lstm.lstm_recurrence_fwd(gx.half(), w.half(),
                                 *(torch.zeros(2, 2).half(),) * 2)
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
    # the engine's source: the LSTM's entries and the other cells'
    # (kernels/recurrence.py declares those)
    assert sorted(lstm.ARGTYPES) == [
        "dl4j_lstm_recurrence_bwd", "dl4j_lstm_recurrence_fwd",
        "dl4j_lstm_recurrence_query"]
    assert sorted(entries) == sorted(lstm.ARGTYPES) + [
        "dl4j_rnn_recurrence_bwd", "dl4j_rnn_recurrence_fwd",
        "dl4j_rnn_recurrence_query"]
    for name, params in ((n, entries[n]) for n in lstm.ARGTYPES):
        assert [n for _, n in params] == [n for n, _ in lstm.ARGTYPES[name]]
        assert [c_types[t] for t, _ in params] == \
            [t for _, t in lstm.ARGTYPES[name]]


def test_loading_the_library_declares_both_entries(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    lib = types.SimpleNamespace(**{name: Entry() for name in lstm.ARGTYPES})
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert lstm._lib() is lib
    for name, args in lstm.ARGTYPES.items():
        assert getattr(lib, name).argtypes == [t for _, t in args]


def test_nvcc_command_builds_the_source_for_sm90a():
    out = _cuda.library_path("lstm_recurrence")
    cmd = _cuda.build_command("lstm_recurrence", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[cmd.index("-I") + 1] == str(SRC.parent)
    assert cmd[-1] == str(SRC)
    assert not (SRC.parent / "lstm_cell.cu").exists()
    code = "\n".join(line.split("//")[0]
                     for line in SRC.read_text().splitlines())
    # what the source compiles: itself and the shared header it includes
    both = code + "\n".join(
        line.split("//")[0]
        for line in (SRC.parent / "sm90.cuh").read_text().splitlines())
    # two persistent kernels each way (resident and streamed), launched as
    # clusters with the cluster size past 8 allowed; the exchange through
    # distributed shared memory (the streamed form's through L2, read past
    # L1) and the cluster barrier; the float32 product in 3xTF32 on
    # mma.sync (the shared header's), no atomics and no library kernel
    for want in ("lstm_recurrence_fwd_kernel(const FwdArgs<T> a)",
                 "lstm_recurrence_bwd_kernel(const BwdArgs<T> a)",
                 "lstm_stream_fwd_kernel(const FwdArgs<T> a)",
                 "lstm_stream_bwd_kernel(const BwdArgs<T> a)", "__ldcg(",
                 "cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "cudaFuncAttributeNonPortableClusterSizeAllowed",
                 "cudaOccupancyMaxActiveClusters", "mapa.shared::cluster",
                 "st.shared::cluster", "barrier.cluster.arrive.release",
                 "barrier.cluster.wait.acquire", "cp.async.ca.shared.global",
                 "mma_tf32(", "tf32_split(", "fwd_t<float>", "fwd_t<double>",
                 "bwd_t<float>", "bwd_t<double>"):
        assert want in both, want
    assert "atomic" not in both.lower()
    for lib in ("cublas", "cudnn", "cutlass", "#include <torch"):
        assert lib not in both.lower()
    assert re.findall(r"#include <(\S+)>", code) == [
        "cuda_runtime.h", "math.h", "stdint.h", "initializer_list", "mutex",
        "set", "type_traits"]
    assert re.findall(r'#include "(\S+)"', code) == ["sm90.cuh"]


# ----------------------------------------------------------------------
# the recurrence's plain versions (what the CUDA kernels compute) against
# JAX's lstm_layer and its vjp
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b,t,u", [(3, 1, 5), (3, 7, 37), (4, 9, 16)])
@pytest.mark.parametrize("given", ["all", "d_hs", "dh_T,dc_T"])
def test_recurrence_plain_versions_match_jax_lstm_layer_and_its_vjp(
        dtype, b, t, u, given):
    """The forward from gx = x @ W_ih + b, then the backward from the
    output gradients ``given`` (the others absent: None), and dx, dh0,
    dc0, dW_ih, dW_hh and db made from its dz as ``kernels/_sequence.py``
    makes them, against ``jax.vjp`` of the JAX op."""
    n_in = 6
    arrs = _lstm_inputs(dtype, seed=b * t + u, b=b, t=t, n_in=n_in, u=u)
    jfn = jreg.get_op("lstm_layer").fn
    jouts, vjp = jax.vjp(jfn, *map(jnp.asarray, arrs))
    rng = np.random.default_rng(11)
    cot = {"d_hs": rng.normal(size=(b, t, u)).astype(dtype),
           "dh_T": rng.normal(size=(b, u)).astype(dtype),
           "dc_T": rng.normal(size=(b, u)).astype(dtype)}
    if given != "all":
        cot = {k: (v if k in given.split(",") else None)
               for k, v in cot.items()}
    jgrads = vjp(tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c)
                       for o, c in zip(jouts, cot.values())))
    x, h0, c0, w_ih, w_hh, bias = map(torch.tensor, arrs)
    x2 = x.transpose(0, 1).reshape(t * b, n_in)
    gx = torch.addmm(bias, x2, w_ih).view(t, b, 4 * u)
    gates, hs, cs = lstm.lstm_recurrence_fwd_plain(gx, w_hh, h0, c0)
    for got, want in zip((hs.transpose(0, 1), hs[-1], cs[-1]), jouts):
        _close(got, want, TOL[dtype])
    d_hs = cot["d_hs"]
    dz, dh0, dc0 = lstm.lstm_recurrence_bwd_plain(
        gates, cs, c0, w_hh,
        None if d_hs is None else torch.tensor(d_hs).transpose(0, 1),
        *(None if cot[k] is None else torch.tensor(cot[k])
          for k in ("dh_T", "dc_T")))
    dz2 = dz.reshape(t * b, 4 * u)
    h_prev = torch.cat([h0[None], hs[:-1]]).reshape(t * b, u)
    grads = ((dz2 @ w_ih.t()).view(t, b, n_in).transpose(0, 1), dh0, dc0,
             x2.t() @ dz2, h_prev.t() @ dz2, dz2.sum(0))
    for got, want in zip(grads, jgrads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b", [1, 3, 8, 32, 100, 1000])
@pytest.mark.parametrize("u", [1, 5, 16, 37, 100, 256, 300, 512, 1024,
                               4096, 20000])
def test_launch_plan_covers_every_unit_and_row_once_within_shared_memory(
        u, b, itemsize):
    plan = lstm.recurrence_plan(b, u, itemsize)
    assert max(plan.smem_fwd, plan.smem_bwd) <= lstm.SMEM_LIMIT == 232448
    assert 1 <= plan.ranks <= min(u, 16)
    assert plan.n_tiles in lstm.N_TILES
    units = [list(r) for r in plan.block_units(u)]
    assert all(units) and sum(units, []) == list(range(u))
    rows = [list(r) for r in plan.cluster_rows(b)]
    assert all(rows) and sum(rows, []) == list(range(b))
    # resident exactly where both directions fit with the slice
    fit = max(lstm.recurrence_geometry(u, plan.ranks, 1, True, itemsize))
    assert plan.resident == (fit <= lstm.SMEM_LIMIT)
    assert (plan.smem_fwd, plan.smem_bwd) == lstm.recurrence_geometry(
        u, plan.ranks, plan.n_tiles, plan.resident, itemsize)


def test_launch_plan_of_textgen_and_of_a_width_past_the_resident_slice():
    """TextGenLSTM's layer (32 rows, 256 units, float32): 16 blocks of 16
    units, the 64 KiB slice resident (99,968 / 97,792 bytes a block at
    8 rows a cluster); 512 float32 units take the streamed form; the
    batch tile grows only where the card cannot hold the clusters."""
    p = lstm.recurrence_plan(32, 256, 4)
    assert (p.ranks, p.units, p.resident, p.n_tiles, p.clusters) == \
        (16, 16, True, 1, 4)
    assert (p.smem_fwd, p.smem_bwd) == (99968, 97792)
    assert not lstm.recurrence_plan(8, 512, 4).resident
    assert lstm.recurrence_plan(8, 512, 4).ranks == 16
    assert lstm.recurrence_plan(32, 256, 8).resident
    for limit, tiles in ((4, 1), (2, 2), (1, 4), (0, 4)):
        p = lstm.recurrence_plan(32, 256, 4, lambda r, nt, res: limit)
        assert (p.n_tiles, p.clusters, p.max_clusters) == \
            (tiles, 4 // tiles, limit)
    # the streamed form takes any width, one tile of 8 rows a cluster, its
    # shared memory the warps' partial products alone
    for u, itemsize in ((2048, 4), (2048, 8), (4096, 4), (1 << 20, 8)):
        p = lstm.recurrence_plan(20, u, itemsize)
        assert (p.ranks, p.units, p.resident, p.n_tiles, p.clusters) == \
            (16, u // 16, False, 1, 3)
        assert (p.smem_fwd, p.smem_bwd) == (2048 * itemsize, 1024 * itemsize)
        p = lstm.recurrence_plan(20, u, itemsize, lambda r, nt, res: 1)
        assert (p.n_tiles, p.clusters) == (1, 3)


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
    # SimpleRnnLayer and Bidirectional are ported (tests/test_torch_
    # recurrent.py); the convolutional LSTM and the VAE are not
    (lambda: BaseLayer.from_json({"@class": "ConvLSTM2DLayer"}),
     "queue 1 item 10"),
    (lambda: BaseLayer.from_json({"@class": "VariationalAutoencoderLayer",
                                  "n_out": 4}), "queue 1 item 10"),
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
