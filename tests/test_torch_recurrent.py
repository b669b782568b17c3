"""The port's recurrent family (GRU, peephole LSTM, simple RNN,
``Bidirectional``, ``reverse``) against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages. Tolerances, relative to
each tensor's largest magnitude: float64 1e-10 (the same arithmetic, sums
in another order, compounded over the timesteps); float32 1e-5 (the
hoisted ``x @ W_ih`` rounds where JAX's per-step product does). Sizes are
tiny: U <= 16, T <= 12, B <= 5.

Also: the kernels' plain versions against the ops' ``jax.vjp``, the C
source's entries (the LSTM's cluster engine, ``csrc/lstm_recurrence.cu``)
against the wrappers' ctypes declarations and the nvcc command, the
source's invariants (every cell an instantiation of the engine's kernels,
3xTF32 products, DSMEM pushes, no atomics, the cluster barrier a step),
the launch plan and its shared memory against the C side's ``RecGeo``
(compiled for the host), the launches a layer (counted on the
plain versions), the layers in a ``MultiLayerNetwork`` and a
``ComputationGraph`` from the JAX weights (output, gradients, 3 Adam
steps), ``fit_tbptt`` through GRU and ``Bidirectional`` (whose backward
direction carries no state), and what is refused by name.
"""
import ctypes
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers_ext import GravesLSTMLayer as JGraves
from deeplearning4j_tpu.nn.layers_ext import GRULayer as JGRU
from deeplearning4j_tpu.nn.recurrent_layers import Bidirectional as JBidir
from deeplearning4j_tpu.nn.recurrent_layers import \
    LastTimeStepLayer as JLast
from deeplearning4j_tpu.nn.recurrent_layers import \
    RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.recurrent_layers import \
    SimpleRnnLayer as JSimple
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.convert import (params_from_jax,
                                              samediff_arrays_from_jax)
from deeplearning4j_tpu_torch.kernels import _cuda, _sequence, lstm, recurrence
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (Bidirectional, ComputationGraph,
                                         ConvLSTM2DLayer, GravesLSTMLayer,
                                         GRULayer, InputType,
                                         LastTimeStepLayer, LSTMLayer,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         RnnOutputLayer, SimpleRnnLayer)
from deeplearning4j_tpu_torch.ops import registry as preg

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "lstm_recurrence.cu"
TOL = {np.float32: 1e-5, np.float64: 1e-10}
ACTS = ["tanh", "relu", "sigmoid", "identity", "leaky_relu", "hard_tanh",
        "softsign"]


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _inputs(op, dtype, seed=0, b=4, t=7, n_in=5, u=6):
    rng = np.random.default_rng(seed)
    shapes = {
        "gru_layer": [(b, t, n_in), (b, u), (n_in, 3 * u), (u, 3 * u),
                      (3 * u,), (3 * u,)],
        "simple_rnn_layer": [(b, t, n_in), (b, u), (n_in, u), (u, u), (u,)],
        "graves_lstm_layer": [(b, t, n_in), (b, u), (b, u), (n_in, 4 * u),
                              (u, 4 * u), (3, u), (4 * u,)],
    }[op]
    return [rng.normal(0, 0.7, s).astype(dtype) for s in shapes]


def _op_case(op, dtype, attrs, seed=0, **sizes):
    arrs = _inputs(op, dtype, seed, **sizes)
    if attrs.get("time_major"):
        arrs[0] = np.ascontiguousarray(np.swapaxes(arrs[0], 0, 1))
    jfn = jreg.get_op(op).fn
    pfn = preg.get_op(op).fn
    jouts = jfn(*map(jnp.asarray, arrs), **attrs)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    pouts = pfn(*ts, **attrs)
    for p, j in zip(pouts, jouts):
        _close(p, j, TOL[dtype])
    w = [np.random.default_rng(9).normal(size=np.shape(o)).astype(dtype)
         for o in jouts]

    def jloss(*a):
        o = jfn(*a, **attrs)
        return sum(jnp.sum(oi * wi) for oi, wi in zip(o, w))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(arrs))))(
        *map(jnp.asarray, arrs))
    ploss = sum((o * torch.tensor(wi)).sum() for o, wi in zip(pouts, w))
    pgrads = torch.autograd.grad(ploss, ts)
    for p, j in zip(pgrads, jgrads):
        _close(p, j, TOL[dtype])


# ----------------------------------------------------------------------
# the ops
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("time_major", [False, True])
def test_gru_layer_forward_and_every_gradient_match_jax(dtype, time_major):
    _op_case("gru_layer", dtype, {"time_major": time_major})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_graves_lstm_layer_forward_and_every_gradient_match_jax(
        dtype, return_sequences):
    _op_case("graves_lstm_layer", dtype,
             {"return_sequences": return_sequences}, seed=3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("act", ACTS)
def test_simple_rnn_layer_each_activation_matches_jax(dtype, act):
    _op_case("simple_rnn_layer", dtype, {"activation": act}, seed=5)


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "hard_tanh"])
def test_simple_rnn_gradient_at_a_tie_is_the_jax_one(act):
    """Pre-activations exactly on a kink (0, or +-1 for the hard tanh):
    the kernel's plain derivative takes JAX's side of the tie."""
    x = np.zeros((2, 3, 2))
    x[0, :, 0] = 1.0 if act == "hard_tanh" else 0.0
    x[1, :, 0] = -1.0 if act == "hard_tanh" else 0.0
    arrs = [x, np.zeros((2, 2)), np.eye(2), np.zeros((2, 2)), np.zeros(2)]
    jfn, pfn = jreg.get_op("simple_rnn_layer").fn, \
        preg.get_op("simple_rnn_layer").fn
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a, activation=act)[0]),
                  argnums=0)(*map(jnp.asarray, arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    pg, = torch.autograd.grad(pfn(*ts, activation=act)[0].sum(), ts[:1])
    assert np.array_equal(pg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("op,attrs", [
    ("gru_cell", {}), ("simple_rnn_cell", {"activation": "tanh"}),
    ("graves_lstm_cell", {})])
def test_cell_ops_match_jax(op, attrs):
    layer = op.replace("_cell", "_layer")
    arrs = _inputs(layer, np.float64, seed=2)
    arrs[0] = arrs[0][:, 0]
    j = jreg.get_op(op).fn(*map(jnp.asarray, arrs), **attrs)
    p = preg.get_op(op).fn(*map(torch.tensor, arrs), **attrs)
    for a, b in zip(p if isinstance(p, tuple) else (p,),
                    j if isinstance(j, tuple) else (j,)):
        _close(a, b, 1e-12)


def test_reverse_matches_jax():
    a = np.arange(24.0).reshape(2, 3, 4)
    for axis in (1, (1,), (0, 2)):
        for name in ("reverse", "flip"):
            assert np.array_equal(
                preg.get_op(name).fn(torch.tensor(a), axis).numpy(),
                np.asarray(jreg.get_op(name).fn(jnp.asarray(a), axis)))


# ----------------------------------------------------------------------
# the kernels' plain versions against the ops' vjp
def _time_major(a):
    return torch.tensor(np.ascontiguousarray(np.swapaxes(a, 0, 1)))


@pytest.mark.parametrize("cell", ["gru", "graves", "simple"])
def test_plain_recurrence_is_the_op_and_its_vjp(cell):
    op = {"gru": "gru_layer", "graves": "graves_lstm_layer",
          "simple": "simple_rnn_layer"}[cell]
    arrs = _inputs(op, np.float64, seed=11, b=3, t=9, u=5)
    if cell == "graves":
        x, h0, c0, w_ih, w_hh, wp, b = arrs
    elif cell == "gru":
        x, h0, w_ih, w_hh, b, b_hh = arrs
    else:
        x, h0, w_ih, w_hh, b = arrs
    gx = torch.tensor(np.einsum("bti,ig->tbg", x, w_ih) + b)
    kw = {"c0": torch.tensor(c0), "w_peep": torch.tensor(wp)} \
        if cell == "graves" else {}
    if cell == "gru":
        kw["b_hh"] = torch.tensor(b_hh)
    saved, hs, cs, hn = recurrence.recurrence_fwd_plain(
        cell, gx, torch.tensor(w_hh), torch.tensor(h0), **kw)
    jouts = jreg.get_op(op).fn(*map(jnp.asarray, arrs))
    _close(hs.transpose(0, 1), jouts[0], 1e-12)
    # the backward of d_hs and dh_T against the op's vjp in x
    rng = np.random.default_rng(4)
    d_hs = rng.normal(size=hs.shape)
    dh_t = rng.normal(size=h0.shape)
    dz, dzh, dh0, dc0 = recurrence.recurrence_bwd_plain(
        cell, saved, hs, cs, hn, torch.tensor(h0), kw.get("c0"),
        torch.tensor(w_hh), kw.get("w_peep"), torch.tensor(d_hs),
        torch.tensor(dh_t))
    _, vjp = jax.vjp(lambda xx, hh: jreg.get_op(op).fn(
        xx, hh, *map(jnp.asarray, arrs[2:]))[:2] if cell != "graves" else
        jreg.get_op(op).fn(xx, hh, *map(jnp.asarray, arrs[2:]))[:2],
        jnp.asarray(x), jnp.asarray(h0))
    jdx, jdh0 = vjp((jnp.asarray(np.swapaxes(d_hs, 0, 1)),
                     jnp.asarray(dh_t)))
    _close(torch.einsum("tbg,ig->bti", dz, torch.tensor(w_ih)), jdx, 1e-12)
    _close(dh0, jdh0, 1e-12)


def test_launches_one_forward_and_one_backward_a_layer():
    recurrence.reset_launches()
    arrs = [torch.tensor(a, requires_grad=True)
            for a in _inputs("gru_layer", np.float64)]
    out, _ = preg.get_op("gru_layer").fn(*arrs)
    out.sum().backward()
    # the plain versions on the CPU count nothing: the kernels do
    assert all(v == 0 for v in recurrence.LAUNCHES.values())
    assert set(recurrence.LAUNCHES) == {
        f"{c}_recurrence_{d}" for c in ("gru", "graves", "simple")
        for d in ("fwd", "bwd")}


# ----------------------------------------------------------------------
# the C source
def _c_entries():
    src = SRC.read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = [a.split()[-1].lstrip("*")
                           for a in m.group(2).split(",")]
    return out


def test_ctypes_declarations_match_the_c_entries():
    entries = _c_entries()
    # the engine's source holds the LSTM's entries and these
    assert set(entries) == set(recurrence.ARGTYPES) | set(lstm.ARGTYPES)
    assert recurrence._LIB == lstm._LIB == "lstm_recurrence"
    for name, args in recurrence.ARGTYPES.items():
        assert [n for n, _ in args] == entries[name], name
    src = SRC.read_text()
    for name, args in recurrence.ARGTYPES.items():
        sig = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)',
                        src).group(1)
        for (n, ty), decl in zip(args, sig.split(",")):
            want = {ctypes.c_void_p: "*", ctypes.c_int64: "int64_t",
                    ctypes.c_int: "int"}[ty]
            assert want in decl, (name, n, decl)


def _body(code, head):
    """The text of the function or struct whose definition starts with
    ``head``, to its closing brace."""
    i = code.index(head)
    i = code.index("{", i)
    depth = 0
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[i:j + 1]
    raise AssertionError(head)


def test_source_invariants():
    src = SRC.read_text()
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    # what the source compiles: itself and the shared header it includes
    header = "\n".join(
        l.split("//")[0]
        for l in (SRC.parent / "sm90.cuh").read_text().splitlines())
    both = code + header
    # one engine: the first design's source is gone, and every cell's
    # kernels are the engine's resident and streamed bodies over the cell
    assert not (SRC.parent / "rnn_recurrence.cu").exists()
    for cell, c in (("lstm", "kLstm"), ("gru", "kGru"),
                    ("graves", "kGraves"), ("simple", "kSimple")):
        for d, args in (("fwd", "FwdArgs"), ("bwd", "BwdArgs")):
            assert re.search(
                rf"{cell}_recurrence_{d}_kernel\(const {args}<T> a\) \{{"
                rf"\s*resident_{d}<{c}, T, NT>\(a\);", code), (cell, d)
            assert re.search(
                rf"{cell}_stream_{d}_kernel\(const {args}<T> a\) \{{"
                rf"\s*stream_{d}<{c}>\(a\);", code), (cell, d)
    # the float32 product of every cell 3xTF32 on mma.sync: both bodies
    # run the products, whose float32 k steps are mma_tf32 on split pieces
    for body, product in (("resident_fwd", "fwd_product<"),
                          ("stream_fwd", "fwd_product<"),
                          ("resident_bwd", "bwd_product<"),
                          ("stream_bwd", "bwd_product<")):
        assert product in _body(code, f"void {body}("), body
    for step, product in (("fwd_kstep", "fwd_product"),
                          ("bwd_kstep", "bwd_product")):
        assert _body(code, f"void {product}(").count(f"{step}<") == 2
        k = _body(code, f"void {step}(")
        assert k.count("mma_tf32(") == 3 and "tf32_split" in k
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    # the exchange: h_t (the backward's partial dh) pushed through
    # distributed shared memory, one cluster barrier a step; the first
    # design's L2 exchange gone (__ldcg only in the streamed form's
    # operand)
    for body, push in (("resident_fwd", "push_rows<"),
                       ("resident_bwd", "st_peer(peer(")):
        b = _body(code, f"void {body}(")
        assert push in b and b.count("cluster_arrive();") == 2
        assert "__ldcg" not in b
    assert "st.shared::cluster" in code and "mapa.shared::cluster" in code
    assert code.count("__ldcg(") == 1 and "__ldcg(" in _body(
        code, "struct GlobalTile")
    assert "ld_l2" not in code and "stage_rows" not in code
    assert "atomic" not in both.lower()     # sums in a fixed order
    assert '#include "sm90.cuh"' in src
    assert "barrier.cluster.arrive.release" in both
    assert "barrier.cluster.wait.acquire" in both
    assert code.count("cluster_wait();") >= 3
    cmd = _cuda.build_command(recurrence._LIB, "/tmp/x.so", "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/lstm_recurrence.cu")
    assert "-I" in cmd


_C_CELLS = {"lstm": "kLstm", "gru": "kGru", "graves": "kGraves",
            "simple": "kSimple"}


@pytest.fixture(scope="module")
def c_geometry(tmp_path_factory):
    """The C side's ``RecGeo`` shared memory (bytes, forward and backward)
    at (cell, U, R, tiles, itemsize): the source's geometry (its constants,
    ``Traits``, ``Lay`` and ``RecGeo``) compiled for the host with the C++
    compiler, the CUDA qualifiers defined away."""
    src = SRC.read_text()
    part = src[src.index("constexpr int kWarps"):
               src.index("template <typename T>\nstruct FwdArgs")]
    cases = [(c, u, r, nt, it) for c in _C_CELLS
             for u in (1, 5, 16, 24, 100, 256, 384, 512, 4096)
             for r in sorted({1, min(u, 7), min(u, 16)})
             for nt in (1, 2, 4) for it in (4, 8)]
    calls = "\n".join(
        f"  show<{_C_CELLS[c]}>({u}, {r}, {nt}, {it});"
        for c, u, r, nt, it in cases)
    prog = ("#include <stdint.h>\n#include <stdio.h>\n#define __host__\n"
            "#define __device__\n#define __forceinline__ inline\n"
            "namespace {\n" + part + "\n}\n"
            "template <int C> void show(int u, int r, int nt, int it) {\n"
            "  RecGeo<C> g(u, r, nt, it);\n"
            "  printf(\"%lld %lld\\n\", (long long)(g.fwd_elems(nt) * it),"
            " (long long)(g.bwd_elems(r) * it));\n}\n"
            "int main() {\n" + calls + "\n}\n")
    d = tmp_path_factory.mktemp("recgeo")
    (d / "g.cpp").write_text(prog)
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++17", "-o", str(d / "g"), str(d / "g.cpp")],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(d / "g")], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split("\n")
    return {k: tuple(map(int, line.split())) for k, line in zip(cases, out)}


@pytest.mark.parametrize("cell", ["gru", "graves", "simple"])
@pytest.mark.parametrize("u", [1, 5, 16, 100, 256, 384, 512, 4096])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_plan_covers_every_unit_and_fits(cell, u, itemsize,
                                                c_geometry):
    plan = recurrence.recurrence_plan(cell, 64, u, itemsize)
    assert 1 <= plan.ranks <= recurrence.MAX_RANKS
    assert (plan.ranks - 1) * plan.units < u <= plan.ranks * plan.units
    assert plan.clusters == 8 and plan.n_tiles == 1
    assert max(plan.smem_fwd, plan.smem_bwd) <= recurrence.SMEM_LIMIT
    if u <= 256:
        assert plan.resident
    if u >= 512 and itemsize == 4 and cell != "simple":
        assert not plan.resident
    # the Python geometry is the C RecGeo's arithmetic (G = 3, 4 and 1;
    # the LSTM's G = 4 beside it), at every split and batch tile
    for c in (cell, "lstm"):
        for (cc, uu, r, nt, it), want in c_geometry.items():
            if cc == c and uu == u and it == itemsize:
                assert _sequence.recurrence_geometry(
                    c, u, r, nt, True, it) == want, (c, u, r, nt, it)
    # the batch tile grows where the card cannot hold the clusters
    if plan.resident:
        p2 = recurrence.recurrence_plan(cell, 64, u, itemsize,
                                        lambda r, nt, res: 7 if nt == 1 else 4)
        fits2 = max(recurrence.recurrence_geometry(
            cell, u, plan.ranks, 2, True, itemsize)) <= \
            recurrence.SMEM_LIMIT
        assert p2.n_tiles == (2 if fits2 else 1)


def test_what_the_kernels_do_not_take_is_refused_by_name():
    arrs = [torch.tensor(a) for a in _inputs("simple_rnn_layer",
                                             np.float64)]
    with pytest.raises(NotImplementedError, match="queue 2b item 14"):
        preg.get_op("simple_rnn_layer").fn(*arrs, activation="elu")
    half = [a.to(torch.bfloat16) for a in arrs]
    with pytest.raises(NotImplementedError, match="queue 2b item 11"):
        preg.get_op("simple_rnn_layer").fn(*half)
    with pytest.raises(ValueError, match="unknown rnn activation"):
        preg.get_op("simple_rnn_layer").fn(*arrs, activation="nope")


# ----------------------------------------------------------------------
# the layers in both network kinds, from the same seed's weights
import deeplearning4j_tpu.nn as jax_nn  # noqa: E402
import deeplearning4j_tpu_torch.nn as port_nn  # noqa: E402

F, T_, B_, U_ = 5, 6, 4, 7


def _layer(nn, kind, mode="CONCAT", seq=True):
    """A recurrent layer of either package by kind."""
    if kind == "gru":
        return nn.GRULayer(n_out=U_, return_sequences=seq)
    if kind == "graves":
        return nn.GravesLSTMLayer(n_out=U_, return_sequences=seq)
    if kind == "simple":
        return nn.SimpleRnnLayer(n_out=U_, activation="tanh",
                                 return_sequences=seq)
    if kind == "lstm":
        return nn.LSTMLayer(n_out=U_, return_sequences=seq)
    inner = kind.split("_", 1)[1]
    return nn.Bidirectional(layer=_layer(nn, inner, seq=seq), mode=mode)


def _jnn():
    from deeplearning4j_tpu.nn import layers_ext, recurrent_layers
    ns = type("J", (), {})()
    for mod in (jax_nn, layers_ext, recurrent_layers):
        for k in dir(mod):
            if not k.startswith("_"):
                setattr(ns, k, getattr(mod, k))
    return ns


def _mln_conf(nn, adam, kind, mode, seq):
    head = [nn.RnnOutputLayer(n_out=3)] if seq else \
        [nn.OutputLayer(n_out=3)]
    b = (nn.NeuralNetConfiguration.builder().seed(7)
         .updater(adam(learning_rate=0.05)).list()
         .layer(_layer(nn, kind, mode, seq)))
    for h in head:
        b = b.layer(h)
    conf = b.set_input_type(nn.InputType.recurrent(F, T_)).build()
    conf.dtype = "float64"
    return conf


def _data(seq, seed=0, b=B_):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T_, F))
    y = np.eye(3)[rng.integers(0, 3, (b, T_) if seq else (b,))]
    return x, y


RNN_KINDS = ["gru", "graves", "simple", "bi_lstm", "bi_gru", "bi_simple"]


@pytest.mark.parametrize("kind,mode,seq", [
    ("gru", "CONCAT", True), ("graves", "CONCAT", True),
    ("simple", "CONCAT", False), ("gru", "CONCAT", False),
    ("bi_lstm", "CONCAT", True), ("bi_gru", "ADD", True),
    ("bi_simple", "MUL", True), ("bi_gru", "AVERAGE", False),
    ("bi_graves", "CONCAT", False), ("bi_lstm", "AVERAGE", True)])
def test_layers_in_a_multilayer_network_match_jax(kind, mode, seq):
    """The same seed's weights on both sides; the output; then 3 Adam
    steps (every parameter and the losses)."""
    jconf = _mln_conf(_jnn(), JAdam, kind, mode, seq)
    pconf = _mln_conf(port_nn, Adam, kind, mode, seq)
    jnet, pnet = JMLN(jconf).init(), MultiLayerNetwork(pconf).init(
        device="cpu")
    w = jnet.params()
    assert set(pnet.params()) == set(w)
    for n, a in w.items():
        assert np.array_equal(pnet.params()[n], np.asarray(a)), n
    x, y = _data(seq)
    _close(pnet.output(x), np.asarray(jnet.output(x).to_numpy()
                                      if hasattr(jnet.output(x), "to_numpy")
                                      else jnet.output(x)), 1e-10)
    jh = jnet.fit(x, y, epochs=3, batch_size=B_)
    ph = pnet.fit(x, y, epochs=3, batch_size=B_)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=1e-6)     # each step's loss in float32
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a, 1e-9)


def _graph_conf(nn, adam, kind, mode):
    g = (nn.NeuralNetConfiguration.builder().seed(9)
         .updater(adam(learning_rate=0.05)).graph_builder()
         .add_inputs("in")
         .set_input_types(nn.InputType.recurrent(F, T_))
         .add_layer("r1", _layer(nn, kind, mode, True), "in")
         .add_layer("r2", _layer(nn, "gru"), "in"))
    g = (g.add_vertex("m", nn.MergeVertex(), "r1", "r2")
         .add_vertex("sub", nn.SubsetVertex(from_idx=1, to_idx=U_), "m")
         .add_vertex("dot", nn.DotProductVertex(normalize=True), "sub",
                     "r2")
         .add_vertex("m2", nn.MergeVertex(), "sub", "dot"))
    g = (g.add_layer("last", nn.LastTimeStepLayer(), "m2")
         .add_layer("out", nn.OutputLayer(n_out=3), "last")
         .set_outputs("out"))
    conf = g.build()
    conf.dtype = "float64"
    return conf


@pytest.mark.parametrize("kind,mode", [
    ("gru", "CONCAT"), ("graves", "CONCAT"), ("simple", "CONCAT"),
    ("lstm", "CONCAT"), ("bi_lstm", "CONCAT"), ("bi_gru", "ADD"),
    ("bi_simple", "MUL"), ("bi_graves", "AVERAGE")])
def test_layers_and_rnn_vertices_in_a_graph_match_jax(kind, mode):
    """A graph of recurrent layers and vertices on rnn input (merge,
    subset, dot product on the feature axis 2), LastTimeStep and a
    softmax head: the same seed's weights, every vertex's value, then 3
    Adam steps; the weights also through ``params_from_jax``."""
    jconf = _graph_conf(_jnn(), JAdam, kind, mode)
    pconf = _graph_conf(port_nn, Adam, kind, mode)
    jconf.cnn_data_format = "NCHW"
    jnet, pnet = JCG(jconf).init(), ComputationGraph(pconf).init(
        device="cpu")
    w = jnet.params()
    assert set(pnet.params()) == set(w)
    for n, a in w.items():
        assert np.array_equal(pnet.params()[n], np.asarray(a)), n
    # the weights carried across by name
    pnet.model.load_state_dict(params_from_jax(
        {n: np.asarray(a) for n, a in w.items()}))
    x, y = _data(False, seed=3)
    ff_p, ff_j = pnet.feed_forward(x), jnet.feed_forward(x)
    for n, v in ff_j.items():
        _close(ff_p[n], np.asarray(v.to_numpy() if hasattr(v, "to_numpy")
                                   else v), 1e-10)
    jh = jnet.fit(x, y, epochs=3, batch_size=B_)
    ph = pnet.fit(x, y, epochs=3, batch_size=B_)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=1e-6)     # each step's loss in float32
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a, 1e-9)


def test_a_dense_layer_on_cnn_input_in_a_graph_flattens_as_jax():
    """The JAX graph flattens a cnn input before a layer that wants ff
    (``_adapt_input``, NCHW order in its NCHW layout); so does the port's
    (it raised before)."""
    def conf(nn, sgd):
        c = (nn.NeuralNetConfiguration.builder().seed(2)
             .updater(sgd(learning_rate=0.1)).graph_builder()
             .add_inputs("in")
             .set_input_types(nn.InputType.convolutional(4, 5, 3))
             .add_layer("c", nn.ConvolutionLayer(n_out=2, kernel_size=(3, 3),
                                                 convolution_mode="SAME"),
                        "in")
             .add_layer("d", nn.DenseLayer(n_out=6, activation="tanh"), "c")
             .add_layer("out", nn.OutputLayer(n_out=3), "d")
             .set_outputs("out").build())
        c.dtype = "float64"
        return c
    from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
    from deeplearning4j_tpu_torch.learning import Sgd
    jconf = conf(jax_nn, JSgd)
    jconf.cnn_data_format = "NCHW"
    jnet, pnet = JCG(jconf).init(), ComputationGraph(conf(port_nn, Sgd)).init(
        device="cpu")
    for n, a in jnet.params().items():
        assert np.array_equal(pnet.params()[n], np.asarray(a)), n
    x = np.random.default_rng(1).normal(size=(3, 3, 4, 5))
    _close(pnet.output(x)[0], np.asarray(jnet.output(x)[0]), 1e-12)


# ----------------------------------------------------------------------
# fit_tbptt through the new layers
def _tbptt_conf(nn, adam, kind):
    conf = (nn.NeuralNetConfiguration.builder().seed(5)
            .updater(adam(learning_rate=0.02)).list()
            .layer(_layer(nn, kind, "ADD"))
            .layer(nn.RnnOutputLayer(n_out=3))
            .set_input_type(nn.InputType.recurrent(F, 11)).build())
    return conf


@pytest.mark.parametrize("kind", ["gru", "graves", "bi_lstm", "bi_gru",
                                  "simple"])
def test_fit_tbptt_matches_jax_and_the_backward_direction_carries_nothing(
        kind):
    jnet = JMLN(_tbptt_conf(_jnn(), JAdam, kind)).init()
    pnet = MultiLayerNetwork(_tbptt_conf(port_nn, Adam, kind)).init(
        device="cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 11, F)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 11))]
    jh = jnet.fit_tbptt(x, y, 4, epochs=2, batch_size=4)
    ph = pnet.fit_tbptt(x, y, 4, epochs=2, batch_size=4)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=1e-5)
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a, 1e-5)
    sd, states = pnet._tbptt_graphs[4]
    if kind.startswith("bi_"):
        # only the forward direction keeps state variables
        assert states and all("_fwd_" in s for s in states)
        assert not any("_bwd_" in s for s in states)
    else:
        assert states


def test_configurations_with_the_new_layers_round_trip_json_both_ways():
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu_torch.nn import MultiLayerConfiguration
    for kind in RNN_KINDS:
        jconf = _mln_conf(_jnn(), JAdam, kind, "ADD", True)
        pconf = _mln_conf(port_nn, Adam, kind, "ADD", True)
        assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
        back = MultiLayerConfiguration.from_json(jconf.to_json())
        assert json.loads(back.to_json()) == json.loads(jconf.to_json())
        assert json.loads(JMLC.from_json(pconf.to_json()).to_json()) == \
            json.loads(jconf.to_json())


def test_conv_lstm_is_still_refused_by_name():
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ConvLSTM2DLayer()
