"""The noise ops and layers in the port (``ops/random.py``
``gaussian_noise``, ``gaussian_dropout``, ``alpha_dropout``,
``spatial_dropout``; ``kernels/dropout.py`` ``noise_plain``; the noise
kernel of ``csrc/dropout.cu``; ``nn/noise_layers.py``), on the CPU
through the kernel's plain version.

The port draws with its own generator (``csrc/dropout.cu``'s
Philox4x32-10, keyed by the fit's base seed and the node, counted by the
element group and the iteration), so the draws are held to distribution
tests and to their own
determinism, not to JAX's bits; the functions around the draws are the
JAX ops' (the same formula on the same draws):

- the normals: Box-Muller from the words, in float64 within 4 ulp of a
  numpy float64 evaluation of the formula (torch's and numpy's ``log``,
  ``cos`` and ``sin`` may round a last bit apart, as the card's may), in
  float32 (the kernel's arithmetic for bf16 and float32 outputs) within
  the stated 2^-21 of their magnitude (``NORMAL_PLAIN_REL``); mean 0 and
  variance 1 within 5 standard errors over 2^18 draws; the Bernoulli
  kinds' kept fractions within 5 standard deviations;
- the functions: ``x + s n``, ``x (1 + s n)``, JAX's alpha dropout
  ``a where(keep, x, alpha') + b`` with its constants, and one keep a
  (batch, channel) for spatial dropout (channel axis 1 or -1), in float32
  and float64; alpha dropout keeps a standard normal's mean and variance
  (within 5 standard errors);
- the backwards: ``dy``, ``dy (1 + s n)``, ``where(keep, a dy, 0)`` and
  the spatial mask over ``p`` on ``dy`` (the draws made again);
- the keys: one (seed, iteration, node) one draw; any other a new one;
- the layers: in the training graph only, in a ``MultiLayerNetwork`` and
  a ``ComputationGraph`` (the node index keying each), the same losses
  and weights bit for bit on the per-step, windowed and scanned tiers,
  the JSON the JAX package's both ways;
- the C entry's ctypes declarations against the source.
"""
import ctypes
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch.autodiff import ScoreIterationListener
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.kernels import dropout as dk
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.ops import random as rops

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ["gaussian_noise", "gaussian_dropout", "alpha_dropout",
         "spatial_dropout"]


def _normals_numpy(n, seed, it, node, exact_angle=False):
    """Box-Muller in numpy float64 from the plain words; with
    ``exact_angle`` the sine and cosine of 2 pi u2 vanish exactly at
    quarter turns (the float normals' ``sincospif``), else those of the
    rounded angle ``6.283185307179586 u2`` (the float64 normals')."""
    groups = (n + 3) // 4
    w = dk.words_plain(4 * groups, seed, it, node).numpy().reshape(-1, 4)
    u1 = ((w[:, 0::2] >> 8) + 1).astype(np.float64) * 2.0 ** -24
    u2 = (w[:, 1::2] >> 8).astype(np.float64) * 2.0 ** -24
    rho = np.sqrt(-2.0 * np.log(u1))
    ang = 6.283185307179586 * u2
    cs, sn = np.cos(ang), np.sin(ang)
    if exact_angle:
        quarter = (4 * u2) == np.round(4 * u2)
        cs = np.where(quarter, np.round(np.cos(ang)), cs)
        sn = np.where(quarter, np.round(np.sin(ang)), sn)
    return np.stack([rho * cs, rho * sn], axis=2).reshape(-1)[:n]


def test_normals_are_box_muller_on_the_words():
    got = dk.normals_plain(1001, 5, 3, 2).numpy()
    want = _normals_numpy(1001, 5, 3, 2)
    assert (np.abs(got - want) <= 4 * np.spacing(np.abs(want))).all()
    assert got.dtype == np.float64


@pytest.mark.parametrize("seed,it,node", [(5, 3, 2), (11, 0, 7),
                                          (12345 + (1 << 33), 7, 3)])
def test_float32_normals_are_box_muller_within_the_stated_bound(seed, it,
                                                               node):
    """The float32 normals (the kernel's arithmetic for bf16 and float32
    outputs) against numpy's float64 Box-Muller of the same words, within
    ``NORMAL_PLAIN_REL`` (2^-21, 4 float32 ulp of 1) of each normal's
    magnitude, over 2^18 draws."""
    n = 1 << 18
    got = dk.normals_plain(n, seed, it, node, dtype=torch.float32)
    assert got.dtype == torch.float32
    want = _normals_numpy(n, seed, it, node, exact_angle=True)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= dk.NORMAL_PLAIN_REL * np.abs(want)).all()
    assert dk.NORMAL_PLAIN_REL == 2.0 ** -21
    assert dk.NORMAL_KERNEL_REL == 2.0 ** -20


def test_sincospi_is_exact_at_quarter_turns():
    """The angle's sine and cosine vanish exactly where sin(pi x) and
    cos(pi x) do (as CUDA's sincospif, whose argument is exact), and
    agree with numpy's sin and cos of pi x elsewhere."""
    x = torch.tensor([0.0, 0.5, 1.0, 1.5, 0.25, 1.75, 2.0 ** -23,
                      1 - 2.0 ** -23], dtype=torch.float64)
    sn, cs = dk.sincospi_plain(x)
    assert sn[:4].tolist() == [0.0, 1.0, 0.0, -1.0]
    assert cs[:4].tolist() == [1.0, 0.0, -1.0, 0.0]
    np.testing.assert_allclose(sn.numpy(), np.sin(np.pi * x.numpy()),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(cs.numpy(), np.cos(np.pi * x.numpy()),
                               rtol=1e-15, atol=1e-15)


def test_normals_are_standard():
    n = 1 << 18
    z = dk.normals_plain(n, 11, 0, 7).numpy()
    se = 1 / math.sqrt(n)
    assert abs(z.mean()) < 5 * se
    assert abs(z.var() - 1) < 5 * math.sqrt(2) * se
    assert np.isfinite(z).all()
    # the pair's two normals are independent
    assert abs(np.corrcoef(z[0::2], z[1::2])[0, 1]) < 5 * se * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gaussian_functions_on_their_draws(dtype):
    x = torch.linspace(-2, 2, 37, dtype=dtype).reshape(37)
    # the compute dtype's normals: float32's own arithmetic, not float64's
    # rounded
    n = dk.normals_plain(37, 3, 9, 4, dtype=dtype)
    s = torch.tensor(0.3, dtype=dtype)
    got = dk.noise_plain("gaussian_noise", x, 3, 9, 4, stddev=0.3)
    assert torch.equal(got, x + s * n)
    got = dk.noise_plain("gaussian_dropout", x, 3, 9, 4, stddev=0.3)
    assert torch.equal(got, x * (1 + s * n))
    assert got.dtype == dtype


@pytest.mark.parametrize("p", [0.5, 0.8, 0.95])
def test_alpha_dropout_is_the_jax_formula_on_its_mask(p):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(64, 33)))
    keep = dk.keep_mask_plain(x.numel(), 1, 2, 3, p).reshape(x.shape)
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    a = (p + alpha_p ** 2 * p * (1 - p)) ** -0.5
    b = -a * alpha_p * (1 - p)
    want = a * np.where(keep.numpy(), x.numpy(), alpha_p) + b
    got = dk.noise_plain("alpha_dropout", x, 1, 2, 3, p=p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_alpha_dropout_keeps_a_standard_normals_moments():
    n = 1 << 18
    x = torch.tensor(np.random.default_rng(1).normal(size=n))
    y = dk.noise_plain("alpha_dropout", x, 4, 0, 1, p=0.9).numpy()
    se = 1 / math.sqrt(n)
    assert abs(y.mean()) < 6 * se
    assert abs(y.var() - 1) < 6 * math.sqrt(2) * se * 2


@pytest.mark.parametrize("shape,axis", [((6, 5, 4, 3), 1), ((6, 7, 9), -1),
                                        ((6, 3, 4, 8), -1)])
def test_spatial_dropout_draws_once_a_batch_and_channel(shape, axis):
    x = torch.ones(shape, dtype=torch.float64)
    y = dk.noise_plain("spatial_dropout", x, 2, 5, 6, p=0.6,
                       channel_axis=axis).numpy()
    c = shape[axis]
    ya = np.moveaxis(y, axis, -1).reshape(shape[0], -1, c)
    # each (batch, channel) kept or dropped whole
    assert (ya == ya[:, :1, :]).all()
    keep = dk.keep_mask_plain(shape[0] * c, 2, 5, 6, 0.6).reshape(
        shape[0], c).numpy()
    np.testing.assert_array_equal(ya[:, 0, :], np.where(keep, 1 / 0.6, 0.0))


@pytest.mark.parametrize("kind,p", [("alpha_dropout", 0.8),
                                    ("spatial_dropout", 0.7)])
def test_kept_fraction(kind, p):
    n = 1 << 16
    keep = dk.keep_mask_plain(n, 9, 1, 2, p).numpy()
    sd = math.sqrt(n * p * (1 - p))
    assert abs(keep.sum() - n * p) < 5 * sd


@pytest.mark.parametrize("kind", KINDS)
def test_draws_follow_seed_iteration_and_node(kind):
    x = torch.tensor(np.random.default_rng(2).normal(size=(8, 4, 6)))
    kw = {"p": 0.5, "stddev": 0.5}
    base = dk.noise_plain(kind, x, 1, 2, 3, **kw)
    assert torch.equal(base, dk.noise_plain(kind, x, 1, 2, 3, **kw))
    for other in ((2, 2, 3), (1, 3, 3), (1, 2, 4), (1 + (1 << 33), 2, 3)):
        assert not torch.equal(base, dk.noise_plain(kind, x, *other, **kw))


def _scope(seed=3, it=7):
    return rops.rng_scope(*rops.host_rng(seed, it, "cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_backward_draws_again(kind):
    x = torch.tensor(np.random.default_rng(3).normal(size=(5, 4, 6)),
                     requires_grad=True)
    dy = torch.tensor(np.random.default_rng(4).normal(size=(5, 4, 6)))
    attrs = {"gaussian_noise": {"stddev": 0.4},
             "gaussian_dropout": {"rate": 0.3},
             "alpha_dropout": {"p": 0.8},
             "spatial_dropout": {"p": 0.7}}[kind]
    with _scope():
        y = getattr(rops, kind)(x, node=5, **attrs)
    dx, = torch.autograd.grad(y, x, dy)
    if kind == "gaussian_noise":
        want = dy
    elif kind == "gaussian_dropout":
        s = (0.3 / 0.7) ** 0.5
        want = dy * (1 + s * dk.normals_plain(dy.numel(), 3, 7, 5).reshape(
            dy.shape))
    elif kind == "alpha_dropout":
        a = dk.alpha_constants(0.8)[0]
        keep = dk.keep_mask_plain(dy.numel(), 3, 7, 5, 0.8).reshape(dy.shape)
        want = torch.where(keep, a * dy, torch.zeros(()))
    else:
        keep = dk.noise_plain("spatial_dropout", torch.ones_like(dy), 3, 7,
                              5, p=0.7) != 0
        want = torch.where(keep, dy / 0.7, torch.zeros(()))
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=1e-15,
                               atol=0)


def test_ops_are_identity_off_and_need_a_scope():
    x = torch.ones(4, 3)
    assert rops.gaussian_noise(x, 0.5, training=False) is x
    assert rops.gaussian_dropout(x, 0.0) is x
    assert rops.alpha_dropout(x, 1.0) is x
    assert rops.spatial_dropout(x, 1.0) is x
    for fn, a in ((rops.gaussian_noise, 0.5), (rops.gaussian_dropout, 0.2),
                  (rops.alpha_dropout, 0.5), (rops.spatial_dropout, 0.5)):
        with pytest.raises(RuntimeError, match="rng_scope"):
            fn(x, a)
    assert set(rops.PORTED_RANDOM_OPS) >= set(KINDS)


# ----------------------------------------------------------------------
# the layers
def _noise_layers():
    return [pnn.GaussianNoiseLayer(stddev=0.2),
            pnn.GaussianDropoutLayer(rate=0.2),
            pnn.AlphaDropoutLayer(dropout=0.9),
            pnn.SpatialDropoutLayer(dropout=0.8)]


def _mln_conf():
    b = (pnn.NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
         .list())
    for layer in _noise_layers():
        b = b.layer(layer)
    return (b.layer(pnn.GRULayer(n_out=5))
            .layer(pnn.RnnOutputLayer(n_out=3))
            .set_input_type(pnn.InputType.recurrent(4, 6)).build())


def _graph_conf():
    g = (pnn.NeuralNetConfiguration.builder().seed(4).updater(Sgd(0.1))
         .graph_builder().add_inputs("in")
         .set_input_types(pnn.InputType.convolutional(5, 5, 3)))
    prev = "in"
    for i, layer in enumerate(_noise_layers()):
        g = g.add_layer(f"n{i}", layer, prev)
        prev = f"n{i}"
    return (g.add_layer("c", pnn.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                  activation="relu"), prev)
            .add_layer("gap", pnn.GlobalPoolingLayer(), "c")
            .add_layer("out", pnn.OutputLayer(n_out=3), "gap")
            .set_outputs("out").build())


def _fit(net, tier, x, y, b=4):
    it = DeviceCachedIterator(x, y, batch_size=b, device="cpu")
    listen = [ScoreIterationListener(10 ** 9, lambda *a: None)]
    if tier == "scanned":
        return net.fit(it)
    if tier == "windowed":
        return net.fit(it, fused_steps=4, listeners=listen)
    return net.fit(it, fused_steps=1, listeners=listen)


def test_noise_layers_are_in_the_training_graph_only():
    net = pnn.MultiLayerNetwork(_mln_conf()).init(device="cpu")
    ops = [op.op for op in net.samediff.ops()]
    assert ops[:4] == KINDS
    nodes = [op.attrs["node"] for op in net.samediff.ops()[:4]]
    assert len(set(nodes)) == 4
    assert not set(KINDS) & {op.op for op in net._sd_infer.ops()}


@pytest.mark.parametrize("make", [_mln_conf, _graph_conf])
def test_tiers_draw_the_same_noise_and_train_the_same(make):
    rng = np.random.default_rng(5)
    if make is _mln_conf:
        x = rng.normal(size=(16, 6, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (16, 6))]
        cls = pnn.MultiLayerNetwork
    else:
        x = rng.normal(size=(16, 3, 5, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        cls = pnn.ComputationGraph
    out = {}
    for tier in ("per_step", "windowed", "scanned"):
        net = cls(make()).init(device="cpu")
        h = _fit(net, tier, x, y)
        out[tier] = (h.step_losses, net.params())
    assert len(set(out["per_step"][0])) > 1
    for tier in ("windowed", "scanned"):
        assert out[tier][0] == out["per_step"][0]
        for k, v in out["per_step"][1].items():
            np.testing.assert_array_equal(out[tier][1][k], v, err_msg=k)


def test_graph_noise_nodes_key_their_draws_and_inference_is_identity():
    net = pnn.ComputationGraph(_graph_conf()).init(device="cpu")
    assert [net.model[f"n{i}"].node for i in range(4)] == [0, 1, 2, 3]
    assert net.model["n3"].attrs["channel_axis"] == 1
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 5))
    assert torch.equal(net.output(x)[0], net.output(x)[0])
    assert not torch.equal(net.output(x, training=True)[0],
                           net.output(x, training=True)[0])


def test_noise_layer_json_is_the_jax_one_both_ways():
    from deeplearning4j_tpu.nn import noise_layers as jnl
    from deeplearning4j_tpu.nn.layers import BaseLayer as JBase
    for p, j in zip(_noise_layers(), [
            jnl.GaussianNoiseLayer(stddev=0.2),
            jnl.GaussianDropoutLayer(rate=0.2),
            jnl.AlphaDropoutLayer(dropout=0.9),
            jnl.SpatialDropoutLayer(dropout=0.8)]):
        assert p.to_json() == j.to_json()
        assert pnn.GaussianNoiseLayer.from_json(j.to_json()) == p
        assert JBase.from_json(p.to_json()) == j


def test_noise_ctypes_declarations_match_the_c_source():
    src = (ROOT / "deeplearning4j_tpu_torch" / "csrc" / "dropout.cu"
           ).read_text()
    m = re.search(r'extern "C" int dl4j_noise\(([^)]*)\)', src)
    params = [p.strip().split()[-1].lstrip("*") for p in
              m.group(1).split(",")]
    assert params == [n for n, _ in dk.NOISE_ARGTYPES]
    types = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
             "int": ctypes.c_int, "double": ctypes.c_double}
    for decl, (_, t) in zip(m.group(1).split(","), dk.NOISE_ARGTYPES):
        words = decl.replace("const", "").replace("*", " * ").split()[:-1]
        assert types["".join(words)] is t, decl
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    # each product and sum rounded on its own, as the plain version's
    assert "__fmul_rn" in code and "__dadd_rn" in code
    assert set(dk.NOISE_KINDS.values()) == set(range(5))
    assert "6.283185307179586" in code and "5.9604644775390625e-08" in code
