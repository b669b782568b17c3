"""Helpers of the zoo model tests (``test_torch_zoo_*.py``): a zoo model
built by both packages from the same seed, and the readings the tests
hold the port to.

Each model is built from the same class of both zoos with the same
arguments, in float64 (the JAX package with x64, as ``conftest.py`` sets
it). The JAX networks run ``cnn_data_format="NCHW"`` wherever they hold a
batch norm: with its NHWC body the JAX ``batchnorm_train`` reduces over
every axis, channels included (ROADMAP queue 3, facts), where the port
and the layer's documentation take per-channel statistics. A
``MultiLayerNetwork`` that flattens a cnn map into a dense layer runs the
same layout in both packages (the flatten's order follows it); the port's
other networks run their default layout. Dropout is off in both (set to
0 where a model has it): its masks are held by ``test_torch_dropout.py``.
"""
from __future__ import annotations

import numpy as np
import torch

import deeplearning4j_tpu.zoo as jzoo
import deeplearning4j_tpu_torch.zoo as pzoo
from deeplearning4j_tpu.autodiff.training import Listener as JListener
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JIterator
from deeplearning4j_tpu.learning import updaters as jupd
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import updaters as pupd


def to_np(v) -> np.ndarray:
    v = v[0] if isinstance(v, list) else v
    v = v.to_numpy() if hasattr(v, "to_numpy") else v
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _no_dropout(conf) -> None:
    layers = conf.layers if hasattr(conf, "layers") else [
        n.op for n in conf.nodes]
    for layer in layers:
        if hasattr(layer, "dropout"):
            layer.dropout = 0.0


def pair(name, kw, updater=None, layout="NCHW", dtype="float64",
         dropout=False):
    """(JAX network, port network) of zoo class ``name``. ``updater``: a
    name in both packages' ``learning.updaters`` and its arguments, or
    None for the zoo's default. ``layout``: the JAX network's
    ``cnn_data_format``; a ``MultiLayerNetwork`` of the port takes it too
    when ``layout`` is ``"both NCHW"``."""
    ups = {}
    if updater is not None:
        cls, args = updater
        ups = {"j": getattr(jupd, cls)(**args), "p": getattr(pupd, cls)(**args)}
    if name == "FaceNet":           # FaceNet builds this configuration
        name, kw = "InceptionResNetV1", {**kw, "center_loss": True}
    jconf = getattr(jzoo, name)(**kw, updater=ups.get("j")).conf()
    pconf = getattr(pzoo, name)(**kw, updater=ups.get("p")).conf()
    for conf in (jconf, pconf):
        conf.dtype = dtype
        if not dropout:
            _no_dropout(conf)
    jconf.cnn_data_format = "NCHW" if layout.endswith("NCHW") else layout
    if layout == "both NCHW":
        pconf.cnn_data_format = "NCHW"
    from deeplearning4j_tpu.nn import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMln
    from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
    graph = hasattr(jconf, "nodes")
    jnet = (JGraph if graph else JMln)(jconf).init()
    pnet = (ComputationGraph if graph else MultiLayerNetwork)(pconf).init(
        device="cpu")
    return jnet, pnet


def n_params_jax(jnet) -> int:
    return sum(int(np.prod(a.shape))
               for a in jnet._sd_train.trainable_params().values())


class _Losses(JListener):
    frequency = 1

    def __init__(self):
        self.losses = []

    def iteration_done(self, sd, epoch, iteration, loss):
        self.losses.append(float(loss))


def fit_both(jnet, pnet, x, y, batch):
    """One fit of both over (x, y) in batches of ``batch`` (the port's on
    a device iterator: the scanned epoch; the JAX one's with a listener
    recording each step's loss): (JAX step losses, port step losses)."""
    rec = _Losses()
    jnet.fit(JIterator(x, y, batch_size=batch), listeners=[rec])
    ph = pnet.fit(DeviceCachedIterator(x, y, batch_size=batch,
                                       device="cpu"))
    return np.asarray(rec.losses), np.asarray(ph.step_losses)


def conf_pair(make, updater, dtype="float64", jax_layout="NCHW",
              port_layout=None):
    """(JAX network, port network) of ``make(nn, updater)``, a
    configuration built by either package's ``nn`` module with its
    updater ``updater`` (a name in ``learning.updaters`` and its
    arguments)."""
    import deeplearning4j_tpu.nn as jnn
    import deeplearning4j_tpu_torch.nn as pnn
    cls, args = updater
    jconf = make(jnn, getattr(jupd, cls)(**args))
    pconf = make(pnn, getattr(pupd, cls)(**args))
    for conf in (jconf, pconf):
        conf.dtype = dtype
    jconf.cnn_data_format = jax_layout
    if port_layout is not None:
        pconf.cnn_data_format = port_layout
    graph = hasattr(jconf, "nodes")
    jnet = (jnn.ComputationGraph if graph else jnn.MultiLayerNetwork)(
        jconf).init()
    pnet = (pnn.ComputationGraph if graph else pnn.MultiLayerNetwork)(
        pconf).init(device="cpu")
    return jnet, pnet


def check_model(name, kw, x, y, tol, updater_tol, layout="NCHW",
                steps=3, out_tol=None, updater=None):
    """The model ``name`` against the JAX one: the same initial weights
    and parameter count; the inference output; one ``Sgd(1.0)`` step on
    the first batch, whose parameter changes are minus the gradients,
    each to ``tol`` of its magnitude; then ``steps`` steps of the zoo's
    own updater (or ``updater``), every step's loss to ``tol`` and every parameter to
    ``updater_tol`` of its magnitude (but for the elements whose first
    gradient is at rounding level, which Adam moves by its learning rate
    whatever that gradient's sign). The output is held to ``out_tol``
    (default ``tol``).
    Returns the readings."""
    return check_nets(
        lambda upd: pair(name, kw, upd, layout), x, y, tol, updater_tol,
        steps, out_tol, updater)


def check_nets(make_pair, x, y, tol, updater_tol, steps=3, out_tol=None,
               updater=None):
    """``check_model`` on the networks ``make_pair(updater)`` gives (None:
    the configuration's own updater)."""
    b = len(x) // steps
    jnet, pnet = make_pair(("Sgd", {"learning_rate": 1.0}))
    w = jnet.params()
    pw = pnet.params()
    assert set(pw) == set(w)
    for k, v in w.items():
        np.testing.assert_array_equal(pw[k], v, err_msg=k)
    assert pnet.num_params() == n_params_jax(jnet)
    out = rel(to_np(pnet.output(x[:b])), to_np(jnet.output(x[:b])))
    assert out <= (out_tol or tol), ("output", out)
    jl, pl = fit_both(jnet, pnet, x[:b], y[:b], b)
    np.testing.assert_allclose(pl, jl, rtol=tol)
    after_j, after_p = jnet.params(), pnet.params()
    sgd_j = after_j
    grads = {}
    for k in w:
        if k.endswith(("_mean", "_var", "_centers")):
            continue
        dj, dp = after_j[k] - w[k], after_p[k] - w[k]
        scale = max(float(np.max(np.abs(dj))), 1e-30)
        grads[k] = float(np.max(np.abs(dp - dj))) / scale if scale > 1e-12 \
            else float(np.max(np.abs(dp - dj)))
    # a bias into a batch norm has a true gradient of 0: both sides hold
    # rounding noise there, held absolutely, and an updater that divides
    # by the gradient's size (Adam) moves it by noise, so it is left out
    # of the updater steps' reading
    top = max(max(abs(float(np.max(np.abs(after_j[k] - w[k])))), 1e-30)
              for k in grads)
    dead = {k for k in grads
            if np.max(np.abs(after_j[k] - w[k])) < 1e-9 * top}
    for k in dead:
        assert np.max(np.abs((after_p[k] - w[k]) - (after_j[k] - w[k]))) \
            < 1e-9 * top, k
    grads = {k: v for k, v in grads.items() if k not in dead}
    worst = max(grads, key=grads.get)
    assert grads[worst] <= tol, ("gradient", worst, grads[worst])
    jnet, pnet = make_pair(updater)
    jl, pl = fit_both(jnet, pnet, x, y, b)
    assert len(pl) == steps
    np.testing.assert_allclose(pl, jl, rtol=tol)
    after_j, after_p = jnet.params(), pnet.params()
    params = {}
    for k, v in after_j.items():
        if k in dead:
            continue
        g = sgd_j[k] - w[k] if k in grads else None
        # Adam moves an element by about the learning rate whatever its
        # gradient's size: one whose gradient is at rounding level (1e-6
        # of its tensor's largest) may move either way in either package
        keep = np.ones(v.shape, bool) if g is None else \
            np.abs(g) >= 1e-6 * np.max(np.abs(g))
        params[k] = float(np.max(np.abs(after_p[k] - v)[keep], initial=0)) \
            / max(float(np.max(np.abs(v))), 1e-30)
    worst_p = max(params, key=params.get)
    assert params[worst_p] <= updater_tol, ("params", worst_p,
                                            params[worst_p])
    return {"output": out, "gradient": grads[worst],
            "params": params[worst_p]}


def classes(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return np.eye(k)[rng.integers(0, k, n)]


def yolo_labels(n, classes_, grid, seed=0):
    """(n, 4 + classes, grid, grid): one or two boxes an image, corners in
    grid units, a class one-hot; the rest of the cells empty."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 4 + classes_, grid, grid))
    for i in range(n):
        for c in rng.choice(grid * grid, size=min(2, grid * grid),
                            replace=False):
            r, col = divmod(int(c), grid)
            w, h = rng.uniform(0.5, 2.0, 2)
            cx, cy = col + rng.random(), r + rng.random()
            y[i, 0:4, r, col] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2)
            y[i, 4 + rng.integers(classes_), r, col] = 1.0
    return y
