"""The training options of the port's step against the JAX package's.

The step's apply half (``autodiff/step.py``) against the JAX
``apply_fn``: each regularizer (``learning/regularization.py``) and each
of the five clip modes (``TrainingConfig.clip_gradients_``) on one
seeded float32 gradient set, rtol 1e-6 / atol 1e-7. Then ``fit`` with a
schedule, regularization, clipping and ``accum_steps`` 1 and 2, Adam and
Nesterovs, on the per-step and fused tiers, through a SameDiff MLP, a
``MultiLayerNetwork`` and a small ``ComputationGraph``, 8 steps from the
same weights and batches: every step's loss and every final parameter
within the JAX tier tolerance (rtol 1e-5 / atol 1e-6). The sentinel: on
is bit-equal to off, and a NaN gradient injected at a step raises
``TrainingDivergedError`` naming that step (and its epoch and batch) on
every tier, as the JAX fit names it. The JSON forms and the builders."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu.autodiff import Listener as JListener
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JIterator
from deeplearning4j_tpu.faults import ChaosMonkey as JChaos
from deeplearning4j_tpu.faults import \
    TrainingDivergedError as JDivergedError
from deeplearning4j_tpu.learning import regularization as jreg
from deeplearning4j_tpu.learning import schedules as jsch
from deeplearning4j_tpu.learning import updaters as jup
from deeplearning4j_tpu_torch.autodiff import (Listener, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.autodiff.step import apply_
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.faults import (ChaosMonkey,
                                             TrainingDivergedError)
from deeplearning4j_tpu_torch.learning import regularization as preg
from deeplearning4j_tpu_torch.learning import schedules as psch
from deeplearning4j_tpu_torch.learning import updaters as pup

RTOL, ATOL = 1e-5, 1e-6
FEATS, CLASSES, B = 12, 4, 8


def _grad_set(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 4), "b": (4,), "c": (3, 3, 2), "d": (7,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    return p, g


def _t(d, names):
    return [torch.tensor(d[k]) for k in names]


REGS = {
    "l1": lambda m: m.L1Regularization(l1=1e-2),
    "l2": lambda m: m.L2Regularization(l2=5e-3),
    "weight_decay": lambda m: m.WeightDecay(coeff=1e-2),
    "weight_decay_no_lr": lambda m: m.WeightDecay(coeff=1e-3,
                                                  apply_lr=False),
}


@pytest.mark.parametrize("name", sorted(REGS))
def test_each_regularizer_matches_jax(name):
    p, g = _grad_set()
    names = sorted(p)
    jr, pr = REGS[name](jreg), REGS[name](preg)
    assert pr.apply_step == jr.apply_step
    assert pr.to_json() == jr.to_json()
    assert type(preg.Regularization.from_json(jr.to_json())) is type(pr)
    lr = np.float32(0.037)
    want = {k: np.asarray(jr.apply(jnp.asarray(p[k]), jnp.asarray(g[k]),
                                   jnp.asarray(lr))) for k in names}
    got = _t(g, names)
    pr.apply_(_t(p, names), got, torch.tensor(lr))
    for k, t in zip(names, got):
        np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


CLIPS = {
    "grad_clip_value": {"grad_clip_value": 1.5},
    "clip_element_wise_absolute_value": {
        "gradient_normalization": "clip_element_wise_absolute_value",
        "gradient_normalization_threshold": 2.0},
    "clip_l2_per_layer": {"gradient_normalization": "clip_l2_per_layer",
                          "gradient_normalization_threshold": 4.0},
    "clip_l2_global": {"gradient_normalization": "clip_l2_global",
                       "gradient_normalization_threshold": 6.0},
    "renormalize_l2_per_layer": {
        "gradient_normalization": "renormalize_l2_per_layer"},
    "clip_by_global_norm": {"gradient_normalization": "clip_by_global_norm",
                            "gradient_normalization_threshold": 1e3},
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_each_clip_mode_matches_jax(name):
    p, g = _grad_set(1)
    names = sorted(g)
    jtc = JTrainingConfig(updater=jup.Sgd(0.1), **CLIPS[name])
    ptc = TrainingConfig(updater=pup.Sgd(0.1), **CLIPS[name])
    want = jtc.clip_gradients({k: jnp.asarray(v) for k, v in g.items()})
    got = _t(g, names)
    ptc.clip_gradients_(got)
    changed = False
    for k, t in zip(names, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        changed |= not np.array_equal(t.numpy(), g[k])
    assert changed == (name != "clip_by_global_norm")   # under its norm


def test_unknown_clip_mode_is_refused():
    with pytest.raises(ValueError, match="gradient_normalization"):
        TrainingConfig(updater=pup.Sgd(), gradient_normalization="clip_l3")


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
def test_apply_half_matches_jax_apply_fn(updater):
    """Regularization before the updater, clipping, the updater, weight
    decay after it, at a scheduled rate: three steps of the JAX
    ``apply_fn`` order."""
    p, _ = _grad_set(2)
    names = sorted(p)
    sched = {"m": lambda m: m.ExponentialSchedule(initial_value=0.05,
                                                  gamma=0.9)}["m"]
    if updater == "adam":
        ju, pu = jup.Adam(learning_rate=sched(jsch)), \
            pup.Adam(learning_rate=sched(psch))
    else:
        ju, pu = jup.Nesterovs(learning_rate=sched(jsch), momentum=0.9), \
            pup.Nesterovs(learning_rate=sched(psch), momentum=0.9)
    regs = [jreg.L2Regularization(l2=1e-2), jreg.WeightDecay(coeff=1e-2)]
    jtc = JTrainingConfig(updater=ju, regularization=regs,
                          gradient_normalization="clip_l2_global",
                          gradient_normalization_threshold=5.0)
    ptc = TrainingConfig.from_json(json.loads(json.dumps(jtc.to_json())))
    assert ptc.to_json() == {k: v for k, v in json.loads(json.dumps(
        jtc.to_json())).items() if k in ptc.to_json()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = ju.init(jp)
    pp = _t(p, names)
    pstate = ptc.updater.init(pp)
    for it in range(3):
        _, g = _grad_set(10 + it)
        lr = jsch.resolve_lr(ju.learning_rate, it, 0)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jg = {k: jg[k] + regs[0].l2 * jp[k] for k in jg}
        jg = jtc.clip_gradients(jg)
        upd, jstate = ju.apply(jg, jstate, it)
        upd = {k: regs[1].apply(jp[k], upd[k], lr) for k in upd}
        jp = {k: jp[k] - upd[k] for k in jp}
        scal = torch.tensor([ptc.updater.step_scalars([it])[0],
                             ptc.updater.learning_rates([it])[0]])
        apply_(ptc, pp, _t(g, names), pstate, scal)
    for k, t in zip(names, pp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ----------------------------------------------------------------------
# fit, through the three front ends
def _mlp_sd(cls, **kw):
    rng = np.random.default_rng(0)
    sd = cls(**kw)
    x = sd.placeholder("x", shape=(-1, FEATS))
    w0 = sd.var("w0", value=rng.normal(0, .3, (FEATS, 16)).astype(
        np.float32))
    b0 = sd.var("b0", value=np.zeros(16, np.float32))
    h = sd.nn.relu(x.mmul(w0).add(b0))
    w1 = sd.var("w1", value=rng.normal(0, .3, (16, CLASSES)).astype(
        np.float32))
    labels = sd.placeholder("labels", shape=(-1, CLASSES))
    sd.loss.softmax_cross_entropy(h.mmul(w1), labels, name="loss")
    sd.set_loss_variables(["loss"])
    return sd


def _updater(pkg, kind):
    m, s = (jup, jsch) if pkg == "jax" else (pup, psch)
    sched = s.RampSchedule(base=s.StepSchedule(
        initial_value=0.05 if kind == "adam" else 0.2, decay_rate=0.5,
        step=3), num_iter=3)
    return m.Adam(learning_rate=sched) if kind == "adam" else \
        m.Nesterovs(learning_rate=sched, momentum=0.9)


def _options(pkg, kind):
    r = jreg if pkg == "jax" else preg
    return {"regularization": [r.L1Regularization(l1=1e-3),
                               r.L2Regularization(l2=1e-2),
                               r.WeightDecay(coeff=5e-2)],
            "gradient_normalization": "clip_l2_global",
            "gradient_normalization_threshold": 2.0}


def _data(steps, seed=3, feats=FEATS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, feats)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES,
                                                        steps * B)]
    return x, y


def _recorder(base):
    class Rec(base):
        frequency = 10 ** 9

        def __init__(self):
            self.losses = []

        def iterations_done(self, sd, epoch, iterations, losses):
            self.losses.extend(float(v) for v in losses)
    return Rec()


def _fit_sd(pkg, kind, accum, fused, sentinel=False, steps=8):
    cls = JSameDiff if pkg == "jax" else SameDiff
    kw = {} if pkg == "jax" else {"device": "cpu"}
    sd = _mlp_sd(cls, **kw)
    tc_cls = JTrainingConfig if pkg == "jax" else TrainingConfig
    sd.training_config = tc_cls(
        updater=_updater(pkg, kind), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], fused_steps=fused,
        accum_steps=accum, sentinel=sentinel, **_options(pkg, kind))
    x, y = _data(steps)
    it = JIterator(x, y, batch_size=B) if pkg == "jax" else \
        DeviceCachedIterator(x, y, batch_size=B, device="cpu")
    rec = _recorder(JListener if pkg == "jax" else Listener)
    sd.fit(it, epochs=1, listeners=[rec])
    params = {k: np.asarray(v) if pkg == "jax" else v.numpy().copy()
              for k, v in sd.trainable_params().items()}
    return sd, rec.losses, params


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [1, 4])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", ["adam", "nesterovs"])
def test_samediff_fit_with_options_matches_jax(kind, accum, fused):
    _, jl, jp = _fit_sd("jax", kind, accum, fused)
    sd, pl, pp = _fit_sd("port", kind, accum, fused)
    assert len(pl) == len(jl) == 8
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    _close(pp, jp)
    st = sd.last_fit_stats
    assert st["accum_steps"] == accum
    assert st["tier"] == ("per_step" if fused == 1 and accum == 1
                          else "windowed")


def _mln_conf(pkg, kind):
    m = jnn if pkg == "jax" else pnn
    return (m.NeuralNetConfiguration.builder().seed(7)
            .updater(_updater(pkg, kind)).l1(1e-3).l2(1e-2)
            .weight_decay(5e-2).gradient_clip(0.5)
            .gradient_normalization("clip_l2_per_layer", 1.0).list()
            .layer(m.DenseLayer(n_out=16, activation="relu"))
            .layer(m.OutputLayer(n_out=CLASSES, loss_function="MCXENT"))
            .set_input_type(m.InputType.feed_forward(FEATS)).build())


@pytest.mark.parametrize("fused,accum", [(1, 1), (4, 2), (1, 2)])
def test_multilayer_fit_with_options_matches_jax(fused, accum):
    x, y = _data(8)
    jnet = jnn.MultiLayerNetwork(_mln_conf("jax", "nesterovs")).init()
    pconf = _mln_conf("port", "nesterovs")
    assert [r.to_json() for r in pconf.regularization] == \
        [r.to_json() for r in jnet.conf.regularization]
    pnet = pnn.MultiLayerNetwork(pconf).init(device="cpu")
    tc = pnet.samediff.training_config
    assert tc.grad_clip_value == 0.5 and \
        tc.gradient_normalization == "clip_l2_per_layer"
    jrec, prec = _recorder(JListener), _recorder(Listener)
    jnet.fit(x, y, batch_size=B, listeners=[jrec], fused_steps=fused,
             accum_steps=accum)
    pnet.fit(x, y, batch_size=B, listeners=[prec], fused_steps=fused,
             accum_steps=accum)
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=RTOL,
                               atol=ATOL)
    _close(pnet.params(), {k: np.asarray(v)
                           for k, v in jnet.params().items()})


def _graph_conf(m, nesterovs, kind):
    conf = (m.NeuralNetConfiguration.builder().seed(5)
            .updater(nesterovs).l2(1e-2).weight_decay(1e-2)
            .graph_builder().add_inputs("input")
            .set_input_types(m.InputType.convolutional(6, 6, 2))
            .add_layer("conv", m.ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), convolution_mode="SAME"),
                "input")
            .add_layer("bn", m.BatchNormalization(), "conv")
            .add_layer("act", m.ActivationLayer(activation="relu"), "bn")
            .add_layer("gap", m.GlobalPoolingLayer(pooling_type="AVG"),
                       "act")
            .add_layer("output", m.OutputLayer(n_out=3,
                                               loss_function="MCXENT"),
                       "gap")
            .set_outputs("output").build())
    return conf


def _graph_pair(kind="nesterovs"):
    jconf = _graph_conf(jnn, _updater("jax", kind), kind)
    jconf.cnn_data_format = "NCHW"
    jnet = jnn.ComputationGraph(jconf).init()
    pnet = pnn.ComputationGraph(
        _graph_conf(pnn, _updater("port", kind), kind)).init(device="cpu")
    pnet.model.load_state_dict(params_from_jax(jnet.params()))
    return jnet, pnet


def _graph_data(steps, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, 2, 6, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, steps * B)]


@pytest.mark.parametrize("fused,accum", [(1, 1), (4, 1), (4, 2), (1, 2)])
def test_graph_fit_with_options_matches_jax(fused, accum):
    jnet, pnet = _graph_pair()
    assert [r.to_json() for r in pnet.conf.regularization] == \
        [r.to_json() for r in jnet.conf.regularization]
    for net in (jnet.samediff, pnet):
        net.training_config.gradient_normalization = "clip_l2_global"
        net.training_config.gradient_normalization_threshold = 3.0
    x, y = _graph_data(8)
    jrec, prec = _recorder(JListener), _recorder(Listener)
    jnet.fit(JIterator(x, y, batch_size=B), listeners=[jrec],
             fused_steps=fused, accum_steps=accum)
    pnet.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"),
             listeners=[prec], fused_steps=fused, accum_steps=accum)
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=RTOL,
                               atol=ATOL)
    want = {k: np.asarray(v) for k, v in jnet.params().items()}
    got = pnet.params()
    assert set(got) == set(want)
    _close(got, want)


# ----------------------------------------------------------------------
# the sentinel
@pytest.mark.parametrize("fused,accum,listeners", [
    (1, 1, True), (1, 1, False), (4, 1, True), (4, 2, False), (1, 2, True)])
def test_sentinel_on_is_bit_equal_to_off(fused, accum, listeners):
    runs = []
    for sentinel in (False, True):
        sd = _mlp_sd(SameDiff, device="cpu")
        sd.training_config = TrainingConfig(
            updater=_updater("port", "adam"), data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"], fused_steps=fused,
            accum_steps=accum, sentinel=sentinel, **_options("port", "adam"))
        x, y = _data(8)
        rec = _recorder(Listener)
        h = sd.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"),
                   epochs=2, listeners=[rec] if listeners else [])
        assert sd.last_fit_stats["sentinel"] is sentinel
        runs.append((h.step_losses, {k: v.clone() for k, v in
                                     sd.trainable_params().items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


@pytest.mark.parametrize("tier,accum,at", [
    ("scanned", 1, 5), ("windowed", 1, 5), ("windowed", 2, 5),
    ("per_step", 1, 5), ("per_step_no_listener", 1, 5), ("windowed", 2, 11),
    ("windowed_accum_k1", 2, 6)])
def test_divergence_is_named_at_the_exact_step_on_every_tier(tier, accum,
                                                             at):
    """NaN gradients at iteration ``at`` (8 steps an epoch, 2 epochs):
    the error names that step, its epoch and its batch of the epoch, as
    the JAX fit does on the same tier."""
    fused = {"scanned": 1, "per_step": 1, "per_step_no_listener": 1,
             "windowed_accum_k1": 1}.get(tier, 4)
    listeners = tier in ("windowed", "per_step", "windowed_accum_k1")
    errors = []
    for pkg in ("jax", "port"):
        cls = JSameDiff if pkg == "jax" else SameDiff
        sd = _mlp_sd(cls, **({} if pkg == "jax" else {"device": "cpu"}))
        tc_cls = JTrainingConfig if pkg == "jax" else TrainingConfig
        sd.training_config = tc_cls(
            updater=_updater(pkg, "adam"), data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"], fused_steps=fused,
            accum_steps=accum, sentinel=True)
        x, y = _data(8)
        it = JIterator(x, y, batch_size=B) if pkg == "jax" else \
            DeviceCachedIterator(x, y, batch_size=B, device="cpu")
        if tier.startswith("per_step"):
            it = [(x[i:i + B], y[i:i + B]) for i in range(0, len(x), B)]
        chaos, err = (JChaos, JDivergedError) if pkg == "jax" else \
            (ChaosMonkey, TrainingDivergedError)
        rec = _recorder(JListener if pkg == "jax" else Listener)
        rec.frequency = 4
        with chaos(seed=0).nan_gradients(sd, at_step=at):
            with pytest.raises(err) as ei:
                sd.fit(it, epochs=2, listeners=[rec] if listeners else [])
        errors.append((ei.value.step, ei.value.epoch,
                       ei.value.batch_index, ei.value.cause))
        if pkg == "port":
            want = {"scanned": "scanned_epoch", "windowed": "windowed",
                    "windowed_accum_k1": "windowed"}.get(tier, "per_step")
            assert sd.last_fit_stats is None or \
                sd.last_fit_stats["tier"] == want
            assert f"iteration {at}" in str(ei.value)
            assert rec.losses == [] or len(rec.losses) <= at
    assert errors[1] == errors[0] == (at, at // 8, at % 8,
                                      "device_sentinel")


def test_sentinel_reads_every_leaf_without_overflow():
    """A finite gradient whose sum of squares overflows float32 passes;
    one NaN or Inf element anywhere fails, as does a non-finite loss."""
    from deeplearning4j_tpu_torch.autodiff.step import sentinel_ok
    g = [torch.ones(1000), torch.zeros(3, 3)]
    g[0][500] = 3e38
    assert bool(sentinel_ok(torch.tensor(1.0), g))
    for bad in (float("nan"), float("inf"), -float("inf")):
        g[1][2, 2] = bad
        assert not bool(sentinel_ok(torch.tensor(1.0), g))
        g[1][2, 2] = 0.0
    assert not bool(sentinel_ok(torch.tensor(float("nan")), g))


def test_an_epoch_schedule_stays_at_epoch_0_inside_fit():
    """The JAX fit resolves every schedule at epoch 0
    (``autodiff/samediff.py:875-882``, ``learning/updaters.py:35-37``):
    an EPOCH-type schedule does not advance over two epochs; the port
    follows the code."""
    out = []
    for pkg in ("jax", "port"):
        cls = JSameDiff if pkg == "jax" else SameDiff
        sd = _mlp_sd(cls, **({} if pkg == "jax" else {"device": "cpu"}))
        s = jsch if pkg == "jax" else psch
        m = jup if pkg == "jax" else pup
        tc_cls = JTrainingConfig if pkg == "jax" else TrainingConfig
        sd.training_config = tc_cls(
            updater=m.Sgd(learning_rate=s.ExponentialSchedule(
                initial_value=0.1, gamma=0.01, schedule_type="EPOCH")),
            data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"])
        x, y = _data(4)
        rec = _recorder(JListener if pkg == "jax" else Listener)
        sd.fit([(x[i:i + B], y[i:i + B]) for i in range(0, len(x), B)],
               epochs=2, listeners=[rec])
        out.append((rec.losses, {k: np.asarray(v) if pkg == "jax"
                                 else v.numpy()
                                 for k, v in sd.trainable_params().items()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=RTOL, atol=ATOL)
    _close(out[1][1], out[0][1])
    # at epoch 1 the schedule would be 100x smaller: the second epoch's
    # steps still move the weights like the first epoch's
    assert abs(out[1][0][-1] - out[1][0][3]) > 1e-4


def test_training_config_json_and_builder():
    tc = (TrainingConfig.builder().updater(_updater("port", "adam"))
          .data_set_feature_mapping("x").data_set_label_mapping("labels")
          .regularization(preg.L2Regularization(l2=1e-4))
          .grad_clip_value(2.0).gradient_normalization("clip_l2_global", 3.0)
          .fused_steps(4).accum_steps(2).sentinel().build())
    d = json.loads(json.dumps(tc.to_json()))
    jtc = JTrainingConfig.from_json(d)
    assert jtc.accum_steps == 2 and jtc.sentinel is True
    assert jtc.gradient_normalization_threshold == 3.0
    back = TrainingConfig.from_json(json.loads(json.dumps(jtc.to_json())))
    assert back.to_json() == tc.to_json()
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TrainingConfig.from_json({**d, "tensorstats": {"every": 2}})
    with pytest.raises(ValueError, match="accum_steps"):
        TrainingConfig(updater=pup.Sgd(), accum_steps=0)


def test_accumulation_keeps_one_window_a_phase():
    """K = 3 with accum 2: windows start at even and odd iterations, so
    two windows (one a phase) are made in the first fit and none later;
    a fit ending mid-cycle leaves its partial sum for the next."""
    sd = _mlp_sd(SameDiff, device="cpu")
    sd.training_config = TrainingConfig(
        updater=_updater("port", "adam"), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], fused_steps=3, accum_steps=2)
    x, y = _data(9)
    it = DeviceCachedIterator(x, y, batch_size=B, device="cpu")
    sd.fit(it, epochs=1, listeners=[_recorder(Listener)])
    assert sd.last_fit_stats["window_captures"] == 2
    assert sd.training_config.iteration_count == 9
    acc = sd._grad_accum[1]
    assert any(bool(a.abs().sum() > 0) for a in acc)    # mid-cycle
    sd.fit(it, epochs=1, listeners=[_recorder(Listener)])
    assert sd.last_fit_stats["window_captures"] == 0
    # against one fit of the same 18 steps
    ref = _mlp_sd(SameDiff, device="cpu")
    ref.training_config = TrainingConfig(
        updater=_updater("port", "adam"), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], fused_steps=1, accum_steps=2)
    xx, yy = np.concatenate([x, x]), np.concatenate([y, y])
    ref.fit(DeviceCachedIterator(xx, yy, batch_size=B, device="cpu"),
            epochs=1, listeners=[_recorder(Listener)])
    for k, v in ref.trainable_params().items():
        np.testing.assert_allclose(sd.trainable_params()[k].numpy(),
                                   v.numpy(), rtol=RTOL, atol=ATOL)
