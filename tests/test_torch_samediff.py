"""The port's SameDiff against the JAX package's, on the CPU.

Two graphs, built on both sides with the same weights (handed over through
``convert.samediff_arrays_from_jax``) and fed the same seeded numpy
inputs: the SameDiff MLP of the JAX package's ``bench.py``
``_build_mlp_sd`` (784-512-256-10, softmax cross-entropy, rebuilt here)
and the zoo's GPT_TINY (batch 4, seq 32: embeddings, layer norm, causal
attention, tanh-gelu, tied head, sparse cross-entropy, per-layer remat).

float32, tolerance 1e-5 of each tensor's largest magnitude: ``output``,
``calculate_gradients`` for every variable, and a 3-step Adam trajectory
(each step's loss; every parameter after it to 2e-2 of the learning
rate, see the test). The sums run in
another order on each side; with x64 on, the JAX attention op's softmax
runs in float64 (its scale is a numpy float64), the port's in float32.

bf16 ``MixedPrecision``: one Sgd step on each side, with limits set
between two readings (see the test): the port against the JAX package,
both in bf16, and the JAX package's bf16 step against its float32 step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import MixedPrecision as JMixedPrecision
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.autodiff import (MixedPrecision, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.convert import (samediff_arrays_from_jax,
                                              samediff_arrays_to_jax)
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.zoo import GPT_TINY, build_gpt, gpt_param_names

BATCH, SEQ = 4, 32


def _mlp(sd_cls, seed=0, **kw):
    """``bench.py`` ``_build_mlp_sd``'s graph (784 -> 512 -> 256 -> 10)."""
    rng = np.random.default_rng(seed)
    sd = sd_cls(**kw)
    x = sd.placeholder("x", shape=(-1, 784))
    cur, n_in = x, 784
    for i, h in enumerate((512, 256)):
        w = sd.var(f"w{i}", value=rng.normal(0, 0.05, (n_in, h)).astype(
            np.float32))
        b = sd.var(f"b{i}", value=np.zeros(h, np.float32))
        cur = sd.nn.relu(cur.mmul(w).add(b), name=f"h{i}")
        n_in = h
    w = sd.var("w_out", value=rng.normal(0, 0.05, (n_in, 10)).astype(
        np.float32))
    b = sd.var("b_out", value=np.zeros(10, np.float32))
    logits = cur.mmul(w).add(b, name="logits")
    labels = sd.placeholder("labels", shape=(-1, 10))
    sd.loss.softmax_cross_entropy(logits, labels, name="loss")
    sd.set_loss_variables(["loss"])
    return sd


def _mlp_data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _gpt_data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, GPT_TINY.vocab_size, (n, SEQ)).astype(np.int32),
            rng.integers(0, GPT_TINY.vocab_size, (n, SEQ)).astype(np.int32))


MODELS = {
    "mlp": (lambda: _mlp(JSameDiff), lambda: _mlp(SameDiff, device="cpu"),
            _mlp_data, ("x", "labels"), ("logits", "loss")),
    "gpt_tiny": (
        lambda: jgpt.build_gpt(jgpt.GPT_TINY, batch=BATCH, seq_len=SEQ),
        lambda: build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu"),
        _gpt_data, ("input_ids", "targets"), ("logits", "loss")),
}


def _pair(model):
    """(JAX graph, port graph holding the JAX graph's weights)."""
    jbuild, pbuild, _, _, _ = MODELS[model]
    jsd, psd = jbuild(), pbuild()
    samediff_arrays_from_jax(
        {n: np.asarray(a) for n, a in jsd.trainable_params().items()}, psd)
    return jsd, psd


def _feed(model, n, seed):
    _, _, data, (fname, lname), _ = MODELS[model]
    f, l = data(n, seed)
    return {fname: f, lname: l}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _jnp(v):
    return np.asarray(v.to_numpy())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_output_matches_jax(model):
    jsd, psd = _pair(model)
    feed = _feed(model, BATCH, 1)
    outs = MODELS[model][4]
    want = jsd.output(feed, list(outs))
    got = psd.output(feed, list(outs))
    for name in outs:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert _rel(got[name].numpy(), _jnp(want[name])) <= 1e-5, name


@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_gradient_matches_jax(model):
    jsd, psd = _pair(model)
    feed = _feed(model, BATCH, 2)
    want = jsd.calculate_gradients(feed)
    got = psd.calculate_gradients(feed)
    assert set(got) == set(want) == set(psd.trainable_params())
    for name in want:
        assert _rel(got[name].numpy(), _jnp(want[name])) <= 1e-5, name


def _config(model, cls, updater, mp=None):
    _, _, _, (fname, lname), _ = MODELS[model]
    return cls(updater=updater, data_set_feature_mapping=[fname],
               data_set_label_mapping=[lname], mixed_precision=mp)


def _steps(jsd, psd, model, n, seed0):
    """n fit calls of one batch each on both sides: (JAX losses, port
    losses)."""
    jl, pl = [], []
    for s in range(n):
        f, l = MODELS[model][2](BATCH, seed0 + s)
        jl.append(jsd.fit([(f, l)], epochs=1).final_loss())
        pl.append(psd.fit(DeviceCachedIterator(f, l, batch_size=BATCH,
                                               device="cpu")).final_loss())
    return jl, pl


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_adam_steps_match_jax(model):
    jsd, psd = _pair(model)
    jsd.training_config = _config(model, JTrainingConfig, JAdam(1e-3))
    psd.training_config = _config(model, TrainingConfig, Adam(1e-3))
    jl, pl = _steps(jsd, psd, model, 3, 10)
    for j, p in zip(jl, pl):
        assert abs(p - j) <= 1e-5 * abs(j), (jl, pl)
    # Adam scales each element's step by that element's own gradient, so
    # an element whose gradient is near zero carries the two sides'
    # rounding of it into its step at full size: parameters are held to
    # 2e-2 of one step's size (lr), not to their own magnitude (measured:
    # one element of the MLP's 131072 in w1 at 1.14e-2, the rest under 9e-3)
    got = samediff_arrays_to_jax(psd)
    for name, a in jsd.trainable_params().items():
        assert float(np.max(np.abs(got[name] - np.asarray(a)))) <= \
            2e-2 * 1e-3, name
    assert psd.training_config.iteration_count == 3
    assert psd.training_config.epoch_count == 3


# (loss, worst tensor's change, median tensor's change), each relative.
# Readings, one Sgd step at the test's data (port-vs-JAX bf16 / JAX
# bf16-vs-f32 / the port with its loss tail in bf16):
#   mlp       loss 0 / 4.9e-4 / 2.8e-3; worst 3.1e-3 / 0.344 / 1.2e-2;
#             median 4.4e-4 / 5.4e-3 / 6.3e-3. The port with its
#             parameters or its placeholders left in float32 raises
#             (a matmul of mixed dtypes).
#   gpt_tiny  loss 1.06e-5 / 1.11e-5 / 1.26e-4; worst 2.33e-2 / 2.6e-2 /
#             2.5e-2; median 1.06e-2 / 1.12e-2 / 1.08e-2.
# The MLP's three limits lie between the first two readings. GPT_TINY's
# first two readings are of one size (XLA rounds inside its fused layer
# norm, gelu and softmax chains, PyTorch after each op: two bf16 steps
# differ from each other as much as either from float32), so no limit on
# them tells an uncast step from a cast one; its loss limit lies between
# port-vs-JAX and the bf16-tail reading, and the record of every op's
# output dtype below catches a step left in float32 (its placeholders are
# integer ids, and it has no constants).
BF16_LIMITS = {"mlp": (5e-5, 3e-2, 2e-3), "gpt_tiny": (4e-5, 5e-2, 2e-2)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bf16_mixed_precision_step_matches_jax(model, monkeypatch):
    jsd, psd = _pair(model)
    before = {n: np.asarray(a) for n, a in jsd.trainable_params().items()}
    lr = 0.1
    jsd.training_config = _config(model, JTrainingConfig, JSgd(lr),
                                  JMixedPrecision())
    psd.training_config = _config(model, TrainingConfig, Sgd(lr),
                                  MixedPrecision())
    seen = {}
    run_nodes = SameDiff._run_nodes

    def recording(nodes, env):
        run_nodes(nodes, env)
        for node in nodes:
            for o in node.outputs:
                seen[node.op, o] = env[o].dtype

    monkeypatch.setattr(SameDiff, "_run_nodes", staticmethod(recording))
    jl, pl = _steps(jsd, psd, model, 1, 20)
    loss_tol, worst_tol, median_tol = BF16_LIMITS[model]
    assert abs(pl[0] - jl[0]) <= loss_tol * abs(jl[0]), (jl, pl)
    got = samediff_arrays_to_jax(psd)
    rels = []
    for name, a in jsd.trainable_params().items():
        want = np.asarray(a) - before[name]
        assert got[name].dtype == np.float32     # float32 masters
        if np.max(np.abs(want)) == 0:
            assert np.max(np.abs(got[name] - before[name])) == 0, name
            continue
        rels.append(_rel(got[name] - before[name], want))
        assert rels[-1] <= worst_tol, name
    assert float(np.median(rels)) <= median_tol, rels
    # the forward ran in bf16, the loss ops reduced to float32
    floats = {k: dt for k, dt in seen.items() if dt.is_floating_point}
    assert floats
    for (op_name, out), dt in floats.items():
        want_dt = torch.float32 if "cross_entropy" in op_name \
            else torch.bfloat16
        assert dt == want_dt, (op_name, out, dt)


def test_gpt_remat_on_and_off_give_the_same_gradients():
    feed = _feed("gpt_tiny", BATCH, 3)
    cfg_off = type(GPT_TINY)(**{**GPT_TINY.__dict__, "remat": False})
    on = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu")
    off = build_gpt(cfg_off, batch=BATCH, seq_len=SEQ, device="cpu")
    assert any(n.group for n in on.ops()) and not any(
        n.group for n in off.ops())
    g_on, g_off = on.calculate_gradients(feed), off.calculate_gradients(feed)
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name


def test_gpt_same_seed_gives_the_jax_weights_and_names():
    jsd = jgpt.build_gpt(jgpt.GPT_TINY, batch=BATCH, seq_len=SEQ, seed=5)
    psd = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, seed=5,
                    device="cpu")
    assert gpt_param_names(GPT_TINY) == jgpt.gpt_param_names(jgpt.GPT_TINY)
    assert list(psd.trainable_params()) == list(jsd.trainable_params())
    got = samediff_arrays_to_jax(psd)
    for name, a in jsd.trainable_params().items():
        assert np.array_equal(got[name], np.asarray(a)), name
    assert [n.op for n in psd.ops()] == [n.op for n in jsd.ops()]
    assert [n.name for n in psd.ops()] == [n.name for n in jsd.ops()]


def test_convert_checks_names_shapes_and_dtypes():
    psd = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu")
    arrays = samediff_arrays_to_jax(psd)
    arrays["wte"] = arrays["wte"] + 1.0
    samediff_arrays_from_jax(arrays, psd)
    assert np.array_equal(psd.get_arr_for_var("wte").numpy(), arrays["wte"])
    with pytest.raises(KeyError, match="not a stored variable"):
        samediff_arrays_from_jax({"nope": np.zeros(3, np.float32)}, psd)
    with pytest.raises(ValueError, match="does not match"):
        samediff_arrays_from_jax({"wpe": np.zeros((3, 3), np.float32)}, psd)
    with pytest.raises(ValueError, match="does not match"):
        samediff_arrays_from_jax({"wpe": arrays["wpe"].astype(np.float64)},
                                 psd)


def test_int32_ids_survive_the_device_cached_iterator():
    ids, tgt = _gpt_data(8, 4)
    it = DeviceCachedIterator([ids], [tgt], batch_size=BATCH, device="cpu")
    (f, l), _ = list(it)
    assert f[0].dtype == torch.int32 and l[0].dtype == torch.int32
    psd = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu")
    emb = psd.output({"input_ids": f[0], "targets": l[0]}, ["tok_emb"])
    want = psd.get_arr_for_var("wte")[torch.as_tensor(ids[:BATCH]).long()]
    assert torch.equal(emb["tok_emb"], want)


def test_shape_inference_runs_on_the_meta_device():
    psd = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu")
    assert psd.get_variable("h0/attn/qkv_split:1").shape == (BATCH, 4, SEQ,
                                                             16)
    assert psd.get_variable("logits").shape == (BATCH, SEQ, 256)
    assert psd.get_variable("wte").shape == (256, 64)
    mlp = _mlp(SameDiff, device="cpu")
    assert mlp.get_variable("logits").shape is None     # batch dim unknown


def test_training_config_takes_only_what_the_port_honours():
    """``fused_steps``, ``accum_steps`` and ``sentinel`` are taken; the
    JAX fields the port does not honour yet (``tensorstats``,
    ``fingerprints``) are not."""
    tc = (TrainingConfig.builder().updater(Adam(1e-3))
          .data_set_feature_mapping("x").data_set_label_mapping("labels")
          .fused_steps(1).build())
    assert tc.data_set_feature_mapping == ["x"] and tc.fused_steps == 1
    assert TrainingConfig.builder().updater(Adam()).fused_steps(4).build() \
        .fused_steps == 4
    tc = TrainingConfig.builder().updater(Adam()).accum_steps(2) \
        .sentinel().build()
    assert tc.accum_steps == 2 and tc.sentinel is True
    for field in ("tensorstats", "fingerprints"):
        with pytest.raises(TypeError):
            TrainingConfig(updater=Adam(), **{field: 2})
        assert not hasattr(TrainingConfig.Builder, field)
    mp = MixedPrecision(ce_tail_dtype="bfloat16")
    assert mp.softmax_dtype == mp.ce_tail_dtype == "bfloat16"
    with pytest.raises(ValueError, match="disagree"):
        MixedPrecision(softmax_dtype="float32", ce_tail_dtype="bfloat16")


def test_fit_refuses_listeners_and_needs_a_config(monkeypatch):
    """fit needs a config. Listeners are served on every tier; what the
    graph tiers (fused windows, scanned epoch) refuse is a random op,
    which a captured window would replay unchanged: by name, while the
    per-step tier runs it."""
    psd = _mlp(SameDiff, device="cpu")
    x, y = _mlp_data(8, 0)
    it = DeviceCachedIterator(x, y, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="training_config"):
        psd.fit(it)
    from deeplearning4j_tpu_torch.autodiff import ScoreIterationListener
    from deeplearning4j_tpu_torch.ops import registry
    registry.op_names()
    monkeypatch.setitem(registry._REGISTRY, "test_noise", registry.Op(
        "test_noise", lambda a: a + torch.randn_like(a), "random", 1))
    sd = SameDiff(device="cpu")
    h = sd.invoke("test_noise", [sd.placeholder("x", shape=(-1, 784))],
                  name="noisy")
    w = sd.var("w", value=np.zeros((784, 10), np.float32))
    sd.loss.softmax_cross_entropy(h.mmul(w), sd.placeholder(
        "labels", shape=(-1, 10)), name="loss")
    for k in (1, 2):
        sd.training_config = _config("mlp", TrainingConfig, Adam())
        sd.training_config.fused_steps = k
        with pytest.raises(NotImplementedError, match="'noisy'"):
            sd.fit(it)
    seen = []
    sd.training_config.fused_steps = 1
    sd.fit(it, listeners=[ScoreIterationListener(1, seen.append)])
    assert sd.last_fit_stats["tier"] == "per_step" and len(seen) == 2


def test_softmax_tail_dtype_and_loss_scale_are_honoured():
    """``softmax_dtype`` keeps the CE tail in bf16 (the loss moves by a
    bf16 rounding, not more); a power-of-two ``loss_scale`` divides back
    out exactly."""
    feed = _feed("gpt_tiny", BATCH, 7)
    losses = {}
    for tag, mp in (("f32", MixedPrecision()),
                    ("bf16", MixedPrecision(softmax_dtype="bfloat16")),
                    ("scaled", MixedPrecision(loss_scale=1024.0))):
        psd = build_gpt(GPT_TINY, batch=BATCH, seq_len=SEQ, device="cpu")
        psd.training_config = _config("gpt_tiny", TrainingConfig, Sgd(0.1),
                                      mp)
        losses[tag] = (psd.fit(DeviceCachedIterator(
            feed["input_ids"], feed["targets"], batch_size=BATCH,
            device="cpu")).final_loss(), samediff_arrays_to_jax(psd))
    assert losses["bf16"][0] != losses["f32"][0]
    assert abs(losses["bf16"][0] - losses["f32"][0]) <= 2e-2
    for name, a in losses["f32"][1].items():
        assert np.array_equal(losses["scaled"][1][name], a), name
    assert losses["scaled"][0] == losses["f32"][0]


def test_jax_mlp_builder_fields_are_the_ports():
    """The fields ``_build_mlp_sd`` sets that this slice honours build the
    same config on both sides."""
    j = (JTrainingConfig.builder().updater(JAdam(learning_rate=1e-3))
         .data_set_feature_mapping("x").data_set_label_mapping("labels")
         .fused_steps(1).build())
    p = (TrainingConfig.builder().updater(Adam(learning_rate=1e-3))
         .data_set_feature_mapping("x").data_set_label_mapping("labels")
         .fused_steps(1).build())
    assert (j.data_set_feature_mapping, j.data_set_label_mapping,
            j.fused_steps) == (p.data_set_feature_mapping,
                               p.data_set_label_mapping, p.fused_steps)
    assert jnp.float32(j.updater.learning_rate) == p.updater.learning_rate
