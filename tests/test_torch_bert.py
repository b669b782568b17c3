"""BERT imported from a frozen TF GraphDef: the port against the JAX package.

``build_bert_graphdef`` is a copy on both sides and must write the same
bytes; both packages import them (``bert_base``: the JAX importer, the
port's), so the weights are the .pb's under the TF node names on both
sides. BERT_TINY (hidden 32, 2 layers, 2 heads, ffn 64, vocab 128), batch
4, seq 16, a ragged mask (rows masked from 3 different positions) and
both token types:

- forward (sequence output, pooled output, loss): 1e-5 absolute in
  float32, 1e-10 in float64 (every trainable in float64 on both sides);
- every gradient, float32: 1e-5 of the tensor's largest magnitude, but
  for the attention's key biases, whose gradient is zero but for rounding
  on both sides (``KEY_BIASES``);
- three Adam steps through ``fit`` over a list of (features, labels)
  batches (the per-step tier, as ``tests/test_bert_import.py`` calls the
  JAX fit): the epoch's mean loss to 1e-5, every parameter to 1e-5 of its
  largest magnitude or 1e-4 of the learning rate, the larger (see the
  test; the key biases stay within 1e-8 of zero);
- one bf16 ``MixedPrecision`` step: every op's output dtype inside the
  port's step equals the JAX op's on the step's bf16-cast inputs (the
  float32 one-hot times the bf16 token-type table is float32, and so is
  everything after the embeddings), and the step's loss and updates
  against the JAX step's, with the limits stated at the test;
- the scanned tier against the per-step tier on the CPU, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import MixedPrecision as JMixedPrecision
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu.zoo import bert as jbert
from deeplearning4j_tpu_torch.autodiff import (MixedPrecision, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.convert import (samediff_arrays_from_jax,
                                              samediff_arrays_to_jax)
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.zoo import BERT_TINY, bert, bert_base

B, S, SEED = 4, 16, 7
FEATURES = ["input_ids", "input_mask", "token_type_ids"]
OUTPUTS = ["bert/encoder/sequence_output", "bert/pooler/output", "loss"]


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT_TINY.vocab_size, (n, S)).astype(np.int32)
    mask = np.ones((n, S), np.int32)
    for r, start in zip(range(n), (S // 2, 3, S, S - 1)):
        mask[r, start:] = 0
    tt = np.zeros((n, S), np.int32)
    tt[:, S // 2:] = 1
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return [ids, mask, tt], [labels]


def _feed(seed):
    f, l = _batch(seed)
    return {**dict(zip(FEATURES, f)), "labels": l[0]}


def _pair(dtype=None):
    jsd = jbert.bert_base(jbert.BERT_TINY, batch=B, seq_len=S, num_labels=2,
                          seed=SEED)
    psd = bert_base(BERT_TINY, batch=B, seq_len=S, num_labels=2, seed=SEED,
                    device="cpu")
    if dtype is not None:
        for n, a in jsd.trainable_params().items():
            jsd.set_arr_for_var(n, np.asarray(a).astype(dtype))
        for n, a in psd.trainable_params().items():
            psd.set_arr_for_var(n, a.numpy().astype(dtype))
    return jsd, psd


def _np(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) and \
        v.dtype == torch.bfloat16 else (
        v.detach().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(getattr(v, "data", v)))


def _rel(got, want):
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cfg_name,batch,seq", [("BERT_TINY", 2, 16),
                                                ("BERT_TINY", 4, 16)])
def test_graphdef_bytes_equal_jax(seed, cfg_name, batch, seq):
    want = jbert.build_bert_graphdef(getattr(jbert, cfg_name), batch, seq,
                                     seed)
    got = bert.build_bert_graphdef(getattr(bert, cfg_name), batch, seq, seed)
    assert got == want


def test_configs_are_the_jax_ones():
    for name in ("BERT_BASE", "BERT_TINY"):
        assert vars(getattr(bert, name)) == vars(getattr(jbert, name))
    assert bert.BERT_BASE.head_size == 64


def test_weights_are_the_jax_ones_by_name_shape_and_dtype():
    jsd, psd = _pair()
    want = {n: np.asarray(a) for n, a in jsd.trainable_params().items()}
    assert list(psd.trainable_params()) == list(want)
    got = samediff_arrays_to_jax(psd)
    for n, a in want.items():
        assert got[n].dtype == a.dtype == np.float32
        np.testing.assert_array_equal(got[n], a)
    # convert.py takes the JAX arrays (same names and layouts) ...
    samediff_arrays_from_jax({n: a * 2 for n, a in want.items()}, psd)
    np.testing.assert_array_equal(
        samediff_arrays_to_jax(psd)["classifier/kernel"],
        want["classifier/kernel"] * 2)
    # ... and refuses a shape or dtype it does not hold
    with pytest.raises(ValueError, match="does not match"):
        samediff_arrays_from_jax(
            {"classifier/bias": np.zeros(3, np.float32)}, psd)
    with pytest.raises(ValueError, match="does not match"):
        samediff_arrays_from_jax(
            {"classifier/bias": np.zeros(2, np.float64)}, psd)


def test_the_graph_records_the_jax_ops():
    jsd, psd = _pair()
    assert [(n.op, n.inputs, n.outputs) for n in psd.ops()] == \
        [(jsd._ops[n].op, jsd._ops[n].inputs, jsd._ops[n].outputs)
         for n in jsd._op_order]
    assert sorted({n.op for n in psd.ops()}) == [
        "add", "batched_matmul", "bias_add", "cast", "divide", "erf",
        "gather", "matmul", "multiply", "one_hot", "permute",
        "reduce_mean", "reshape", "rsqrt", "softmax",
        "softmax_cross_entropy", "squaredsubtract", "strided_slice_masked",
        "subtract", "tanh"]
    assert psd.placeholders() == jsd.placeholders()


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-10)])
def test_forward_with_a_ragged_mask_matches_jax(dtype, tol):
    jsd, psd = _pair(dtype)
    feed = _feed(1)
    want = jsd.output(placeholders=feed, outputs=OUTPUTS)
    got = psd.output(feed, OUTPUTS)
    for o in OUTPUTS:
        w, g = _np(want[o]), _np(got[o])
        assert g.dtype == w.dtype == (np.float32 if o == "loss" else dtype)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


#: the attention's key biases: each adds q . b_k to every score of a row,
#: which the softmax takes away, so their gradient is zero but for
#: rounding (about 1e-14 against gradients of 1e-3) on both sides
KEY_BIASES = {f"bert/encoder/layer_{i}/attention/self/key/bias"
              for i in range(BERT_TINY.num_layers)}


def _split_zero(grads):
    """(the tensors whose gradient is rounding noise, below 1e-9 of the
    largest gradient; the largest gradient)."""
    top = max(float(np.max(np.abs(g))) for g in grads.values())
    return {n for n, g in grads.items()
            if float(np.max(np.abs(g))) <= 1e-9 * top}, top


def test_every_gradient_matches_jax():
    jsd, psd = _pair()
    feed = _feed(2)
    want = {n: _np(g) for n, g in jsd.calculate_gradients(feed).items()}
    got = {n: _np(g) for n, g in psd.calculate_gradients(feed).items()}
    assert sorted(got) == sorted(want)
    zero_want, _ = _split_zero(want)
    zero_got, _ = _split_zero(got)
    assert zero_want == zero_got == KEY_BIASES
    for n, w in want.items():
        if n not in KEY_BIASES:
            assert _rel(got[n], w) <= 1e-5, n
    # the word table's rows of ids not in the batch get no gradient
    ids = feed["input_ids"]
    unused = np.setdiff1d(np.arange(BERT_TINY.vocab_size), ids)
    g = _np(got["bert/embeddings/word_embeddings"])
    assert np.all(g[unused] == 0) and np.all(np.abs(g[ids[0, 0]]) > 0)


def _config(cls, updater, mp=None):
    return cls(updater=updater, data_set_feature_mapping=FEATURES,
               data_set_label_mapping=["labels"], mixed_precision=mp)


def test_three_adam_steps_over_a_list_of_batches_match_jax():
    jsd, psd = _pair()
    jsd.training_config = _config(JTrainingConfig, JAdam(1e-3))
    psd.training_config = _config(TrainingConfig, Adam(1e-3))
    batches = [_batch(10 + s) for s in range(3)]
    jl = float(jsd.fit(batches, epochs=1).final_loss())   # the mean
    ph = psd.fit(batches)
    assert psd.last_fit_stats["tier"] == "per_step"
    assert len(ph.step_losses) == 3
    assert abs(ph.final_loss() - jl) <= 1e-5 * abs(jl), (jl, ph.step_losses)
    got = samediff_arrays_to_jax(psd)
    for n, a in jsd.trainable_params().items():
        if n in KEY_BIASES:
            # zero at the start; Adam's eps keeps a noise gradient's steps
            # near lr * 1e-14 / 1e-8 (reading: 1.5e-9 after 3 steps)
            assert np.max(np.abs(got[n])) <= 1e-8 and \
                np.max(np.abs(np.asarray(a))) <= 1e-8, n
            continue
        # Adam steps an element by up to lr * |g| / eps whatever |g| is, so
        # an element whose gradient is rounding noise on both sides (about
        # 1e-10) moves by a noise-sized fraction of lr: a tensor is held to
        # 1e-5 of its magnitude or 1e-4 of lr, the larger (readings: every
        # tensor within 1e-5 of its magnitude but the zero-initialised
        # biases, at 3 lr after 3 steps: worst 4.9e-8 = 4.9e-5 lr)
        a = np.asarray(a)
        assert float(np.max(np.abs(got[n] - a))) <= max(
            1e-5 * float(np.max(np.abs(a))), 1e-4 * 1e-3), n
    assert psd.training_config.iteration_count == 3


# One Sgd(0.1) step in bf16 on both sides at the test's data. Readings,
# port-vs-JAX bf16 / JAX bf16-vs-float32: loss 0 / 6.1e-6; each tensor's
# change against the JAX change, worst 3.1e-2 / 3.4e-2 (the attention's
# query and key kernels, whose gradients are small differences at
# near-uniform attention: a few bf16 units of their largest element),
# median 0 / 3.8e-3. The loss and median limits lie between the two
# readings; the worst limit is as GPT_TINY's (its two readings are of one
# size), and the record of every op's dtype catches a step left in
# float32 or run in bf16 after the embeddings.
BF16_LIMITS = (1e-6, 5e-2, 1e-3)


def test_bf16_step_keeps_the_jax_dtypes_and_matches_jax(monkeypatch):
    jsd, psd = _pair()
    before = {n: np.asarray(a) for n, a in jsd.trainable_params().items()}
    feed = _feed(20)
    # JAX: the ops' dtypes on the step's inputs (every floating parameter,
    # constant and placeholder cast to bf16, as the JAX step casts them)
    jcast = jbert.bert_base(jbert.BERT_TINY, batch=B, seq_len=S,
                            num_labels=2, seed=SEED)
    for n, a in {**jcast.trainable_params(), **jcast.constants_map()}.items():
        if jnp.issubdtype(a.dtype, jnp.floating):
            jcast.set_arr_for_var(n, jnp.asarray(a, jnp.bfloat16))
    names = [o for n in jcast._op_order for o in jcast._ops[n].outputs]
    jfeed = {**feed, "labels": jnp.asarray(feed["labels"], jnp.bfloat16)}
    jvals = jcast.output(placeholders=jfeed, outputs=names)
    want_dt = {o: str(np.asarray(v.data).dtype) for o, v in jvals.items()}
    # the port: the dtypes inside its train step
    seen = {}
    run_nodes = SameDiff._run_nodes

    def recording(nodes, env):
        run_nodes(nodes, env)
        for node in nodes:
            for o in node.outputs:
                seen[o] = str(env[o].dtype).replace("torch.", "")

    monkeypatch.setattr(SameDiff, "_run_nodes", staticmethod(recording))
    lr = 0.1
    jsd.training_config = _config(JTrainingConfig, JSgd(lr),
                                  JMixedPrecision())
    psd.training_config = _config(TrainingConfig, Sgd(lr), MixedPrecision())
    batch = _batch(20)
    jl = float(jsd.fit([batch], epochs=1).final_loss())
    pl = psd.fit([batch]).final_loss()
    assert seen == want_dt
    assert seen["bert/encoder/sequence_output"] == "float32"
    assert seen["bert/embeddings/gather"] == "bfloat16"
    assert seen["bert/embeddings/tt_matmul"] == "float32"
    loss_tol, worst_tol, median_tol = BF16_LIMITS
    assert abs(pl - jl) <= loss_tol * abs(jl), (jl, pl)
    got = samediff_arrays_to_jax(psd)
    rels = []
    for n, a in jsd.trainable_params().items():
        want = np.asarray(a) - before[n]
        assert got[n].dtype == np.float32
        if np.max(np.abs(want)) == 0:
            assert np.max(np.abs(got[n] - before[n])) == 0, n
            continue
        if n in KEY_BIASES:      # lr x a rounding-noise gradient
            assert np.max(np.abs(got[n])) <= 1e-9, n
            continue
        rels.append(_rel(got[n] - before[n], want))
        assert rels[-1] <= worst_tol, n
    assert float(np.median(rels)) <= median_tol, rels


def test_scanned_tier_equals_the_per_step_tier_on_cpu():
    feats = [np.concatenate(a) for a in zip(*[_batch(30 + s)[0]
                                              for s in range(4)])]
    labels = [np.concatenate([_batch(30 + s)[1][0] for s in range(4)])]
    res = {}
    for tier in ("scanned", "per_step"):
        sd = bert_base(BERT_TINY, batch=B, seq_len=S, num_labels=2,
                       seed=SEED, device="cpu")
        sd.training_config = _config(TrainingConfig, Adam(1e-3),
                                     MixedPrecision())
        it = DeviceCachedIterator(feats, labels, batch_size=B, device="cpu")
        h = sd.fit(it if tier == "scanned" else list(it), epochs=2)
        assert sd.last_fit_stats["tier"] == ("scanned_epoch"
                                             if tier == "scanned"
                                             else "per_step")
        res[tier] = (h.step_losses, sd.trainable_params())
    (la, pa), (lb, pb) = res["scanned"], res["per_step"]
    assert la == lb and len(la) == 8
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


def test_integer_inputs_are_bound_as_int32_and_never_cast():
    """The scanned tier binds the iterator's tensors as the step takes them:
    the ids, mask and token types stay int32 beside the float32 labels,
    and the bf16 policy casts only floating tensors inside the step."""
    sd = bert_base(BERT_TINY, batch=B, seq_len=S, num_labels=2, seed=SEED,
                   device="cpu")
    sd.training_config = _config(TrainingConfig, Adam(1e-3),
                                 MixedPrecision())
    f, l = _batch(50)
    sd.fit(DeviceCachedIterator(f, l, batch_size=B, device="cpu"))
    bound = sd._bound[2]
    assert {n: bound[n].dtype for n in bound} == {
        "input_ids": torch.int32, "input_mask": torch.int32,
        "token_type_ids": torch.int32, "labels": torch.float32}
    assert sd.last_fit_stats["tier"] == "scanned_epoch"


def test_a_batch_of_another_size_is_refused():
    """The graph is built for one batch size (its Reshape targets are
    constants), in both packages."""
    _, psd = _pair()
    psd.training_config = _config(TrainingConfig, Adam(1e-3))
    f, l = _batch(40, n=B - 1)
    with pytest.raises(RuntimeError):
        psd.fit([(f, l)])


def test_bert_base_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_base(BERT_TINY, batch=B, seq_len=S)
