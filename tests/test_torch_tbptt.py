"""SameDiff state variables and ``MultiLayerNetwork.fit_tbptt`` in the
port against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages, each network drawing
its own seed's weights (the same arrays on both sides). float32,
tolerance 1e-5 of each tensor's largest magnitude (the rounding of a
few Adam steps over a recurrence; ``tests/test_torch_lstm.py``'s), for
every chunk's loss, every parameter and every carried state. Tiny sizes:
vocab 12, units 8, T 13 in chunks of 5 (a ragged tail of 3).
"""
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu.zoo.models import TextGenLSTM as JTextGen
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.faults import ChaosMonkey, TrainingDivergedError
from deeplearning4j_tpu_torch.learning import Sgd
from deeplearning4j_tpu_torch.zoo import TextGenLSTM

V, U, TOL = 12, 8, 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _chars(n, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _pair(seed=5, **kw):
    return (JTextGen(vocab_size=V, units=U, seed=seed, **kw).build(),
            TextGenLSTM(vocab_size=V, units=U, seed=seed, **kw).build(
                device="cpu"))


# ----------------------------------------------------------------------
# SameDiff state variables
def _state_graph(cls, tc_cls, sgd, **kw):
    """y = x @ w + s; the state s takes mean(x @ w) + s after each step."""
    sd = cls(**kw)
    x = sd.placeholder("x", shape=(-1, 3))
    lab = sd.placeholder("y", shape=(-1, 2))
    w = sd.var("w", value=np.arange(6, dtype=np.float32).reshape(3, 2) / 7)
    s = sd.state_var("s", np.zeros((2,), np.float32))
    xw = x.mmul(w)
    out = xw.add(s, name="out")
    sd.invoke("reduce_mean", [xw], {"axis": (0,)}, name="m")
    sd.invoke("add", [sd.get_variable("m"), s], {}, name="s_new")
    sd.update_state(s, "s_new")
    d2 = sd.invoke("squaredsubtract", [out, lab], {}, name="d2")
    sd.invoke("reduce_mean", [d2], {}, name="loss").mark_as_loss()
    sd.training_config = tc_cls(updater=sgd(learning_rate=0.1),
                                data_set_feature_mapping=["x"],
                                data_set_label_mapping=["y"])
    return sd


def test_state_vars_are_carried_by_the_step_and_not_trained():
    jsd = _state_graph(JSameDiff, JTrainingConfig, JSgd)
    psd = _state_graph(SameDiff, TrainingConfig, Sgd, device="cpu")
    assert list(psd.trainable_params()) == ["w"]
    assert list(psd.state_vars_map()) == ["s"]
    assert list(jsd.trainable_params()) == ["w"]
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(4, 3)).astype(np.float32),
                rng.normal(size=(4, 2)).astype(np.float32)) for _ in range(3)]
    jh = jsd.fit(batches, epochs=1)
    ph = psd.fit(batches, epochs=1)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=TOL)
    _close(psd.get_arr_for_var("w"), jsd.get_arr_for_var("w").to_numpy())
    _close(psd.get_arr_for_var("s"), jsd.get_arr_for_var("s").to_numpy())
    assert psd.get_arr_for_var("s").abs().sum() > 0
    # the state var feeds output() too
    x = batches[0][0]
    _close(psd.output({"x": x}, ["out"])["out"],
           jsd.output({"x": x}, ["out"])["out"].to_numpy())
    psd.rename_variable("s", "carry")
    assert list(psd.state_vars_map()) == ["carry"]
    assert psd._state_updates == {"carry": "s_new"}
    with pytest.raises(ValueError, match="not a state var"):
        psd.update_state("w", "s_new")


# ----------------------------------------------------------------------
# fit_tbptt
def _jax_states(jnet, batch):
    jsd = jnet._tbptt_graphs[("tbptt", batch)][0]
    return {n: np.asarray(a) for n, a in jsd.state_vars_map().items()}


def test_fit_tbptt_with_a_ragged_tail_matches_jax():
    """T 13 in chunks of 5: two full chunks as one window and a tail of 3
    as one step, two minibatches, two epochs; every chunk's loss, the
    parameters and the carried states after it."""
    jnet, pnet = _pair()
    x, y = _chars(8, 13, 1)
    jh = jnet.fit_tbptt(x, y, 5, epochs=2, batch_size=4)
    ph = pnet.fit_tbptt(x, y, 5, epochs=2, batch_size=4)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=TOL)
    assert len(ph.step_losses) == 2 * 2 * 3
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a)
    sd, states = pnet._tbptt_graphs[4]
    assert states == ["layer0_lstm_h0_state", "layer0_lstm_c0_state",
                      "layer1_lstm_h0_state", "layer1_lstm_c0_state"]
    want = _jax_states(jnet, 4)
    assert sorted(want) == sorted(states)
    for n in states:
        _close(sd.state_vars_map()[n], want[n])
    st = sd.last_fit_stats
    assert (st["tier"], st["chunks_per_minibatch"], st["eager_steps_per_epoch"],
            st["window_captures_by_epoch"], st["steps_per_epoch"]) == \
        ("tbptt", 3, 2, [1, 0], 6)
    assert sd.training_config.iteration_count == 12
    # a second call resumes the TBPTT graph's Adam state, as in JAX
    jh = jnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    ph = pnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=TOL)
    for n, a in jnet.params().items():
        _close(pnet.params()[n], a)


def test_fit_tbptt_captures_its_window_once_and_shares_the_weights():
    _, pnet = _pair()
    x, y = _chars(8, 10, 2)
    pnet.fit_tbptt(x, y, 5, epochs=2, batch_size=4)
    sd, _ = pnet._tbptt_graphs[4]
    assert sd.last_fit_stats["window_captures_by_epoch"] == [1, 0]
    assert sd.last_fit_stats["eager_steps_per_epoch"] == 0
    for n, t in sd.trainable_params().items():
        assert t is pnet.samediff._arrays[n]     # the trained weights
    # a replaced parameter is taken up by the next fit_tbptt
    w = pnet.params()["layer2_rnnout_W"]
    pnet.set_param("layer2_rnnout_W", np.zeros_like(w))
    pnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    assert sd._arrays["layer2_rnnout_W"] is \
        pnet.samediff._arrays["layer2_rnnout_W"]
    assert sd.last_fit_stats["window_captures"] == 1


def test_fit_tbptt_drops_the_partial_batch_with_the_jax_warning():
    jnet, pnet = _pair()
    x, y = _chars(9, 10, 3)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jh = jnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    with pytest.warns(UserWarning) as pw:
        ph = pnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    jmsg = [str(w.message) for w in jw if "dropping" in str(w.message)]
    pmsg = [str(w.message) for w in pw if "dropping" in str(w.message)]
    assert pmsg == jmsg == ["fit_tbptt: dropping 1 of 9 sequences that do "
                            "not fill a full batch of 4 (TBPTT state vars "
                            "have a fixed batch dimension)"]
    np.testing.assert_allclose(ph.epoch_losses, jh.loss_curve.losses,
                               rtol=TOL)


def test_tbptt_full_length_equals_bptt():
    """tbptt_length >= T is full BPTT: the same losses and parameters as
    ``fit`` from the same seed (the JAX test of the same name)."""
    _, a = _pair(seed=7)
    _, b = _pair(seed=7)
    x, y = _chars(8, 9, 4)
    ha = a.fit(x, y, epochs=3, batch_size=4)
    hb = b.fit_tbptt(x, y, tbptt_length=9, epochs=3, batch_size=4)
    np.testing.assert_allclose(hb.epoch_losses, ha.epoch_losses, rtol=TOL)
    for n, t in a.params().items():
        _close(b.params()[n], t)


def test_truncation_changes_the_trajectory():
    _, a = _pair(seed=3)
    _, b = _pair(seed=3)
    x, y = _chars(8, 12, 5)
    ha = a.fit_tbptt(x, y, 4, epochs=4, batch_size=4)
    hb = b.fit_tbptt(x, y, 12, epochs=4, batch_size=4)
    assert np.isfinite(ha.epoch_losses).all()
    assert ha.epoch_losses[-1] < ha.epoch_losses[0]
    assert abs(ha.epoch_losses[-1] - hb.epoch_losses[-1]) > 1e-7


@pytest.mark.parametrize("x,y,match", [
    (np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32),
     "sequence features"),
    (np.zeros((4, 5, V), np.float32), np.zeros((4, 6, V), np.float32),
     "labels T=6"),
    (np.zeros((3, 5, V), np.float32), np.zeros((3, 5, V), np.float32),
     "smaller than one batch"),
])
def test_fit_tbptt_rejects_what_jax_rejects(x, y, match):
    _, pnet = _pair()
    with pytest.raises(ValueError, match=match):
        pnet.fit_tbptt(x, y, 2, batch_size=4)


def test_fit_tbptt_takes_tensors_and_keeps_the_sentinel():
    """Device-cached tensors feed the TBPTT tier; an armed sentinel follows
    onto the TBPTT graph and names the poisoned chunk."""
    _, pnet = _pair()
    x, y = _chars(8, 10, 6)
    pnet.fit(x[:4], y[:4], batch_size=4, sentinel=True)
    h = pnet.fit_tbptt(torch.tensor(x), torch.tensor(y), 5, epochs=1,
                       batch_size=4)
    assert np.isfinite(h.epoch_losses).all()
    sd, _ = pnet._tbptt_graphs[4]
    assert sd.training_config.sentinel
    start = sd.training_config.iteration_count
    with ChaosMonkey(seed=0).nan_gradients(sd, at_step=start + 3):
        with pytest.raises(TrainingDivergedError) as ei:
            pnet.fit_tbptt(x, y, 5, epochs=1, batch_size=4)
    assert ei.value.step == start + 3
    assert ei.value.cause == "device_sentinel"


def test_fit_tbptt_states_restart_at_zero_each_minibatch():
    """The carried states at the end are the last minibatch's alone: two
    copies of one minibatch leave the states one copy leaves, from the
    same weights and an Sgd step of 0."""
    x, y = _chars(4, 10, 7)
    ends = []
    for reps in (1, 2):
        _, net = _pair(updater=None)
        net.conf.updater = Sgd(learning_rate=0.0)
        net.init(device="cpu")
        net.fit_tbptt(np.concatenate([x] * reps), np.concatenate([y] * reps),
                      5, epochs=1, batch_size=4)
        sd, states = net._tbptt_graphs[4]
        ends.append([sd.state_vars_map()[n].clone() for n in states])
    for a, b in zip(*ends):
        assert torch.equal(a, b)
    assert any(t.abs().sum() > 0 for t in ends[0])


def test_a_checkpoint_holds_the_state_vars_as_the_jax_one_does():
    from deeplearning4j_tpu.checkpoint import \
        capture_training_state as jcapture
    from deeplearning4j_tpu_torch.checkpoint import (capture_training_state,
                                                     restore_training_state)
    jsd = _state_graph(JSameDiff, JTrainingConfig, JSgd)
    psd = _state_graph(SameDiff, TrainingConfig, Sgd, device="cpu")
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(4, 3)).astype(np.float32),
                rng.normal(size=(4, 2)).astype(np.float32)) for _ in range(2)]
    jsd.fit(batches, epochs=1)
    psd.fit(batches, epochs=1)
    js, ps = jcapture(jsd), capture_training_state(psd)
    assert sorted(ps.arrays) == sorted(js.arrays) == ["s", "w"]
    _close(ps.arrays["s"], js.arrays["s"])
    fresh = _state_graph(SameDiff, TrainingConfig, Sgd, device="cpu")
    restore_training_state(fresh, js)
    _close(fresh.get_arr_for_var("s"), js.arrays["s"])
