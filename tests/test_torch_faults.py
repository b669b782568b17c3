"""The port's fault rails against ``deeplearning4j_tpu.faults``.

``FaultTolerantFit`` heals a poisoned batch by rolling back to the newest
checkpoint (fault, rollback, retry, recovered), and ends bit-equal to an
uninterrupted run when the source keys its batches by the iteration; a
permanent divergence spends the budget and aborts cleanly (a pinned
final checkpoint, the model at the last good state) after the same
decisions and backoffs as the JAX FaultTolerantFit, with ``sleep`` injected (no
wall-clock wait); ``lr_rescale`` rescales a numeric rate and captures no
window again. ``RetryingIterator``, the loss watchers and the chaos
injectors against the JAX ones on the same inputs; the refusals name
their ROADMAP queue item."""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.checkpoint as jck
import deeplearning4j_tpu.faults as jf
import deeplearning4j_tpu_torch.checkpoint as pck
import deeplearning4j_tpu_torch.faults as pf
from deeplearning4j_tpu.autodiff import Listener as JListener
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.learning import updaters as jup
from deeplearning4j_tpu_torch.autodiff import (Listener, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.learning import updaters as pup

FEATS, CLASSES, B = 8, 2, 16


def _mlp(pkg, fused_steps=4, accum_steps=1, sentinel=False, lr=1e-2):
    rng = np.random.default_rng(0)
    sd = JSameDiff() if pkg == "jax" else SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(-1, FEATS))
    w0 = sd.var("w0", value=rng.normal(0, .1, (FEATS, 16)).astype(
        np.float32))
    b0 = sd.var("b0", value=np.zeros(16, np.float32))
    h = sd.nn.relu(x.mmul(w0).add(b0))
    w1 = sd.var("w1", value=rng.normal(0, .1, (16, CLASSES)).astype(
        np.float32))
    labels = sd.placeholder("labels", shape=(-1, CLASSES))
    sd.loss.softmax_cross_entropy(h.mmul(w1), labels, name="loss")
    sd.set_loss_variables(["loss"])
    tc = JTrainingConfig if pkg == "jax" else TrainingConfig
    m = jup if pkg == "jax" else pup
    sd.training_config = tc(
        updater=m.Adam(lr), data_set_feature_mapping=["x"],
        data_set_label_mapping=["labels"], fused_steps=fused_steps,
        accum_steps=accum_steps, sentinel=sentinel)
    return sd


def _data(n=128, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, FEATS)).astype(np.float32)
    Y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return X, Y


def _batches(X, Y):
    return [(X[i:i + B], Y[i:i + B]) for i in range(0, len(X), B)]


class StepSource:
    """The batches of an epoch keyed by the model's absolute iteration:
    a pass runs from ``iteration_count`` to the end of its epoch, so a
    retry after a rollback resumes where the checkpoint stopped."""

    def __init__(self, batches, tc):
        self.batches, self.tc = batches, tc

    def __iter__(self):
        n = len(self.batches)
        for i in range(self.tc.iteration_count % n, n):
            yield self.batches[i]


def _state(sd):
    return ({k: v.clone() for k, v in sd.trainable_params().items()},
            [t.clone() for s in sd._updater_state.values() for t in s])


@pytest.mark.parametrize("accum", [1, 2])
def test_self_heal_rolls_back_and_ends_bit_equal(accum, tmp_path):
    """A batch poisoned at step 13 (one epoch of 24 steps, windows of 4,
    checkpoints every 8): the sentinel fires at the flush after the
    window holding 13, the run rolls back to step 8 and finishes
    bit-equal to the uninterrupted run, with no window made after the
    rollback."""
    X, Y = _data(24 * B)
    a = _mlp("port", accum_steps=accum, sentinel=True)
    a.fit(StepSource(_batches(X, Y), a.training_config), epochs=1,
          listeners=[pck.CheckpointListener(
              pck.CheckpointManager(tmp_path / "a"), every_n_iterations=8)])
    b = _mlp("port", accum_steps=accum)
    mgr = pck.CheckpointManager(tmp_path / "b", keep_last_n=5)
    chaos = pf.ChaosMonkey(seed=7)
    it = chaos.poison_batches(StepSource(_batches(X, Y), b.training_config),
                              at_step=13)
    ftf = pf.FaultTolerantFit(
        b, mgr, policy=pf.RetryPolicy(backoff_base=0.0,
                                      quarantine_corrupt=False),
        checkpoint_every_n_iterations=8, sleep=lambda s: None)
    assert b.training_config.sentinel is True
    ftf.fit(it, epochs=1)
    events = [e["event"] for e in ftf.events]
    assert events == ["fault", "rollback", "retry", "recovered"]
    fault, rollback = ftf.events[0], ftf.events[1]
    assert (fault["step"], fault["epoch"], fault["batch_index"]) == \
        (13, 0, 13)
    assert rollback["restored_step"] == 8 and ftf.rollbacks == 1
    assert b.captures_total == a.captures_total == 1
    assert b.training_config.iteration_count == 24
    assert b.training_config.epoch_count == 1
    assert mgr.all_steps() == [0, 8, 16, 24]
    (pa, sa), (pb, sb) = _state(a), _state(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert all(torch.equal(s, t) for s, t in zip(sa, sb))
    mgr.close()


def test_a_pre_step_snapshot_restores_the_initial_updater_state(tmp_path):
    """The rollback target taken before the first step holds no updater
    state: restoring it zeroes the live state a failed fit poisoned."""
    sd = _mlp("port")
    snap = pck.capture_training_state(sd)
    assert snap.updater_leaves is None
    X, Y = _data()
    with pf.ChaosMonkey().nan_gradients(sd, at_step=1):
        sd.fit(_batches(X, Y))
    assert any(torch.isnan(t).any() for s in sd._updater_state.values()
               for t in s)
    pck.restore_training_state(sd, snap)
    assert all(not t.any() for s in sd._updater_state.values() for t in s)
    assert sd.training_config.iteration_count == 0


def _run_exhaust(pkg, tmp_path, sleeps):
    sd = _mlp(pkg)
    X, Y = _data()
    mods = (jck, jf) if pkg == "jax" else (pck, pf)
    mgr = mods[0].CheckpointManager(tmp_path / pkg, keep_last_n=3)
    ftf = mods[1].FaultTolerantFit(
        sd, mgr, policy=mods[1].RetryPolicy(max_retries=3,
                                            backoff_base=0.25),
        checkpoint_every_n_iterations=4, sleep=sleeps.append)
    with mods[1].ChaosMonkey(seed=0).nan_gradients(sd, at_step=6):
        with pytest.raises(mods[1].FaultBudgetExhaustedError) as ei:
            ftf.fit(_batches(X, Y), epochs=2)
    assert isinstance(ei.value.__cause__, mods[1].TrainingDivergedError)
    params = {k: np.asarray(v) if pkg == "jax" else v.numpy()
              for k, v in sd.trainable_params().items()}
    for k, a in params.items():
        assert np.isfinite(a).all(), k
    pinned = mgr._pinned
    mgr.close()
    return ([e["event"] for e in ftf.events],
            [e.get("restored_step") for e in ftf.events
             if e["event"] == "rollback"], sleeps, pinned,
            sd.training_config.iteration_count)


def test_budget_exhaustion_matches_jax(tmp_path):
    jax_run = _run_exhaust("jax", tmp_path, [])
    port_run = _run_exhaust("port", tmp_path, [])
    assert port_run == jax_run
    events, restored, sleeps, pinned, it = port_run
    assert events[-1] == "retry_exhausted" and restored == [4] * 4
    assert sleeps == [0.25, 0.5, 1.0] and pinned == {4} and it == 4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lr_rescale_on_rollback(pkg, tmp_path):
    sd = _mlp(pkg, lr=1e-2)
    X, Y = _data()
    mods = (jck, jf) if pkg == "jax" else (pck, pf)
    it = mods[1].ChaosMonkey(seed=0).poison_batches(_batches(X, Y),
                                                    at_step=3)
    mgr = mods[0].CheckpointManager(tmp_path)
    ftf = mods[1].FaultTolerantFit(
        sd, mgr, policy=mods[1].RetryPolicy(
            max_retries=2, backoff_base=0.0, lr_rescale=0.5,
            quarantine_corrupt=False),
        checkpoint_every_n_iterations=2, sleep=lambda s: None)
    h = ftf.fit(it, epochs=2)
    assert np.isfinite(h.final_loss())
    assert ftf.rollbacks == 1
    assert sd.training_config.updater.learning_rate == pytest.approx(5e-3)
    if pkg == "port":
        # the rate is a staged scalar: the one window serves both rates
        assert sd.captures_total == 1
    mgr.close()


def test_quarantine_heals_without_rollback(tmp_path):
    sd = _mlp("port")
    X, Y = _data()
    it = pf.ChaosMonkey(seed=3).poison_batches(_batches(X, Y), at_step=2)
    mgr = pck.CheckpointManager(tmp_path)
    ftf = pf.FaultTolerantFit(sd, mgr, policy=pf.RetryPolicy(
        backoff_base=0.0), sleep=lambda s: None)
    h = ftf.fit(it, epochs=2)
    assert np.isfinite(h.final_loss()) and ftf.rollbacks == 0
    assert "quarantine" in [e["event"] for e in ftf.events]
    assert ftf.report()["rollbacks"] == 0
    mgr.close()


# ----------------------------------------------------------------------
# the data rail
def _drain(it):
    return [(np.asarray(x).copy(), np.asarray(y).copy()) for x, y in it]


@pytest.mark.parametrize("case", ["transient", "quarantine", "exhausted",
                                  "restart_fails"])
def test_retrying_iterator_matches_jax(case):
    X, Y = _data(96)
    out = []
    for mod in (jf, pf):
        chaos = mod.ChaosMonkey(seed=0)
        src = _batches(X, Y)
        if case == "transient":
            src = chaos.flaky_iterator(src, fail_at_batch=2)
        elif case == "quarantine":
            src = chaos.poison_batches(src, at_step=3)
        elif case in ("exhausted", "restart_fails"):
            src = chaos.flaky_iterator(
                src, fail_at_batch=1 if case == "exhausted" else 0,
                times=5)
        ri = mod.RetryingIterator(src, max_retries=2)
        try:
            got = _drain(ri)
            err = None
        except mod.DataPipelineError as e:
            got, err = None, (e.batch_index, e.cause)
        second = _drain(ri) if case == "quarantine" else None
        out.append((got, err, [(e["event"], e["batch_index"])
                               for e in ri.events], second,
                    sorted(ri.quarantined)))
    (jg, je, jev, js, jq), (pg, pe, pev, ps, pq) = out
    assert pe == je and pev == jev and pq == jq
    if jg is not None:
        assert len(pg) == len(jg)
        for (a, b), (c, d) in zip(pg, jg):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    if case == "quarantine":
        assert len(ps) == len(js) == 5 and pq == [3]


def test_corrupt_scan_reads_host_arrays_and_cpu_tensors_only():
    from deeplearning4j_tpu_torch.faults.iterators import batch_is_corrupt
    x = np.ones((2, 3), np.float32)
    assert not batch_is_corrupt((x, x))
    x[1, 1] = np.nan
    assert batch_is_corrupt((x, np.ones(2)))
    assert batch_is_corrupt({"a": torch.tensor([1.0, float("inf")])})
    assert not batch_is_corrupt(([torch.tensor([1, 2])], np.arange(3)))


@pytest.mark.parametrize("losses,kind", [
    ([1.0] * 25 + [50.0], "spike"),
    ([1.0, 0.9, float("nan")], "nan"),
    ([1.0 - 0.01 * i for i in range(40)], "none")])
def test_loss_spike_watcher_matches_jax(losses, kind):
    out = []
    for mod in (jf, pf):
        w = mod.LossSpikeWatcher(spike_factor=10.0, warmup=20)
        try:
            w.iterations_done(None, 0, list(range(len(losses))), losses)
            out.append(None)
        except mod.TrainingDivergedError as e:
            out.append((e.step, e.cause))
        w.reset()
        assert w._ema is None
    assert out[0] == out[1]
    assert (out[1] is None) == (kind == "none")


def test_plateau_watcher_matches_jax():
    means = [1.0, 0.8, 0.81, 0.82, 0.79, 0.795, 0.80]
    out = []
    for mod in (jf, pf):
        w = mod.PlateauWatcher(patience=2, min_delta=0.005)
        raised = None
        for e, m in enumerate(means):
            try:
                w.on_epoch_end(None, e, m)
            except mod.TrainingDivergedError as err:
                raised = (e, err.cause)
                break
        out.append(raised)
    assert out[0] == out[1] == (3, "plateau")
    assert pf.PlateauWatcher.frequency == jf.PlateauWatcher.frequency


def test_chaos_draws_match_jax_and_the_rest_is_refused():
    j, p = jf.ChaosMonkey(seed=11), pf.ChaosMonkey(seed=11)
    assert [p.draw_step(0, 100) for _ in range(5)] == \
        [j.draw_step(0, 100) for _ in range(5)]
    for name in ("torn_shard", "sigterm_listener", "host_killer",
                 "failing_exec", "transient_device_error"):
        assert hasattr(j, name)
        with pytest.raises(NotImplementedError,
                           match=f"ChaosMonkey.{name} .*queue 1 item 7"):
            getattr(p, name)
    with pytest.raises(AttributeError):
        p.no_such_injector
    poisoned = list(pf.ChaosMonkey().poison_batches(
        [(torch.ones(2), torch.zeros(2))], at_step=0))
    assert torch.isnan(poisoned[0][0]).all() and \
        torch.equal(poisoned[0][1], torch.zeros(2))


def test_fault_tolerant_fit_refuses_what_is_not_ported(tmp_path):
    sd = _mlp("port")
    with pytest.raises(NotImplementedError, match="queue 1 item 7: ui/"):
        pf.FaultTolerantFit(sd, pck.CheckpointManager(tmp_path),
                            stats_storage=object())
    names = {c.__name__ for c in pf.retryable_errors()}
    assert {"TrainingDivergedError", "DataPipelineError",
            "TransientDeviceError", "SilentCorruptionError",
            "CheckpointError"} <= names
    err = pf.SilentCorruptionError("x", check="stamp", expected=1, actual=2,
                                   step=3)
    assert err.provenance()["check"] == "stamp" and err.step == 3
    assert issubclass(pf.TrainingDivergedError, ArithmeticError)


def test_divergence_error_text_matches_jax():
    from deeplearning4j_tpu.faults.sentinels import \
        raise_diverged as jraise
    from deeplearning4j_tpu_torch.faults.sentinels import \
        raise_diverged as praise
    out = []
    for fn, err in ((jraise, jf.TrainingDivergedError),
                    (praise, pf.TrainingDivergedError)):
        with pytest.raises(err) as ei:
            fn(13, 1, 8)
        out.append((ei.value.provenance(), str(ei.value).split(";")[0]))
    assert out[0] == out[1]
