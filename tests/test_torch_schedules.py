"""The port's learning-rate schedules against
``deeplearning4j_tpu.learning.schedules``.

Each of the nine schedules at iterations 0-19 (and the epoch-typed ones
at epochs 0-19): the JAX value traced from an int32 iteration, as its
step computes it, against the port's host float32 value, rtol 1e-6
(``exp`` and ``pow`` may differ from XLA's by an ulp). Then the JSON
form both ways, ``resolve_lr``, and the schedules reaching the step
through ``IUpdater.step_scalars`` (Adam's ``alphat`` at the scheduled
rate)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.learning import schedules as js
from deeplearning4j_tpu.learning import updaters as jup
from deeplearning4j_tpu_torch.learning import schedules as ps
from deeplearning4j_tpu_torch.learning import updaters as pup

ITERS = range(20)

CASES = {
    "fixed": lambda m: m.FixedSchedule(value=0.05),
    "exponential": lambda m: m.ExponentialSchedule(initial_value=0.1,
                                                   gamma=0.93),
    "inverse": lambda m: m.InverseSchedule(initial_value=0.1, gamma=0.2,
                                           power=1.5),
    "poly": lambda m: m.PolySchedule(initial_value=0.1, power=2.0,
                                     max_iter=15),
    "sigmoid": lambda m: m.SigmoidSchedule(initial_value=0.1, gamma=0.5,
                                           step_size=10),
    "step": lambda m: m.StepSchedule(initial_value=0.1, decay_rate=0.5,
                                     step=4),
    "map": lambda m: m.MapSchedule(values={0: 0.1, 5: 0.05, 12: 0.01}),
    "ramp": lambda m: m.RampSchedule(
        base=m.StepSchedule(initial_value=0.1, decay_rate=0.1, step=16),
        num_iter=8),
    "cycle": lambda m: m.CycleSchedule(initial_lr=1e-3, max_lr=1e-2,
                                       cycle_length=20, annealing_length=4,
                                       annealing_decay=0.1),
}
EPOCH_CASES = {
    "exponential": lambda m: m.ExponentialSchedule(
        initial_value=0.1, gamma=0.8, schedule_type="EPOCH"),
    "step": lambda m: m.StepSchedule(initial_value=0.1, decay_rate=0.5,
                                     step=3, schedule_type="EPOCH"),
    "cycle": lambda m: m.CycleSchedule(
        initial_lr=1e-3, max_lr=1e-2, cycle_length=12, annealing_length=2,
        annealing_decay=0.5, schedule_type="EPOCH"),
}


def _jax_value(sched, it, epoch):
    return np.float32(sched.value_at(jnp.asarray(it, jnp.int32), epoch))


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_schedule_matches_jax_over_20_iterations(name):
    jsched, psched = CASES[name](js), CASES[name](ps)
    want = np.array([_jax_value(jsched, it, 0) for it in ITERS])
    got = np.array([ps.resolve_lr(psched, it, 0) for it in ITERS],
                   np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(got.tolist())) > 1 or name == "fixed"


@pytest.mark.parametrize("name", sorted(EPOCH_CASES))
def test_epoch_schedules_follow_the_epoch(name):
    jsched, psched = EPOCH_CASES[name](js), EPOCH_CASES[name](ps)
    for epoch in range(20):
        for it in (0, 7):
            np.testing.assert_allclose(
                ps.resolve_lr(psched, it, epoch),
                _jax_value(jsched, it, epoch), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_json_form_crosses_both_ways(name):
    jsched, psched = CASES[name](js), CASES[name](ps)
    assert json.loads(json.dumps(psched.to_json())) == \
        json.loads(json.dumps(jsched.to_json()))
    back = ps.ISchedule.from_json(json.loads(json.dumps(jsched.to_json())))
    jback = js.ISchedule.from_json(json.loads(json.dumps(psched.to_json())))
    assert type(back).__name__ == type(jsched).__name__
    for it in (0, 3, 11, 19):
        assert ps.resolve_lr(back, it, 0) == ps.resolve_lr(psched, it, 0)
        np.testing.assert_allclose(ps.resolve_lr(back, it, 0),
                                   _jax_value(jback, it, 0), rtol=1e-6)


def test_resolve_lr_takes_numbers_and_schedules_only():
    assert ps.resolve_lr(0.1, 5, 0) == float(np.float32(0.1))
    assert ps.resolve_lr(np.float64(0.25), 0, 0) == 0.25
    with pytest.raises(TypeError, match="number or an ISchedule"):
        ps.resolve_lr({0: 0.1}, 0, 0)
    with pytest.raises(ValueError, match="position 0"):
        ps.MapSchedule(values={3: 0.1})
    with pytest.raises(ValueError, match="base schedule"):
        ps.RampSchedule()


@pytest.mark.parametrize("name", ["exponential", "ramp", "cycle"])
def test_scheduled_updater_scalars_match_jax(name):
    """Adam's ``alphat`` at the scheduled rate and Nesterovs' rate, as
    the JAX updaters compute them inside their step."""
    for upd in ("adam", "nesterovs"):
        jsched, psched = CASES[name](js), CASES[name](ps)
        if upd == "adam":
            ju, pu = jup.Adam(learning_rate=jsched), \
                pup.Adam(learning_rate=psched)
        else:
            ju, pu = jup.Nesterovs(learning_rate=jsched), \
                pup.Nesterovs(learning_rate=psched)
        got = pu.step_scalars(ITERS)
        for it in ITERS:
            lr = js.resolve_lr(jsched, jnp.asarray(it, jnp.int32), 0)
            if upd == "adam":
                t = jnp.asarray(it, jnp.float32) + 1.0
                want = lr * jnp.sqrt(1.0 - ju.beta2 ** t) / \
                    (1.0 - ju.beta1 ** t)
            else:
                want = lr
            np.testing.assert_allclose(got[it], np.float32(want), rtol=2e-6)
        np.testing.assert_allclose(
            pu.learning_rates(ITERS),
            [_jax_value(jsched, it, 0) for it in ITERS], rtol=1e-6)


def test_updater_json_crosses_both_ways():
    ju = jup.Nesterovs(learning_rate=CASES["ramp"](js), momentum=0.8)
    pu = pup.IUpdater.from_json(json.loads(json.dumps(ju.to_json())))
    assert isinstance(pu, pup.Nesterovs) and pu.momentum == 0.8
    assert isinstance(pu.learning_rate, ps.RampSchedule)
    assert json.loads(json.dumps(pu.to_json())) == \
        json.loads(json.dumps(ju.to_json()))
    assert jup.IUpdater.from_json(pu.to_json()) == ju
