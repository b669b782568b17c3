"""The port's updaters against ``deeplearning4j_tpu.learning.updaters``:
five steps of the same seeded float32 gradients from the same parameters.
Tolerance 1e-6 relative (float32, the same operations in the same order
up to fused multiply-adds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import updaters as jup
from deeplearning4j_tpu_torch.learning import updaters as pup


@pytest.mark.parametrize("make", [
    lambda m: m.Sgd(learning_rate=0.05),
    lambda m: m.Nesterovs(learning_rate=0.1, momentum=0.9),
    lambda m: m.Nesterovs(learning_rate=0.01, momentum=0.5),
    lambda m: m.Adam(learning_rate=1e-3),
    lambda m: m.Adam(learning_rate=0.01, beta1=0.8, beta2=0.99,
                     epsilon=1e-6),
], ids=["sgd", "nesterovs", "nesterovs_lr0.01_mu0.5", "adam",
        "adam_lr0.01_b0.8_0.99"])
def test_five_steps_match_jax(make):
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    ju = make(jup)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = ju.init(jp)
    pu = make(pup)
    names = sorted(shapes)
    pp = [torch.tensor(params[k]) for k in names]
    pstate = pu.init(pp)
    for it, g in enumerate(grads):
        upd, state = ju.apply({k: jnp.asarray(v) for k, v in g.items()},
                              state, it)
        jp = {k: jp[k] - upd[k] for k in jp}
        pu.apply_(pp, [torch.as_tensor(g[k]) for k in names], pstate, it)
    for k, t in zip(names, pp):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6)


def test_schedules_are_not_ported_yet():
    """Schedules are ported (``learning/schedules.py``): a schedule's
    value is the step's rate; a rate that is neither a number nor a
    schedule is refused; the JAX updaters the port lacks are refused by
    name where their JSON form is read."""
    from deeplearning4j_tpu_torch.learning import StepSchedule
    u = pup.Sgd(learning_rate=StepSchedule(0.5, 0.1, 2))
    p = [torch.ones(1)]
    for it in range(3):
        u.apply_(p, [torch.ones(1)], [()], it)
    # 1 - 0.5 - 0.5 - 0.5 * 0.1^floor(2 / 2), in float32
    assert p[0].item() == -(np.float32(0.5) * np.float32(0.1))
    with pytest.raises(TypeError):
        pup.Sgd(learning_rate=object()).apply_(
            [torch.zeros(1)], [torch.zeros(1)], [()], 0)
    with pytest.raises(NotImplementedError,
                       match="queue 1 item 3: the other eight updaters"):
        pup.IUpdater.from_json({"@class": "RmsProp", "learning_rate": 0.1})


def test_adam_alphat_is_the_jax_float32_value():
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32, as the JAX
    package computes it inside its step (t = iteration + 1)."""
    ju, pu = jup.Adam(learning_rate=1e-3), pup.Adam(learning_rate=1e-3)
    for it in range(5):
        t = jnp.asarray(it, jnp.float32) + 1.0
        want = 1e-3 * jnp.sqrt(1.0 - ju.beta2 ** t) / (1.0 - ju.beta1 ** t)
        assert np.float32(pu.alphat(1e-3, it)) == np.asarray(
            want, np.float32)


def test_adam_updates_every_leaf_and_its_state_in_place():
    p = [torch.ones(3), torch.zeros(2, 2)]
    ids = [id(t) for t in p]
    u = pup.Adam(learning_rate=0.1)
    st = u.init(p)
    u.apply_(p, [torch.ones(3), -torch.ones(2, 2)], st, 0)
    assert [id(t) for t in p] == ids
    assert torch.allclose(p[0], torch.full((3,), 0.9))
    assert torch.allclose(p[1], torch.full((2, 2), 0.1))
    assert torch.allclose(st[0][0], torch.full((3,), 0.1))
    assert torch.allclose(st[1][1], torch.full((2, 2), 1e-3))


def _leaves(dtype, seed=1):
    """Leaves of several shapes and sizes (a scalar, a vector, a matrix, a
    4-d kernel), with seeded gradients for 4 steps."""
    rng = np.random.default_rng(seed)
    shapes = [(), (7,), (5, 3), (4, 3, 3, 2)]
    params = [torch.tensor(rng.normal(size=s), dtype=dtype) for s in shapes]
    grads = [[torch.tensor(rng.normal(size=s), dtype=dtype) for s in shapes]
             for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [
    lambda m: m.Sgd(learning_rate=0.05),
    lambda m: m.Nesterovs(learning_rate=0.1, momentum=0.9),
    lambda m: m.Nesterovs(learning_rate=0.01, momentum=0.5)],
    ids=["sgd", "nesterovs", "nesterovs_lr0.01_mu0.5"])
def test_foreach_update_equals_the_per_leaf_update_bit_for_bit(make, dtype):
    """``update_`` (multi-tensor ops over all leaves) against
    ``update_plain_`` (one leaf at a time, the JAX expression's order):
    every parameter and every velocity after each of 4 steps, with the
    step's learning rate a 0-d tensor."""
    u = make(pup)
    p_fe, grads = _leaves(dtype)
    p_pl = [p.clone() for p in p_fe]
    s_fe, s_pl = u.init(p_fe), u.init(p_pl)
    for it, g in enumerate(grads):
        lr = torch.tensor(u.step_scalars([it])[0], dtype=torch.float32)
        u.update_(p_fe, g, s_fe, lr)
        u.update_plain_(p_pl, g, s_pl, lr)
        for a, b in zip(p_fe + [t for s in s_fe for t in s],
                        p_pl + [t for s in s_pl for t in s]):
            assert a.dtype == dtype
            assert torch.equal(a, b)


def test_foreach_update_groups_leaves_and_keeps_the_bits(monkeypatch):
    """With groups of at most 12 elements (so the 4-d kernel is a group
    of its own and the rest split), the same bits as one group."""
    u = pup.Nesterovs(learning_rate=0.1, momentum=0.9)
    p_one, grads = _leaves(torch.float32)
    p_grp = [p.clone() for p in p_one]
    s_one, s_grp = u.init(p_one), u.init(p_grp)
    lr = torch.tensor(0.1)
    u.update_(p_one, grads[0], s_one, lr)
    monkeypatch.setattr(pup, "GROUP", 12)
    assert list(pup._groups(p_grp)) == [(0, 2), (2, 3), (3, 4)]
    u.update_(p_grp, grads[0], s_grp, lr)
    assert all(torch.equal(a, b) for a, b in zip(p_one, p_grp))


@pytest.mark.parametrize("make", [
    lambda m: m.Sgd(learning_rate=0.05),
    lambda m: m.Nesterovs(learning_rate=0.1, momentum=0.9)],
    ids=["sgd", "nesterovs"])
def test_three_steps_match_jax_f64(make):
    """Three steps of the ``_foreach`` update against the JAX updater in
    float64 (the learning rate, a float32 scalar in both, scales each
    step): to 1e-12 of each parameter."""
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 4), "b": (4,), "k": (3, 3, 2, 2)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s) for k, s in shapes.items()}
             for _ in range(3)]
    ju, pu = make(jup), make(pup)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = ju.init(jp)
    names = sorted(shapes)
    pp = [torch.tensor(params[k]) for k in names]
    pstate = pu.init(pp)
    for it, g in enumerate(grads):
        upd, state = ju.apply({k: jnp.asarray(v) for k, v in g.items()},
                              state, it)
        jp = {k: jp[k] - upd[k] for k in jp}
        pu.apply_(pp, [torch.tensor(g[k]) for k in names], pstate, it)
    for k, t in zip(names, pp):
        assert t.dtype == torch.float64 and jp[k].dtype == jnp.float64
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                   rtol=1e-12, atol=1e-12)
