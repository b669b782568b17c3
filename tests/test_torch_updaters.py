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
    u = pup.Sgd(learning_rate=object())
    with pytest.raises(NotImplementedError):
        u.apply_([torch.zeros(1)], [torch.zeros(1)], [()], 0)


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
