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
], ids=["sgd", "nesterovs", "nesterovs_lr0.01_mu0.5"])
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
