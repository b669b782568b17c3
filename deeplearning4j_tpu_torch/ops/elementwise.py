"""Elementwise ops of the slices (counterpart of
``deeplearning4j_tpu/ops/elementwise.py``: ``rsqrt`` :33, ``square`` :34,
``cube`` :35, ``neg`` :37, ``tanh`` :53, ``erf`` :58, ``identity`` :71,
the activations (``sigmoid`` :75, ``hard_sigmoid`` :85, ``hard_tanh``
:91, ``relu`` :96, ``relu6`` :101, ``leaky_relu`` :106, ``elu`` :111,
``selu`` :116, ``gelu`` :126, ``softplus`` :132, ``softsign`` :137,
``swish`` :142, ``mish`` :147, ``rationaltanh`` :152, ``rectifiedtanh``
:158, ``thresholdedrelu`` :163), ``cast`` :222,
``softmax`` :233).

A constant of an activation (the leak, the threshold, the hard
sigmoid's slope) takes x's dtype, as the JAX package's weak-typed Python
scalars do; ``softplus`` and ``mish`` are ``logaddexp(x, 0)``, as
``jax.nn.softplus`` (PyTorch's ``softplus`` returns x itself above its
threshold). The clipped activations (``relu6``, ``hard_tanh``,
``hard_sigmoid``, ``rectifiedtanh``) take JAX's gradient where x sits on a bound: half
(``jnp.clip`` is ``minimum(maximum(...))``, whose ties split), where
``torch.clamp`` passes it whole (:func:`jax_clip`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.dtypes import torch_dtype
from deeplearning4j_tpu_torch.ops.registry import op

_E = "elementwise"


@op("identity", _E, n_inputs=1, aliases=("linear",))
def identity(x):
    return x


@op("relu", _E, n_inputs=1)
def relu(x):
    return torch.relu(x)


@op("square", _E, n_inputs=1)
def square(x):
    return x * x


@op("cube", _E, n_inputs=1)
def cube(x):
    return x * x * x


@op("sigmoid", _E, n_inputs=1)
def sigmoid(x):
    return torch.sigmoid(x)


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(dy.dtype)
        tie = ((x == ctx.lo) | (x == ctx.hi)).to(dy.dtype)
        return dy * (inside + 0.5 * tie), None, None


def jax_clip(x, lo: float, hi: float):
    """``clamp(x, lo, hi)`` whose gradient is halved where x is on a
    bound, as ``jnp.clip``'s."""
    return _Clip.apply(x, lo, hi)


@op("hard_sigmoid", _E, n_inputs=1, aliases=("hardsigmoid",))
def hard_sigmoid(x):
    """``clip(0.2 * x + 0.5, 0, 1)``."""
    return jax_clip(0.2 * x + 0.5, 0.0, 1.0)


@op("hard_tanh", _E, n_inputs=1, aliases=("hardtanh",))
def hard_tanh(x):
    return jax_clip(x, -1.0, 1.0)


@op("relu6", _E, n_inputs=1)
def relu6(x):
    return jax_clip(x, 0.0, 6.0)


@op("leaky_relu", _E, n_inputs=1, aliases=("leakyrelu",))
def leaky_relu(x, alpha: float = 0.01):
    """``x`` where ``x >= 0``, else ``alpha * x``."""
    return torch.where(x >= 0, x, alpha * x)


@op("elu", _E, n_inputs=1)
def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


@op("selu", _E, n_inputs=1)
def selu(x):
    return F.selu(x)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@op("softplus", _E, n_inputs=1)
def softplus(x):
    return _softplus(x)


@op("softsign", _E, n_inputs=1)
def softsign(x):
    return x / (1.0 + torch.abs(x))


@op("swish", _E, n_inputs=1, aliases=("silu",))
def swish(x):
    return F.silu(x)


@op("mish", _E, n_inputs=1)
def mish(x):
    return x * torch.tanh(_softplus(x))


@op("rationaltanh", _E, n_inputs=1)
def rationaltanh(x):
    """``1.7159 * tanh(2 * x / 3)``."""
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


@op("rectifiedtanh", _E, n_inputs=1)
def rectifiedtanh(x):
    return jax_clip(torch.tanh(x), 0.0, float("inf"))


@op("thresholdedrelu", _E, n_inputs=1)
def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


@op("gelu", _E, n_inputs=1)
def gelu(x, precise: bool = False):
    """The tanh approximation unless ``precise`` (the JAX op's
    ``approximate=not precise``)."""
    return F.gelu(x, approximate="none" if precise else "tanh")


@op("softmax", _E, n_inputs=1)
def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


@op("rsqrt", _E, n_inputs=1)
def rsqrt(x):
    return torch.rsqrt(x)


@op("neg", _E, n_inputs=1, aliases=("negative",))
def neg(x):
    return torch.neg(x)


@op("tanh", _E, n_inputs=1)
def tanh(x):
    return torch.tanh(x)


@op("erf", _E, n_inputs=1)
def erf(x):
    return torch.erf(x)


@op("cast", _E, n_inputs=1)
def cast(x, dtype: str):
    """``x`` in ``dtype`` (a name such as ``"float32"``; a float cast to an
    integer truncates toward zero, as numpy's)."""
    return x.to(torch_dtype(dtype))
