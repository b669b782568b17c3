"""Activations by name (counterpart of
``deeplearning4j_tpu/nn/activations.py`` ``_ALIASES`` :9-33 and
``apply_activation`` :46): the JAX package's 25 names, each resolving to
the registry op of ``ops/elementwise.py`` that computes it. An unknown
name raises ``ValueError``, as there."""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops import registry

_ALIASES = {
    "identity": "identity", "linear": "identity", "relu": "relu",
    "relu6": "relu6", "leakyrelu": "leaky_relu", "leaky_relu": "leaky_relu",
    "elu": "elu", "selu": "selu", "gelu": "gelu", "sigmoid": "sigmoid",
    "hardsigmoid": "hard_sigmoid", "hard_sigmoid": "hard_sigmoid",
    "tanh": "tanh", "hardtanh": "hard_tanh", "hard_tanh": "hard_tanh",
    "softmax": "softmax", "softplus": "softplus", "softsign": "softsign",
    "swish": "swish", "mish": "mish", "cube": "cube",
    "thresholdedrelu": "thresholdedrelu",
    "thresholded_relu": "thresholdedrelu",
    "rationaltanh": "rationaltanh", "rectifiedtanh": "rectifiedtanh",
}


def resolve_activation(name: str) -> str:
    """Activation name -> registry op name."""
    key = name.lower()
    if key not in _ALIASES:
        raise ValueError(f"unknown activation {name!r}; "
                         f"known: {sorted(set(_ALIASES))}")
    return _ALIASES[key]


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return registry.get_op(resolve_activation(name)).fn


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    return activation_fn(name)(x)
