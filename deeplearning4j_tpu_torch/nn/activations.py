"""Activations of the slice (counterpart of
``deeplearning4j_tpu/nn/activations.py`` ``apply_activation``): identity,
relu, tanh and softmax; the others are refused by name (ROADMAP queue 1
item 1.2)."""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops.elementwise import relu, softmax, tanh

_ALIASES = {"identity": "identity", "linear": "identity", "relu": "relu",
            "tanh": "tanh", "softmax": "softmax"}
_FNS = {"identity": lambda x: x, "relu": relu, "tanh": tanh,
        "softmax": softmax}


def resolve_activation(name: str) -> str:
    key = name.lower()
    if key not in _ALIASES:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (ROADMAP queue 1 item "
            f"1.2); known: {sorted(_ALIASES)}")
    return _ALIASES[key]


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _FNS[resolve_activation(name)]


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    return activation_fn(name)(x)
