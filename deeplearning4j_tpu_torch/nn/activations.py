"""Activations of the slice (counterpart of
``deeplearning4j_tpu/nn/activations.py`` ``apply_activation``)."""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops.elementwise import relu, softmax

_ALIASES = {"identity": "identity", "linear": "identity", "relu": "relu",
            "softmax": "softmax"}
_FNS = {"identity": lambda x: x, "relu": relu, "softmax": softmax}


def resolve_activation(name: str) -> str:
    key = name.lower()
    if key not in _ALIASES:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet; known: "
            f"{sorted(_ALIASES)}")
    return _ALIASES[key]


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _FNS[resolve_activation(name)]


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    return activation_fn(name)(x)
