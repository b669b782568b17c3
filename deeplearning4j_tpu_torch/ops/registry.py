"""Named-op registry.

Counterpart of ``deeplearning4j_tpu/ops/registry.py`` (``op`` :50,
``get_op`` :69, ``has_op``, ``op_names`` :90, ``exec_op`` :103). An op is
a function over torch tensors plus keyword attributes, returning one
tensor or a tuple; SameDiff records op names and runs these functions.
The port registers the ops of its graphs (the SameDiff MLP, LeNet, the
zoo's GPT and what the TF importer emits for BERT and the import tests);
the op-trace tools wait.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    fn: Callable
    category: str
    n_inputs: Optional[int]  # None = variadic
    aliases: Tuple[str, ...] = ()


_REGISTRY: Dict[str, Op] = {}


def op(name: str, category: str, n_inputs: Optional[int] = None,
       aliases: Sequence[str] = ()):
    """Decorator: register a function over tensors as a named op."""
    def deco(fn: Callable) -> Callable:
        o = Op(name=name, fn=fn, category=category, n_inputs=n_inputs,
               aliases=tuple(aliases))
        for n in (name, *aliases):
            if n in _REGISTRY:
                raise ValueError(f"duplicate op registration: {n}")
            _REGISTRY[n] = o
        return fn
    return deco


def get_op(name: str) -> Op:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown op: {name!r}; {len(op_names())} ops "
                       f"registered") from None


def has_op(name: str) -> bool:
    _ensure_loaded()
    return name in _REGISTRY


def op_names() -> List[str]:
    _ensure_loaded()
    return sorted({o.name for o in _REGISTRY.values()})


def exec_op(name: str, *args, **attrs):
    """Execute by name; numpy arrays and numpy scalars become tensors."""
    o = get_op(name)
    targs = [torch.as_tensor(a) if isinstance(a, (np.ndarray, np.generic))
             else a for a in args]
    return o.fn(*targs, **attrs)


_LOADED = False


def _ensure_loaded() -> None:
    """Import the op modules (registration side effects)."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from deeplearning4j_tpu_torch.ops import (  # noqa: F401
        elementwise, linalg, loss, nn_ext, nn_ops, pairwise, random,
        reduce, shape_ops, tf_compat)
