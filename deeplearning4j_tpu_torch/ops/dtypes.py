"""The result dtype of an op over several tensors: JAX's promotion rule.

Counterpart of JAX's type lattice (``jnp.result_type``, ``jnp.promote_types``)
as the JAX package's registry ops meet it: every op there is a ``jnp`` call,
so its inputs are promoted by that rule. PyTorch's own rule differs in two
places that an imported graph under ``MixedPrecision`` reaches:

- a 0-d tensor counts as fully as any other (torch lets an n-d tensor of the
  same kind win: 0-d float32 x bfloat16 is bfloat16 in torch, float32 here);
- ``matmul`` promotes (torch raises on float32 @ bfloat16).

The lattice: bool < the integers < the floats. Among the floats bfloat16
and float16 join at float32; otherwise the wider wins. Among the integers a
signed type wins over a narrower unsigned one, and an unsigned one as wide
or wider is joined with the next wider signed type (uint8 with int8 is
int16). Every op of the registry that takes two or more tensors runs its
inputs through :func:`promote`.

A python scalar is weak: it never widens a tensor of its kind or a higher
one. Beside only bools, a python int gives the default integer; beside
bools or integers, a python float gives the default float. The defaults
are float32 and int32, JAX's without 64-bit mode, which is how the JAX
package runs outside its tests.
"""
from __future__ import annotations

from typing import Tuple

import torch

_FLOAT_WIDTH = {torch.float16: 16, torch.bfloat16: 16, torch.float32: 32,
                torch.float64: 64}
_INT_WIDTH = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
              torch.int64: 64}
_UINT_WIDTH = {torch.uint8: 8}
_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32,
           64: torch.int64}
DEFAULT_FLOAT = torch.float32
DEFAULT_INT = torch.int32
_NAMES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def torch_dtype(name) -> torch.dtype:
    """A torch dtype from its name (numpy's: ``"float32"``, ...)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _NAMES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _join_floats(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    if a == b:
        return a
    if {a, b} == {torch.float16, torch.bfloat16}:
        return torch.float32
    return a if _FLOAT_WIDTH[a] > _FLOAT_WIDTH[b] else b


def _join_ints(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    if a == b:
        return a
    ua, ub = a in _UINT_WIDTH, b in _UINT_WIDTH
    if ua == ub:                   # both signed (the port has one unsigned)
        return a if _INT_WIDTH[a] > _INT_WIDTH[b] else b
    u, s = (a, b) if ua else (b, a)
    if _INT_WIDTH[s] > _UINT_WIDTH[u]:
        return s
    return _SIGNED[min(64, 2 * _UINT_WIDTH[u])]


def promote_types(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """JAX's join of two tensor dtypes (``jnp.promote_types``)."""
    if a == b:
        return a
    if a == torch.bool:
        return b
    if b == torch.bool:
        return a
    fa, fb = a in _FLOAT_WIDTH, b in _FLOAT_WIDTH
    if fa and fb:
        return _join_floats(a, b)
    if fa:
        return a
    if fb:
        return b
    return _join_ints(a, b)


def result_type(*args) -> torch.dtype:
    """The dtype JAX gives an op over ``args``: tensors (of any rank) and
    weak python scalars (bool, int, float)."""
    dt = None
    weak = torch.bool
    for a in args:
        if isinstance(a, torch.Tensor):
            dt = a.dtype if dt is None else promote_types(dt, a.dtype)
        elif isinstance(a, bool):
            pass
        elif isinstance(a, int):
            weak = weak if weak == DEFAULT_FLOAT else DEFAULT_INT
        elif isinstance(a, float):
            weak = DEFAULT_FLOAT
        else:
            raise TypeError(f"cannot promote {type(a).__name__}")
    if dt is None:
        return weak
    if weak == DEFAULT_FLOAT and dt not in _FLOAT_WIDTH:
        return DEFAULT_FLOAT
    if weak == DEFAULT_INT and dt == torch.bool:
        return DEFAULT_INT
    return dt


def promote(*args) -> Tuple:
    """``args`` with every tensor cast to :func:`result_type` (a tensor
    already of that dtype is returned as it is; python scalars stay python
    scalars, which torch then takes at the tensors' dtype)."""
    dt = result_type(*args)
    return tuple(a.to(dt) if isinstance(a, torch.Tensor) and a.dtype != dt
                 else a for a in args)


def inexact(dt: torch.dtype) -> torch.dtype:
    """The float dtype a true division of ``dt`` gives (JAX: int64 to
    float64, other integers and bool to float32)."""
    if dt in _FLOAT_WIDTH:
        return dt
    return torch.float64 if dt == torch.int64 else torch.float32
