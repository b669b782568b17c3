"""Op namespaces on SameDiff: ``sd.nn`` and ``sd.loss``.

Counterpart of ``deeplearning4j_tpu/autodiff/ops_namespaces.py``: a
namespace is a view over the op registry, so every registered op of its
categories is a method that records a graph node. Positional SDVariable
arguments become graph inputs; other positional arguments bind to the op
function's parameter names as static attributes; keyword arguments are
static attributes. This slice ports the two namespaces the SameDiff MLP
and the zoo's GPT call.
"""
from __future__ import annotations

import inspect
from typing import Dict, Optional

from deeplearning4j_tpu_torch.autodiff.variable import SDVariable
from deeplearning4j_tpu_torch.ops import registry

# categories where bare numeric positional args are operands, not attrs
_LIFT_CATEGORIES = {"pairwise", "elementwise", "linalg"}
# variable-output ops: the attribute giving the output count
_VARIADIC_OUT = {"split": "num_split"}


def _positional_names(fn):
    params = inspect.signature(fn).parameters.values()
    return [p.name for p in params
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)]


class OpCaller:
    __slots__ = ("_sd", "_op")

    def __init__(self, sd, op: registry.Op):
        self._sd = sd
        self._op = op

    def __call__(self, *args, name: Optional[str] = None,
                 n_outputs: Optional[int] = None, **attrs):
        sd, o = self._sd, self._op
        pos_names = _positional_names(o.fn)
        inputs, static = [], dict(attrs)
        for i, a in enumerate(args):
            if isinstance(a, SDVariable):
                inputs.append(a)
            elif o.category in _LIFT_CATEGORIES:
                inputs.append(sd._lift(a))
            else:
                static[pos_names[i] if i < len(pos_names) else f"arg{i}"] = a
        if n_outputs is None:
            key = _VARIADIC_OUT.get(o.name)
            n_outputs = int(static[key]) if key in static else 1
        return sd.invoke(o.name, inputs, static, name=name,
                         n_outputs=n_outputs)


class OpNamespace:
    """One namespace; methods resolve lazily from the registry."""

    def __init__(self, sd, label: str, categories):
        self._sd = sd
        self._label = label
        self._categories = frozenset(categories)

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        if registry.has_op(item):
            o = registry.get_op(item)
            if o.category in self._categories:
                return OpCaller(self._sd, o)
        raise AttributeError(
            f"no op {item!r} in namespace {self._label} (categories "
            f"{sorted(self._categories)})")


def make_namespaces(sd) -> Dict[str, OpNamespace]:
    return {"nn": OpNamespace(sd, "nn", ("nn", "elementwise", "loss")),
            "loss": OpNamespace(sd, "loss", ("loss",))}
