"""SDVariable: a named variable of a SameDiff graph.

Counterpart of ``deeplearning4j_tpu/autodiff/variable.py`` (``SDVariable``,
``VariableType``). A variable is a graph name:

- VARIABLE    : trainable parameter (has a value; receives gradients)
- CONSTANT    : fixed value (no gradient)
- PLACEHOLDER : fed at execution time
- ARRAY       : output of an op (computed, never stored)

This slice ports the attributes and the op sugar the SameDiff MLP and the
zoo's GPT use; the rest of the JAX class waits.
"""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff


class VariableType(enum.Enum):
    VARIABLE = "VARIABLE"
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"


class SDVariable:
    __slots__ = ("sd", "name", "var_type", "_shape", "_dtype")

    def __init__(self, sd: "SameDiff", name: str, var_type: VariableType,
                 shape: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32"):
        self.sd = sd
        self.name = name
        self.var_type = var_type
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.var_type.value}, "
                f"shape={self._shape}, dtype={self._dtype})")

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        if self._shape is None:
            self._shape = self.sd.infer_shape(self.name)
        return self._shape

    @property
    def dtype(self) -> str:
        return self._dtype

    # value access ------------------------------------------------------
    def eval(self, placeholders=None):
        """This variable's value (reference: SDVariable.eval())."""
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def get_arr(self):
        """The stored value of a VARIABLE or CONSTANT."""
        return self.sd.get_arr_for_var(self.name)

    def set_arr(self, value):
        self.sd.set_arr_for_var(self.name, value)

    def rename(self, new_name: str) -> "SDVariable":
        return self.sd.rename_variable(self.name, new_name)

    def mark_as_loss(self) -> "SDVariable":
        if self.name not in self.sd.loss_variables:
            self.sd.set_loss_variables(
                list(self.sd.loss_variables) + [self.name])
        return self

    # op sugar ----------------------------------------------------------
    def _op(self, op_name: str, *others, name: Optional[str] = None,
            **attrs):
        inputs = [self] + [self.sd._lift(o) for o in others]
        return self.sd.invoke(op_name, inputs, attrs, name=name)

    def add(self, other, name=None):
        return self._op("add", other, name=name)

    __add__ = add

    def mul(self, other, name=None):
        return self._op("multiply", other, name=name)

    __mul__ = mul

    def mmul(self, other, name=None):
        return self._op("matmul", other, name=name)

    def reshape(self, *shape, name=None):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._op("reshape", name=name, shape=shape)
