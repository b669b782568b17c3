"""Linear-algebra ops (counterpart of ``deeplearning4j_tpu/ops/linalg.py``:
``matmul`` :19, alias ``mmul``, ``einsum`` :55 and ``batched_matmul`` :60,
alias ``batch_mmul``). All are plain ``torch.matmul`` / ``torch.einsum``
(cuBLAS on the card), as the JAX package leaves them to XLA. Operands of
two dtypes are promoted first, as ``jnp.matmul`` does (``ops/dtypes.py``):
float32 @ bfloat16 is a float32 product, where ``torch.matmul`` raises."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.dtypes import promote
from deeplearning4j_tpu_torch.ops.registry import op

_L = "linalg"


@op("matmul", _L, n_inputs=2, aliases=("mmul",))
def matmul(a, b, transpose_a: bool = False, transpose_b: bool = False,
           transpose_result: bool = False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    r = torch.matmul(*promote(a, b))
    return r.transpose(-1, -2) if transpose_result else r


@op("einsum", _L)
def einsum(*operands, equation: str):
    return torch.einsum(equation, *promote(*operands))


@op("batched_matmul", _L, n_inputs=2, aliases=("batch_mmul",))
def batched_matmul(a, b, transpose_a: bool = False, transpose_b: bool = False):
    """``matmul`` over leading batch axes (TF's ``BatchMatMulV2``; ``adj_x``
    and ``adj_y`` arrive as ``transpose_a`` / ``transpose_b``)."""
    return matmul(a, b, transpose_a, transpose_b)
