"""Linear-algebra ops of the slice (counterpart of
``deeplearning4j_tpu/ops/linalg.py``: ``matmul`` :19, alias ``mmul``, and
``einsum`` :55). Both are plain ``torch.matmul`` / ``torch.einsum``
(cuBLAS on the card), as the JAX package leaves them to XLA."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import op

_L = "linalg"


@op("matmul", _L, n_inputs=2, aliases=("mmul",))
def matmul(a, b, transpose_a: bool = False, transpose_b: bool = False,
           transpose_result: bool = False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    r = torch.matmul(a, b)
    return r.transpose(-1, -2) if transpose_result else r


@op("einsum", _L)
def einsum(*operands, equation: str):
    return torch.einsum(equation, *operands)
