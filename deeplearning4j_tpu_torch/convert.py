"""Weights between the JAX package and the port.

The JAX package names a parameter ``{node}_{suffix}`` (``res2a_2a_W``,
``res2a_bn2a_gamma``, the running statistics ``res2a_bn2a_mean`` /
``_var``); the port's state dict names it ``{node}.{suffix}``.
Convolution weights are HWIO there and OIHW here. This is how the tests
hand both packages the same weights, and how a JAX checkpoint's weights
enter the port.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``ComputationGraph.params()`` (parameters plus running
    statistics) -> a state dict for the port's network."""
    out = {}
    for name, arr in params.items():
        node, suffix = name.rsplit("_", 1)
        a = np.asarray(arr)
        if a.ndim == 4:                      # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        out[f"{node}.{suffix}"] = torch.tensor(a)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: numpy arrays under the JAX
    package's names and layouts."""
    out = {}
    for key, t in state_dict.items():
        node, suffix = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if a.ndim == 4:                      # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        # a copy: a CPU tensor's numpy() shares the live parameter's memory
        out[f"{node}_{suffix}"] = np.array(a, order="C", copy=True)
    return out
