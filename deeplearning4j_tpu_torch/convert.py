"""Weights between the JAX package and the port.

ComputationGraph: the JAX package names a parameter ``{node}_{suffix}`` (``res2a_2a_W``,
``res2a_bn2a_gamma``, the running statistics ``res2a_bn2a_mean`` /
``_var``); the port's state dict names it ``{node}.{suffix}``. The
recurrent layers' suffixes are the JAX ones (LSTM ``Wih``, ``Whh``,
``b``; GRU ``Wih``, ``Whh``, ``bih``, ``bhh``; Graves ``Wih``, ``Whh``,
``Wp``, ``b``; simple RNN ``W``, ``U``, ``b``), in the JAX layouts (gate
columns ``[i, f, g, o]`` or ``[r, u, c]``); a ``Bidirectional`` node's
``{node}_fwd_{suffix}`` / ``{node}_bwd_{suffix}`` are the port's
``{node}.fwd.{suffix}`` / ``{node}.bwd.{suffix}`` (so a node whose own
name ends in ``_fwd`` or ``_bwd`` is read as such a wrapper's).
Convolution weights are HWIO there and OIHW here. SameDiff: the names and layouts are the same on
both sides (a name -> array map of the stored VARIABLE and CONSTANT
values), so nothing is transposed; the names, shapes and dtypes are
checked. This is how the tests hand both packages the same weights, and
how a JAX checkpoint's weights enter the port.

A ``MultiLayerNetwork`` is its training SameDiff: its LSTM layers'
``layer{i}_lstm_Wih`` (in, 4u), ``_Whh`` (u, 4u) and ``_b`` (4u,) in
gate order ``[i, f, g, o]``, and its ``RnnOutputLayer``'s
``layer{i}_rnnout_W`` / ``_b``, are the JAX network's names and layouts:
``samediff_arrays_from_jax(jax_net.params(), net.samediff)``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


#: a Bidirectional node's direction in a JAX name's node part
_DIRECTION = re.compile(r"^(.+)_(fwd|bwd)$")


def params_from_jax(params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``ComputationGraph.params()`` (parameters plus running
    statistics) -> a state dict for the port's network."""
    out = {}
    for name, arr in params.items():
        node, suffix = name.rsplit("_", 1)
        m = _DIRECTION.match(node)
        if m is not None:
            node = f"{m.group(1)}.{m.group(2)}"
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
        a = t.detach().cpu().numpy()
        if a.ndim == 4:                      # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        # a copy: a CPU tensor's numpy() shares the live parameter's memory
        out[key.replace(".", "_")] = np.array(a, order="C", copy=True)
    return out


def samediff_arrays_from_jax(arrays: Mapping[str, np.ndarray], sd):
    """Load a JAX SameDiff's stored arrays (name -> array, e.g.
    ``{n: np.asarray(a) for n, a in jsd.trainable_params().items()}``) into
    the port's SameDiff ``sd``, which must hold the same names with the
    same shapes and dtypes. Returns ``sd``."""
    for name, arr in arrays.items():
        a = np.asarray(arr)
        cur = sd.get_arr_for_var(name) if sd.has_variable(name) else None
        if cur is None:
            raise KeyError(f"{name!r} is not a stored variable of the port's "
                           f"graph")
        want = str(cur.dtype).replace("torch.", "")
        if tuple(a.shape) != tuple(cur.shape) or str(a.dtype) != want:
            raise ValueError(f"{name!r}: {a.shape} {a.dtype} does not match "
                             f"{tuple(cur.shape)} {want}")
        sd.set_arr_for_var(name, a)
    return sd


def samediff_arrays_to_jax(sd) -> Dict[str, np.ndarray]:
    """The port's stored VARIABLE (state variables included) and CONSTANT
    arrays as name -> numpy array copies, the JAX SameDiff's names and
    layouts."""
    out = {}
    for name in [*sd.trainable_params(), *sd.state_vars_map(),
                 *sd.constants_map()]:
        a = sd.get_arr_for_var(name).cpu()
        out[name] = a.float().numpy() if a.dtype == torch.bfloat16 \
            else np.array(a.numpy(), copy=True)
    return out

