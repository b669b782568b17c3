"""The ModelSerializer-style zip of a network.

Counterpart of ``deeplearning4j_tpu/nn/model_serde.py``: the same
container, so that a zip written by either package loads in the other:

- ``configuration.json``: the configuration's JSON (``nn/conf.py``);
- ``parameters.npz``: every stored array of the training graph by its
  JAX name (trainables, state variables, constants);
- ``updater.npz``: the updater state as ``leaf_{i}`` in the order
  ``jax.tree_util`` flattens the JAX package's ``{name: (leaf, ...)}``,
  the mapping of ``checkpoint/state.py`` (names sorted, each name's
  leaves in order); absent before the first step or without
  ``include_updater_state``;
- ``iteration.json``: ``{"iteration_count": n}``.

Its entries are stored, not deflated: trained float arrays deflate by a
few percent at a small fraction of the disk's rate. Either package reads
stored and deflated entries alike.

A ``MultiLayerNetwork`` writes its training graph's arrays
(:func:`save_net_zip`), a ``ComputationGraph`` its module's parameters and
running statistics under the JAX names and layouts (``{node}_{suffix}``,
convolution weights HWIO: :func:`save_graph_zip`), the names the JAX
graph's training SameDiff stores them under.

The zip is written through ``checkpoint/atomic.py``: assembled in a
temporary file beside ``path`` and renamed into place, so a killed
process never leaves a torn zip there. A load restores through
``checkpoint/state.py`` ``restore_training_state``, which copies into the
live tensors.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint import state as ckpt_state
from deeplearning4j_tpu_torch.checkpoint.atomic import atomic_output_file


def _npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def save_net_zip(path, conf_json: str, sd,
                 include_updater_state: bool = True) -> None:
    """Write the container for a network whose parameters live in the
    SameDiff ``sd`` (its training graph)."""
    names = [n for n in sd._arrays if n in sd._vars]
    leaves = ckpt_state._live_leaves(sd) if include_updater_state else None
    host = ckpt_state._host_copies(
        [sd._arrays[n] for n in names] + [t for _, t in (leaves or [])])
    tc = sd.training_config
    with atomic_output_file(path) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr("configuration.json", conf_json)
            zf.writestr("parameters.npz",
                        _npz(dict(zip(names, host[:len(names)]))))
            if leaves is not None:
                zf.writestr("updater.npz", _npz({
                    f"leaf_{i}": a for i, a in enumerate(host[len(names):])}))
            zf.writestr("iteration.json", json.dumps({
                "iteration_count": tc.iteration_count if tc else 0}))


def save_graph_zip(path, net, include_updater_state: bool = True) -> None:
    """Write the container for a ``ComputationGraph``: its parameters and
    running statistics by their JAX names (convolution weights HWIO), the
    updater leaves in the JAX order, the iteration (one host snapshot,
    ``checkpoint/state.py``)."""
    st = ckpt_state.capture_training_state(net)
    with atomic_output_file(path) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr("configuration.json", net.conf.to_json())
            zf.writestr("parameters.npz", _npz(st.arrays))
            if include_updater_state and st.updater_leaves is not None:
                zf.writestr("updater.npz", _npz({
                    f"leaf_{i}": a for i, a in enumerate(st.updater_leaves)}))
            zf.writestr("iteration.json", json.dumps({
                "iteration_count": int(st.iteration)}))


def read_net_zip(path) -> Tuple[str, Dict[str, np.ndarray],
                                Optional[List[np.ndarray]], int]:
    """``(configuration JSON, arrays, updater leaves or None,
    iteration)``."""
    with zipfile.ZipFile(path, "r") as zf:
        conf_json = zf.read("configuration.json").decode()
        with np.load(io.BytesIO(zf.read("parameters.npz"))) as npz:
            arrays = {k: npz[k] for k in npz.files}
        leaves = None
        if "updater.npz" in zf.namelist():
            with np.load(io.BytesIO(zf.read("updater.npz"))) as npz:
                leaves = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
        iteration = 0
        if "iteration.json" in zf.namelist():
            iteration = json.loads(zf.read("iteration.json")).get(
                "iteration_count", 0)
    return conf_json, arrays, leaves, int(iteration)


def restore_net_state(net, arrays: Dict[str, np.ndarray],
                      updater_leaves: Optional[List[np.ndarray]],
                      iteration: int):
    """Copy loaded arrays, updater state and iteration into an
    initialized network; returns it. A ``ComputationGraph`` takes the
    arrays its module holds (a JAX zip's constants, which the port's
    vertices do not store, are left out)."""
    if not hasattr(net, "samediff"):
        tc = net.training_config
        ckpt_state.restore_training_state(net, ckpt_state.TrainingState(
            arrays=arrays, updater_leaves=updater_leaves,
            iteration=iteration, epoch=tc.epoch_count if tc else 0))
        return net
    sd = net.samediff
    epoch = sd.training_config.epoch_count if sd.training_config else 0
    ckpt_state.restore_training_state(net, ckpt_state.TrainingState(
        arrays=arrays, updater_leaves=updater_leaves, iteration=iteration,
        epoch=epoch))
    trainable = sd.trainable_params()
    for n, a in arrays.items():           # state variables and constants
        if n in sd._arrays and n not in trainable and \
                tuple(sd._arrays[n].shape) == a.shape:
            sd._arrays[n].copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return net
