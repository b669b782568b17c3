"""Complete training-state snapshots for bit-exact resume.

Counterpart of ``deeplearning4j_tpu/checkpoint/state.py``: the same
``TrainingState``, the same files (``state.json``, ``arrays.npz``,
``updater.npz``), ``FORMAT_VERSION`` and JSON keys, under the JAX
package's names and layouts, so that a checkpoint written by either
package restores in the other:

- ``arrays``: the trainable parameters and the batch norms' running
  statistics (a SameDiff's state variables), by the JAX names (``ComputationGraph``: ``{node}_{suffix}``
  with convolution weights HWIO, where the port holds ``{node}.{suffix}``
  in OIHW; ``SameDiff`` and ``MultiLayerNetwork``: the same names and
  layouts);
- ``updater_leaves``: the updater state flattened in the order
  ``jax.tree_util`` flattens the JAX package's ``{name: (leaf, ...)}``:
  the names sorted, each name's leaves in order (Nesterovs' velocity;
  Adam's m, then v), in the same layouts;
- ``iteration`` / ``epoch``: the counters;
- ``rng_seed``: the base seed of the fit in flight (or, before any fit,
  the next fit's), as the JAX package records it: a step's dropout masks
  are keyed by it, the iteration and the node (``kernels/dropout.py``),
  so restoring it with the iteration resumes the same masks. A JAX
  checkpoint's seed restores the same way, though the two generators
  draw different masks from it;
- ``metadata["topology"]``: one process, one device, no mesh.

:func:`capture_training_state` is the synchronous part of an
asynchronous save: the device-to-host copy. The port's updaters write the
parameters in place, so the snapshot is a copy taken before the next
step, never a view: on the card every tensor is copied into pinned host
memory without waiting, then the stream is synchronized once.
Serialization, hashing and fsync happen on the manager's writer thread.
:func:`restore_training_state` copies into the live tensors (``copy_``),
so a fit's captured CUDA graphs, which read them by address, stay valid.
A snapshot taken before the first step holds no updater state; restoring
it zeroes the live state (the updaters' initial state), which a failed
fit may have poisoned in place, where the JAX fit's working copies are
dropped.

Not ported yet: ``normalizer=`` (the data normalizers' statistics,
ROADMAP queue 1 item 7), refused by name; multi-process shards (a
checkpoint written by several processes raises
``ShardCountMismatchError`` in the manager).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

STATE_JSON = "state.json"
ARRAYS_NPZ = "arrays.npz"
UPDATER_NPZ = "updater.npz"
NORMALIZER_NPZ = "normalizer.npz"
FORMAT_VERSION = 1

_NORMALIZERS = "ROADMAP queue 1 item 7: normalizer statistics in checkpoints"


@dataclasses.dataclass
class TrainingState:
    """Host-memory snapshot of everything needed to resume bit-exactly."""
    arrays: Dict[str, np.ndarray]
    updater_leaves: Optional[List[np.ndarray]] = None
    iteration: int = 0
    epoch: int = 0
    rng_seed: Optional[int] = None
    normalizer_state: Optional[Dict[str, np.ndarray]] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def nbytes(self) -> int:
        total = sum(a.nbytes for a in self.arrays.values())
        total += sum(l.nbytes for l in (self.updater_leaves or []))
        total += sum(np.asarray(v).nbytes
                     for v in (self.normalizer_state or {}).values())
        return total


# ----------------------------------------------------------------------
# the JAX package's view of a model's state
def _owner(model):
    """The object that holds the training config and the tensors: a
    ``MultiLayerNetwork``'s training SameDiff, else the model."""
    return getattr(model, "samediff", model)


def _is_graph(owner) -> bool:
    return hasattr(owner, "model") and hasattr(owner, "_params")


def _jax_name(key: str) -> str:
    """A state-dict key's JAX name: ``{node}.{suffix}`` is
    ``{node}_{suffix}``, and a wrapper's ``{node}.fwd.{suffix}``
    (``Bidirectional``) ``{node}_fwd_{suffix}``."""
    return key.replace(".", "_")


def _to_jax(t_np: np.ndarray, graph: bool) -> np.ndarray:
    return t_np.transpose(2, 3, 1, 0) if graph and t_np.ndim == 4 else t_np


def _from_jax(a: np.ndarray, graph: bool) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if graph and a.ndim == 4 else a


def _live_arrays(owner) -> Dict[str, torch.Tensor]:
    """JAX name -> the live tensor (parameters and running statistics)."""
    if _is_graph(owner):
        return {_jax_name(k): t for k, t in
                owner.model.state_dict(keep_vars=True).items()}
    return {**owner.trainable_params(), **owner.state_vars_map()}


def _live_leaves(owner) -> Optional[List[Tuple[str, torch.Tensor]]]:
    """The updater state's leaves in the JAX flattening order (names
    sorted, each name's leaves in order), as (name, live tensor); None
    before the updater state exists."""
    if owner._updater_state is None:
        return None
    if _is_graph(owner):
        by_name = dict(zip((_jax_name(n) for n in owner._names),
                           owner._updater_state))
    else:
        by_name = dict(owner._updater_state)
    return [(n, leaf) for n in sorted(by_name) for leaf in by_name[n]]


def _host_copies(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors`` that no later step can change: on the
    card, copies into pinned memory queued without waiting and one
    synchronize; on the CPU, clones."""
    out = []
    cuda = [t for t in tensors if t.device.type == "cuda"]
    for t in tensors:
        t = t.detach()
        if t.device.type == "cuda":
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
        else:
            dst = t.clone()
        out.append(dst)
    if cuda:
        torch.cuda.current_stream(cuda[0].device).synchronize()
    return [d.float().numpy() if d.dtype == torch.bfloat16 else d.numpy()
            for d in out]


def capture_topology(model) -> Dict[str, Any]:
    """The topology a snapshot was captured under (the JAX record's
    keys): one process, one device, no mesh, and each array's shape."""
    owner = _owner(model)
    graph = _is_graph(owner)
    shapes = {}
    for n, t in _live_arrays(owner).items():
        shape = tuple(t.shape)
        if graph and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        shapes[n] = [int(s) for s in shape]
    return {"process_count": 1, "device_count": 1, "mesh_axes": None,
            "partition_specs": {}, "global_shapes": shapes}


def _rng_seed(owner) -> int:
    """The base seed of the fit in flight, else the next fit's."""
    seed = getattr(owner, "_fit_base_seed", None)
    return int(owner._seed if seed is None else seed)


def capture_training_state(model, epoch: int = 0, normalizer=None,
                           metadata: Optional[Dict[str, Any]] = None
                           ) -> TrainingState:
    """Snapshot a ``SameDiff``, ``MultiLayerNetwork`` or
    ``ComputationGraph`` to host memory, under the JAX names and
    layouts."""
    if normalizer is not None:
        raise NotImplementedError(
            f"{type(model).__name__}.capture_training_state with "
            f"normalizer= is not ported yet ({_NORMALIZERS})")
    owner = _owner(model)
    graph = _is_graph(owner)
    live = _live_arrays(owner)
    leaves = _live_leaves(owner)
    host = _host_copies(list(live.values())
                        + [t for _, t in (leaves or [])])
    arrays = {n: _to_jax(a, graph) for n, a in zip(live, host)}
    updater_leaves = None if leaves is None else [
        _to_jax(a, graph) for a in host[len(live):]]
    from deeplearning4j_tpu_torch.memory import AllocationsTracker
    AllocationsTracker.get_instance().allocate(
        "checkpoint_d2h", sum(a.nbytes for a in host))
    tc = owner.training_config
    meta = dict(metadata or {})
    meta.setdefault("topology", capture_topology(model))
    return TrainingState(
        arrays=arrays, updater_leaves=updater_leaves,
        iteration=int(tc.iteration_count) if tc is not None else 0,
        epoch=int(epoch), rng_seed=_rng_seed(owner), metadata=meta)


@torch.no_grad()
def restore_training_state(model, state: TrainingState,
                           strict: bool = True):
    """Copy a snapshot into a live, initialized model: every array and
    updater leaf into its tensor (``copy_``, converting the layout and
    dtype), then the counters. ``strict``: raise if the snapshot does not
    cover every live array, or its updater state does not match the
    live updater's structure. Returns None (the port restores no
    normalizer)."""
    if state.normalizer_state:
        raise NotImplementedError(
            f"{type(model).__name__}.restore_training_state of a state "
            f"with normalizer statistics is not ported yet "
            f"({_NORMALIZERS})")
    owner = _owner(model)
    graph = _is_graph(owner)
    live = _live_arrays(owner)
    missing = sorted(set(live) - set(state.arrays))
    if strict and missing:
        raise ValueError(
            f"checkpoint does not cover live parameters "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}: the graph "
            f"changed since the snapshot; pass strict=False to restore "
            f"the matching subset")
    for n, arr in state.arrays.items():
        t = live.get(n)
        if t is None:
            continue
        a = _from_jax(np.asarray(arr), graph)
        if tuple(t.shape) != tuple(a.shape):
            if strict:
                raise ValueError(
                    f"checkpoint array {n!r} has shape {tuple(arr.shape)} "
                    f"but the live model expects "
                    f"{tuple(_to_jax(np.empty(t.shape), graph).shape)}")
            continue
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    tc = owner.training_config
    if state.updater_leaves is not None and tc is not None:
        owner._fit_state()              # the state made once, if need be
        leaves = _live_leaves(owner)
        got = [_from_jax(np.asarray(l), graph) for l in state.updater_leaves]
        compatible = len(leaves) == len(got) and all(
            tuple(t.shape) == tuple(a.shape)
            for (_, t), a in zip(leaves, got))
        if compatible:
            for (_, t), a in zip(leaves, got):
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        elif strict:
            raise ValueError(
                "checkpoint updater state does not match the live "
                "model's optimizer structure")
    elif state.updater_leaves is None and \
            getattr(owner, "_updater_state", None) is not None:
        # a snapshot from before the first step: the updater starts from
        # its initial (zero) state, which the live tensors take in place
        for _, t in _live_leaves(owner):
            t.zero_()
    if tc is not None:
        tc.iteration_count = int(state.iteration)
        tc.epoch_count = int(state.epoch)
    if state.rng_seed is not None:
        # the next fit draws with the snapshot's base seed
        owner._seed = owner._fit_base_seed = int(state.rng_seed)
    if hasattr(model, "_sync_infer"):
        model._sync_infer()
    return None


# ----------------------------------------------------------------------
# directory (de)serialization: called on the manager's writer thread
def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` straight into the file, then fsync. Not through a
    ``BytesIO``: copying the whole archive out of one holds the
    interpreter lock for as long as the copy takes, and the training
    thread, which needs it to launch, waits (the JAX package's
    ``_npz_bytes``; ``experiments/checkpoint_capture_study.py``)."""
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())


def _write_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def write_state_files(directory: str, state: TrainingState) -> None:
    """Write the snapshot into ``directory`` (the step's ``.tmp``
    staging directory), one process's single shard: ``arrays.npz``,
    ``updater.npz`` and ``state.json``, each fsynced. The manifest,
    COMMIT marker and rename are the caller's commit."""
    _write_npz(os.path.join(directory, ARRAYS_NPZ), state.arrays)
    if state.updater_leaves is not None:
        _write_npz(os.path.join(directory, UPDATER_NPZ),
                   {f"leaf_{i}": l
                    for i, l in enumerate(state.updater_leaves)})
    meta = {"format_version": FORMAT_VERSION,
            "iteration": int(state.iteration),
            "epoch": int(state.epoch),
            "rng_seed": state.rng_seed,
            "shard_count": 1,
            "has_updater": state.updater_leaves is not None,
            "has_normalizer": False,
            "metadata": state.metadata}
    _write_durable(os.path.join(directory, STATE_JSON),
                   json.dumps(meta, indent=1, sort_keys=True).encode())


def read_state_files(directory: str) -> TrainingState:
    """A committed single-shard step directory as a TrainingState (a
    JAX checkpoint's normalizer statistics, if any, are read, and
    refused at restore)."""
    with open(os.path.join(directory, STATE_JSON), encoding="utf-8") as fh:
        meta = json.load(fh)
    with np.load(os.path.join(directory, ARRAYS_NPZ)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    updater_leaves = None
    if meta.get("has_updater"):
        with np.load(os.path.join(directory, UPDATER_NPZ)) as npz:
            updater_leaves = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
    norm_state = None
    if meta.get("has_normalizer"):
        with np.load(os.path.join(directory, NORMALIZER_NPZ)) as npz:
            norm_state = {k: npz[k] for k in npz.files}
    return TrainingState(arrays=arrays, updater_leaves=updater_leaves,
                         iteration=int(meta.get("iteration", 0)),
                         epoch=int(meta.get("epoch", 0)),
                         rng_seed=meta.get("rng_seed"),
                         normalizer_state=norm_state,
                         metadata=dict(meta.get("metadata", {})))
