"""checkpoint/: asynchronous, atomic training checkpoints.

Counterpart of a part of ``deeplearning4j_tpu/checkpoint/``: ``atomic``
(crash-safe writes), ``manifest`` (the per-file sha256 manifest and
COMMIT marker), ``state`` (``TrainingState`` capture and restore, in the
JAX package's file format, names and layouts), ``manager``
(``CheckpointManager``) and ``listener`` (``CheckpointListener``). Not
ported yet: ``scrub``, ``reshard``, ``preemption``, ``savers`` and the
command line (ROADMAP queue 1 item 7).
"""
from deeplearning4j_tpu_torch.checkpoint.atomic import (
    atomic_copy, atomic_output_file, atomic_write_bytes, atomic_write_via,
    fsync_dir)
from deeplearning4j_tpu_torch.checkpoint.listener import CheckpointListener
from deeplearning4j_tpu_torch.checkpoint.manager import (
    CheckpointError, CheckpointManager, ShardCountMismatchError,
    TopologyChangedError)
from deeplearning4j_tpu_torch.checkpoint.manifest import (is_committed,
                                                          sha256_file,
                                                          verify_dir)
from deeplearning4j_tpu_torch.checkpoint.state import (
    TrainingState, capture_topology, capture_training_state,
    read_state_files, restore_training_state, write_state_files)

__all__ = [
    "CheckpointError", "CheckpointListener", "CheckpointManager",
    "ShardCountMismatchError", "TopologyChangedError", "TrainingState",
    "atomic_copy", "atomic_output_file", "atomic_write_bytes",
    "atomic_write_via", "capture_topology", "capture_training_state",
    "fsync_dir", "is_committed", "read_state_files",
    "restore_training_state", "sha256_file", "verify_dir",
    "write_state_files",
]
