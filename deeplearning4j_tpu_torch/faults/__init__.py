"""faults/: the robustness layer, detect -> decide -> recover.

Counterpart of a part of ``deeplearning4j_tpu/faults/``: ``errors`` (the
structured taxonomy), ``sentinels`` (the device sentinel's raise site and
the host loss watchers), ``iterators`` (``RetryingIterator``),
``recovery`` (``FaultTolerantFit``) and a subset of ``chaos``. Not ported
yet: the rest of ``chaos``, ``LayerHealthWatcher`` (with
``monitor/tensorstats``), and the elastic and multi-host drills (ROADMAP
queue 1 item 7).
"""
from deeplearning4j_tpu_torch.faults.chaos import ChaosMonkey, ChaosSpec
from deeplearning4j_tpu_torch.faults.errors import (DataPipelineError,
                                                    FaultBudgetExhaustedError,
                                                    FaultError,
                                                    SilentCorruptionError,
                                                    TrainingDivergedError,
                                                    TransientDeviceError,
                                                    retryable_errors)
from deeplearning4j_tpu_torch.faults.iterators import RetryingIterator
from deeplearning4j_tpu_torch.faults.recovery import (FaultTolerantFit,
                                                      RetryPolicy)
from deeplearning4j_tpu_torch.faults.sentinels import (LossSpikeWatcher,
                                                       PlateauWatcher)

__all__ = ["ChaosMonkey", "ChaosSpec", "DataPipelineError",
           "FaultBudgetExhaustedError", "FaultError", "FaultTolerantFit",
           "LossSpikeWatcher", "PlateauWatcher", "RetryPolicy",
           "RetryingIterator", "SilentCorruptionError",
           "TrainingDivergedError", "TransientDeviceError",
           "retryable_errors"]
