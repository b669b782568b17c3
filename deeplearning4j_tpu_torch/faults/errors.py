"""The structured fault taxonomy of the training rails.

Counterpart of ``deeplearning4j_tpu/faults/errors.py`` (``FaultError``
:20, ``TrainingDivergedError`` :50, ``DataPipelineError`` :60,
``TransientDeviceError`` :107, ``FaultBudgetExhaustedError`` :116,
``SilentCorruptionError`` :163, ``retryable_errors`` :193). Every error
the recovery loop routes on carries machine-readable provenance
(absolute step, epoch, batch index, cause tag).

``SilentCorruptionError`` is defined for the recovery loop's routing;
nothing in the port raises it yet (the fingerprints of ``integrity/``,
ROADMAP queue 1 item 7). Not carried over: ``ShardCorruptError`` (with
``datapipe/``) and ``TrainingStalledError`` (with the stall watchdog),
both item 7.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class FaultError(RuntimeError):
    """Base for all structured training-rail faults. ``provenance()``
    is the machine-readable view recovery decisions use."""

    cause_tag: str = "fault"

    def __init__(self, message: str, *, step: Optional[int] = None,
                 epoch: Optional[int] = None,
                 batch_index: Optional[int] = None,
                 cause: Optional[str] = None,
                 value: Optional[float] = None):
        super().__init__(message)
        self.step = step
        self.epoch = epoch
        self.batch_index = batch_index
        self.cause = cause or self.cause_tag
        self.value = value

    def provenance(self) -> Dict[str, Any]:
        return {"error": type(self).__name__, "cause": self.cause,
                "step": self.step, "epoch": self.epoch,
                "batch_index": self.batch_index, "value": self.value}


class TrainingDivergedError(FaultError, ArithmeticError):
    """Training left the healthy regime: a non-finite loss or gradient
    (the device sentinel, ``TrainingConfig.sentinel``), a host-side loss
    spike, or a plateau watcher firing."""

    cause_tag = "divergence"


class DataPipelineError(FaultError):
    """A data loader failed: a retry budget exhausted
    (``faults.RetryingIterator``) or a source that shrank during a
    retry. ``batch_index`` is the failing batch's index in the pass."""

    cause_tag = "data_pipeline"


class TransientDeviceError(FaultError):
    """A device or runtime error believed transient."""

    cause_tag = "device"


class FaultBudgetExhaustedError(FaultError):
    """FaultTolerantFit's retry budget ran out: the model was rolled
    back to the last committed checkpoint and a pinned final checkpoint
    committed; ``__cause__`` is the last underlying fault."""

    cause_tag = "budget_exhausted"


class SilentCorruptionError(FaultError):
    """Bitwise state divergence that raised nothing (a fingerprint
    mismatch). FaultTolerantFit answers it by rolling back to the
    newest fingerprint-verified checkpoint."""

    cause_tag = "silent_corruption"

    def __init__(self, message: str, *, check: Optional[str] = None,
                 expected: Optional[int] = None,
                 actual: Optional[int] = None, **kw):
        super().__init__(message, **kw)
        self.check = check
        self.expected = expected
        self.actual = actual

    def provenance(self) -> Dict[str, Any]:
        out = super().provenance()
        out["check"] = self.check
        out["expected"] = self.expected
        out["actual"] = self.actual
        return out


def retryable_errors() -> tuple:
    """The exception classes FaultTolerantFit treats as recoverable:
    the structured fault taxonomy and checkpoint-write failures
    (``CheckpointError``)."""
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointError
    return (TrainingDivergedError, DataPipelineError, TransientDeviceError,
            SilentCorruptionError, CheckpointError)
