from deeplearning4j_tpu_torch.learning.regularization import (
    L1Regularization, L2Regularization, Regularization, WeightDecay)
from deeplearning4j_tpu_torch.learning.schedules import (
    CycleSchedule, ExponentialSchedule, FixedSchedule, InverseSchedule,
    ISchedule, MapSchedule, PolySchedule, RampSchedule, SigmoidSchedule,
    StepSchedule, resolve_lr)
from deeplearning4j_tpu_torch.learning.updaters import (Adam, IUpdater,
                                                        Nesterovs, Sgd)

__all__ = ["Adam", "CycleSchedule", "ExponentialSchedule", "FixedSchedule",
           "ISchedule", "IUpdater", "InverseSchedule", "L1Regularization",
           "L2Regularization", "MapSchedule", "Nesterovs", "PolySchedule",
           "RampSchedule", "Regularization", "SigmoidSchedule", "Sgd",
           "StepSchedule", "WeightDecay", "resolve_lr"]
