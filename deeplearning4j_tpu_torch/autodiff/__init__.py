from deeplearning4j_tpu_torch.autodiff.samediff import OpNode, SameDiff
from deeplearning4j_tpu_torch.autodiff.training import (History,
                                                        MixedPrecision,
                                                        TrainingConfig)
from deeplearning4j_tpu_torch.autodiff.variable import SDVariable, VariableType

__all__ = ["History", "MixedPrecision", "OpNode", "SameDiff", "SDVariable",
           "TrainingConfig", "VariableType"]
