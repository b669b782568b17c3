from deeplearning4j_tpu_torch.autodiff.samediff import OpNode, SameDiff
from deeplearning4j_tpu_torch.autodiff.training import (History, Listener,
                                                        MixedPrecision,
                                                        ScoreIterationListener,
                                                        TrainingConfig)
from deeplearning4j_tpu_torch.autodiff.variable import SDVariable, VariableType

__all__ = ["History", "Listener", "MixedPrecision", "OpNode", "SameDiff",
           "SDVariable", "ScoreIterationListener", "TrainingConfig",
           "VariableType"]
