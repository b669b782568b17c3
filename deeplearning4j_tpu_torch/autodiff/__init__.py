from deeplearning4j_tpu_torch.autodiff.training import (History,
                                                        MixedPrecision,
                                                        TrainingConfig)

__all__ = ["History", "MixedPrecision", "TrainingConfig"]
