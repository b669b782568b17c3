from deeplearning4j_tpu_torch.learning.updaters import (IUpdater, Nesterovs,
                                                        Sgd)

__all__ = ["IUpdater", "Nesterovs", "Sgd"]
