from deeplearning4j_tpu_torch.learning.updaters import (Adam, IUpdater,
                                                        Nesterovs, Sgd)

__all__ = ["Adam", "IUpdater", "Nesterovs", "Sgd"]
