"""evaluation: the calibration helpers the serving tier's int8 paths use
(counterpart of ``deeplearning4j_tpu/evaluation/``; the classifier
evaluations are not ported yet)."""
from deeplearning4j_tpu_torch.evaluation.calibration import (absmax_scales,
                                                             channel_scales)

__all__ = ["absmax_scales", "channel_scales"]
