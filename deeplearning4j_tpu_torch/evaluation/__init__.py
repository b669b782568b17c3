"""evaluation: the classifier and regression evaluations and the
calibration helpers the serving tier's int8 paths use (counterpart of
``deeplearning4j_tpu/evaluation/``; ``EvaluationBinary``, the ROC family
and ``EvaluationCalibration`` are not ported yet, ROADMAP queue 1 item
10)."""
from deeplearning4j_tpu_torch.evaluation.calibration import (absmax_scales,
                                                             channel_scales)
from deeplearning4j_tpu_torch.evaluation.classification import (
    ROC, Evaluation, EvaluationBinary, ROCBinary, ROCMultiClass)
from deeplearning4j_tpu_torch.evaluation.regression import \
    RegressionEvaluation

__all__ = ["Evaluation", "EvaluationBinary", "ROC", "ROCBinary",
           "ROCMultiClass", "RegressionEvaluation", "absmax_scales",
           "channel_scales"]
