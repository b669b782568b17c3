"""evaluation: the classifier and regression evaluations, the
calibration evaluation and the calibration helpers the serving tier's
int8 paths use (counterpart of ``deeplearning4j_tpu/evaluation/``; all of
its classes are ported, as host numpy)."""
from deeplearning4j_tpu_torch.evaluation.calibration import (
    EvaluationCalibration, Histogram, ReliabilityDiagram, absmax_scales,
    channel_scales, histogram_quantile)
from deeplearning4j_tpu_torch.evaluation.classification import (
    ROC, Evaluation, EvaluationBinary, ROCBinary, ROCMultiClass)
from deeplearning4j_tpu_torch.evaluation.regression import \
    RegressionEvaluation

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "Histogram", "ROC", "ROCBinary", "ROCMultiClass",
           "RegressionEvaluation", "ReliabilityDiagram", "absmax_scales",
           "channel_scales", "histogram_quantile"]
