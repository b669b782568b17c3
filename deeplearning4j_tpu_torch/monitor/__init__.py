"""monitor: the span tracer, rolling step-time percentiles and device
memory guards the serving tier uses (counterpart of a part of
``deeplearning4j_tpu/monitor/``)."""
from deeplearning4j_tpu_torch.monitor.steptime import RollingPercentiles
from deeplearning4j_tpu_torch.monitor.trace import TRACER, Tracer

__all__ = ["RollingPercentiles", "TRACER", "Tracer"]
