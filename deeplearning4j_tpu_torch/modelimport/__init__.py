"""Model import (counterpart of ``deeplearning4j_tpu/modelimport``): a frozen
TF GraphDef (.pb) into a SameDiff graph (``tf_import``). Keras .h5 import
(``KerasModelImport`` and the ``import_keras_*`` functions) and ONNX import
are not ported yet (ROADMAP queue 1 item 6); asking for them by name
raises ``NotImplementedError``."""
from deeplearning4j_tpu_torch.modelimport.tf_import import (TFImportError,
                                                            import_tf_graph,
                                                            supported_tf_ops)

__all__ = ["TFImportError", "import_tf_graph", "supported_tf_ops"]

_NOT_PORTED = ("KerasModelImport", "import_keras_model_and_weights",
               "import_keras_sequential_model_and_weights")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name}: Keras import is not ported yet (ROADMAP queue 1 item 6)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
