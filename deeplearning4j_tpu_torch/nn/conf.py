"""Network configuration builders (counterpart of
``deeplearning4j_tpu/nn/conf.py``: ``MultiLayerConfiguration`` :37,
``ListBuilder`` :92, ``NeuralNetConfiguration`` :126). ``graph_builder()``
builds a ``ComputationGraph`` configuration, ``list()`` a sequential one
for ``MultiLayerNetwork``. ``l1``, ``l2`` and ``weight_decay`` become the
configuration's ``regularization`` (both builders), ``gradient_clip`` and
``gradient_normalization`` its clipping (the sequential one only, as in
the JAX package). ``MultiLayerConfiguration.to_json``/``from_json`` (JAX
:55-89) write and read the JAX package's JSON, so either package reads
the other's; a layer class the port has not ported is refused by
name."""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

from deeplearning4j_tpu_torch.autodiff.training import MixedPrecision
from deeplearning4j_tpu_torch.learning.regularization import (
    L1Regularization, L2Regularization, Regularization, WeightDecay)
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn import conv_layers  # noqa: F401
from deeplearning4j_tpu_torch.nn import layers_ext  # noqa: F401
from deeplearning4j_tpu_torch.nn import recurrent_layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import BaseLayer, InputType


@dataclasses.dataclass
class MultiLayerConfiguration:
    layers: List[BaseLayer]
    input_type: InputType
    seed: int = 12345
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(0.01))
    regularization: Sequence[Regularization] = ()
    dtype: str = "float32"
    grad_clip_value: Optional[float] = None
    mixed_precision: Optional[MixedPrecision] = None
    # the layout cnn tensors run in inside the graph; users feed NCHW
    cnn_data_format: str = "NHWC"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "dtype": self.dtype,
            "cnn_data_format": self.cnn_data_format,
            "grad_clip_value": self.grad_clip_value,
            "mixed_precision": (self.mixed_precision.to_json()
                                if self.mixed_precision else None),
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "updater": self.updater.to_json(),
            "regularization": [r.to_json() for r in self.regularization],
            "input_type": self.input_type.to_json(),
            "layers": [layer.to_json() for layer in self.layers],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        """A configuration from its JSON; a missing ``cnn_data_format``
        reads as NCHW (JSON written before the field existed)."""
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[BaseLayer.from_json(ld) for ld in d["layers"]],
            input_type=InputType.from_json(d["input_type"]),
            seed=d.get("seed", 12345),
            updater=IUpdater.from_json(d["updater"]),
            regularization=[Regularization.from_json(r)
                            for r in d.get("regularization", [])],
            dtype=d.get("dtype", "float32"),
            cnn_data_format=d.get("cnn_data_format", "NCHW"),
            grad_clip_value=d.get("grad_clip_value"),
            mixed_precision=MixedPrecision.from_json(
                d.get("mixed_precision")),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0))


class ListBuilder:
    def __init__(self, parent: "NeuralNetConfiguration.Builder"):
        self._parent = parent
        self._layers: List[BaseLayer] = []
        self._input_type: Optional[InputType] = None

    def layer(self, layer: BaseLayer) -> "ListBuilder":
        self._layers.append(layer)
        return self

    def set_input_type(self, itype: InputType) -> "ListBuilder":
        self._input_type = itype
        return self

    def build(self) -> MultiLayerConfiguration:
        if self._input_type is None:
            raise ValueError("set_input_type(...) is required (the reference "
                             "infers nIn via setInputType the same way)")
        p = self._parent
        return MultiLayerConfiguration(
            layers=self._layers, input_type=self._input_type, seed=p._seed,
            updater=p._updater, regularization=p._regularization(),
            dtype=p._dtype, grad_clip_value=p._grad_clip,
            mixed_precision=p._mixed_precision,
            gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold)


class NeuralNetConfiguration:
    class Builder:
        def __init__(self):
            self._seed = 12345
            self._updater: IUpdater = Sgd(0.01)
            self._l1 = 0.0
            self._l2 = 0.0
            self._weight_decay = 0.0
            self._dtype = "float32"
            self._grad_clip = None
            self._mixed_precision = None
            self._grad_norm = None
            self._grad_norm_threshold = 1.0

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u: IUpdater):
            self._updater = u
            return self

        def l1(self, v: float):
            self._l1 = v
            return self

        def l2(self, v: float):
            self._l2 = v
            return self

        def weight_decay(self, v: float):
            self._weight_decay = v
            return self

        def data_type(self, dt: str):
            self._dtype = dt
            return self

        def gradient_clip(self, v: float):
            self._grad_clip = v
            return self

        def gradient_normalization(self, mode: str, threshold: float = 1.0):
            """clip_l2_per_layer | clip_l2_global |
            renormalize_l2_per_layer | clip_element_wise_absolute_value
            (``TrainingConfig.clip_gradients_``)."""
            self._grad_norm = mode
            self._grad_norm_threshold = threshold
            return self

        def _regularization(self) -> List[Regularization]:
            """What ``l1``, ``l2`` and ``weight_decay`` set, in the JAX
            builders' order."""
            regs: List[Regularization] = []
            if self._l1:
                regs.append(L1Regularization(l1=self._l1))
            if self._l2:
                regs.append(L2Regularization(l2=self._l2))
            if self._weight_decay:
                regs.append(WeightDecay(coeff=self._weight_decay))
            return regs

        def list(self) -> ListBuilder:
            return ListBuilder(self)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
            return GraphBuilder(self)

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()
