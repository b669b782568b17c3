"""Network configuration builders (counterpart of
``deeplearning4j_tpu/nn/conf.py``: ``MultiLayerConfiguration`` :37,
``ListBuilder`` :92, ``NeuralNetConfiguration`` :126). ``graph_builder()``
builds a ``ComputationGraph`` configuration, ``list()`` a sequential one
for ``MultiLayerNetwork``. The regularization, gradient clipping and
normalization fields are not ported (ROADMAP queue 1 item 3): the
builder has no such method."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from deeplearning4j_tpu_torch.autodiff.training import MixedPrecision
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.layers import BaseLayer, InputType


@dataclasses.dataclass
class MultiLayerConfiguration:
    layers: List[BaseLayer]
    input_type: InputType
    seed: int = 12345
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(0.01))
    dtype: str = "float32"
    mixed_precision: Optional[MixedPrecision] = None
    # the layout cnn tensors run in inside the graph; users feed NCHW
    cnn_data_format: str = "NHWC"

    def to_json(self) -> str:
        raise NotImplementedError(
            "MultiLayerConfiguration JSON serde is not ported yet (ROADMAP "
            "queue 1 item 10: model_serde)")

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        raise NotImplementedError(
            "MultiLayerConfiguration JSON serde is not ported yet (ROADMAP "
            "queue 1 item 10: model_serde)")


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
            updater=p._updater, dtype=p._dtype,
            mixed_precision=p._mixed_precision)


class NeuralNetConfiguration:
    class Builder:
        def __init__(self):
            self._seed = 12345
            self._updater: IUpdater = Sgd(0.01)
            self._dtype = "float32"
            self._mixed_precision = None

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u: IUpdater):
            self._updater = u
            return self

        def data_type(self, dt: str):
            self._dtype = dt
            return self

        def list(self) -> ListBuilder:
            return ListBuilder(self)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
            return GraphBuilder(self)

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()
