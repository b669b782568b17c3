"""Network configuration builder (counterpart of
``deeplearning4j_tpu/nn/conf.py`` ``NeuralNetConfiguration`` :126). This
slice ports the graph builder; the list builder (``MultiLayerNetwork``)
comes later."""
from __future__ import annotations

from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd


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

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
            return GraphBuilder(self)

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()
