"""Zoo models (counterpart of ``deeplearning4j_tpu/zoo/models.py``).

``ResNet50`` makes the same DSL calls as the JAX package's (:196), so the
graph is node for node the JAX one, with the same parameter names and the
same initial weights from the same seed.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Nesterovs
from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalization, ComputationGraph, ConvolutionLayer,
    ElementWiseVertex, GlobalPoolingLayer, InputType,
    NeuralNetConfiguration, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)


@dataclasses.dataclass
class ResNet50:
    """ResNet-50 v1 (reference: zoo/model/ResNet50.java:80-250).

    Stem: zero-pad 3, conv7x7/2, BN, relu, maxpool3x3/2; then bottleneck
    stages 2-5 with block counts [3, 4, 6, 3]; global average pool +
    softmax head. Built as a ComputationGraph with ElementWiseVertex(Add)
    residual shortcuts exactly like the reference's
    identityBlock/convBlock helpers.
    """
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    # ----- block helpers (reference ResNet50.java:94-186) -------------
    def _identity_block(self, g, kernel, filters, stage, block, inp):
        f1, f2, f3 = filters
        n = f"res{stage}{block}"
        (g.add_layer(f"{n}_2a", ConvolutionLayer(
            n_out=f1, kernel_size=(1, 1), convolution_mode="VALID"), inp)
         .add_layer(f"{n}_bn2a", BatchNormalization(), f"{n}_2a")
         .add_layer(f"{n}_act2a", ActivationLayer(activation="relu"),
                    f"{n}_bn2a")
         .add_layer(f"{n}_2b", ConvolutionLayer(
             n_out=f2, kernel_size=kernel, convolution_mode="SAME"),
             f"{n}_act2a")
         .add_layer(f"{n}_bn2b", BatchNormalization(), f"{n}_2b")
         .add_layer(f"{n}_act2b", ActivationLayer(activation="relu"),
                    f"{n}_bn2b")
         .add_layer(f"{n}_2c", ConvolutionLayer(
             n_out=f3, kernel_size=(1, 1), convolution_mode="VALID"),
             f"{n}_act2b")
         .add_layer(f"{n}_bn2c", BatchNormalization(), f"{n}_2c")
         .add_vertex(f"{n}_add", ElementWiseVertex(op="Add"),
                     f"{n}_bn2c", inp)
         .add_layer(f"{n}_out", ActivationLayer(activation="relu"),
                    f"{n}_add"))
        return f"{n}_out"

    def _conv_block(self, g, kernel, filters, stage, block, inp,
                    stride=(2, 2)):
        f1, f2, f3 = filters
        n = f"res{stage}{block}"
        (g.add_layer(f"{n}_2a", ConvolutionLayer(
            n_out=f1, kernel_size=(1, 1), stride=stride,
            convolution_mode="VALID"), inp)
         .add_layer(f"{n}_bn2a", BatchNormalization(), f"{n}_2a")
         .add_layer(f"{n}_act2a", ActivationLayer(activation="relu"),
                    f"{n}_bn2a")
         .add_layer(f"{n}_2b", ConvolutionLayer(
             n_out=f2, kernel_size=kernel, convolution_mode="SAME"),
             f"{n}_act2a")
         .add_layer(f"{n}_bn2b", BatchNormalization(), f"{n}_2b")
         .add_layer(f"{n}_act2b", ActivationLayer(activation="relu"),
                    f"{n}_bn2b")
         .add_layer(f"{n}_2c", ConvolutionLayer(
             n_out=f3, kernel_size=(1, 1), convolution_mode="VALID"),
             f"{n}_act2b")
         .add_layer(f"{n}_bn2c", BatchNormalization(), f"{n}_2c")
         # projection shortcut
         .add_layer(f"{n}_1", ConvolutionLayer(
             n_out=f3, kernel_size=(1, 1), stride=stride,
             convolution_mode="VALID"), inp)
         .add_layer(f"{n}_bn1", BatchNormalization(), f"{n}_1")
         .add_vertex(f"{n}_add", ElementWiseVertex(op="Add"),
                     f"{n}_bn2c", f"{n}_bn1")
         .add_layer(f"{n}_out", ActivationLayer(activation="relu"),
                    f"{n}_add"))
        return f"{n}_out"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(learning_rate=1e-1,
                                                momentum=0.9))
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        # stem (reference "stem-zero"/"stem-cnn1"/"stem-batch1"/maxpool)
        (g.add_layer("stem_zero", ZeroPaddingLayer(padding=(3, 3, 3, 3)),
                     "input")
         .add_layer("stem_conv", ConvolutionLayer(
             n_out=64, kernel_size=(7, 7), stride=(2, 2),
             convolution_mode="VALID"), "stem_zero")
         .add_layer("stem_bn", BatchNormalization(), "stem_conv")
         .add_layer("stem_act", ActivationLayer(activation="relu"),
                    "stem_bn")
         .add_layer("stem_pool", SubsamplingLayer(
             pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2)),
             "stem_act"))
        cur = "stem_pool"
        # stage 2
        cur = self._conv_block(g, (3, 3), (64, 64, 256), 2, "a", cur,
                               stride=(1, 1))
        for blk in "bc":
            cur = self._identity_block(g, (3, 3), (64, 64, 256), 2, blk, cur)
        # stage 3
        cur = self._conv_block(g, (3, 3), (128, 128, 512), 3, "a", cur)
        for blk in "bcd":
            cur = self._identity_block(g, (3, 3), (128, 128, 512), 3, blk,
                                       cur)
        # stage 4
        cur = self._conv_block(g, (3, 3), (256, 256, 1024), 4, "a", cur)
        for blk in "bcdef":
            cur = self._identity_block(g, (3, 3), (256, 256, 1024), 4, blk,
                                       cur)
        # stage 5
        cur = self._conv_block(g, (3, 3), (512, 512, 2048), 5, "a", cur)
        for blk in "bc":
            cur = self._identity_block(g, (3, 3), (512, 512, 2048), 5, blk,
                                       cur)
        # head (reference: avgpool + flatten + OutputLayer; global avg pool
        # makes the head input-size independent)
        (g.add_layer("gap", GlobalPoolingLayer(pooling_type="AVG"), cur)
         .add_layer("output", OutputLayer(n_out=self.num_classes,
                                          loss_function="MCXENT"), "gap")
         .set_outputs("output"))
        return g.build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)
