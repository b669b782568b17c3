"""Zoo models (counterpart of ``deeplearning4j_tpu/zoo/models.py``).

``LeNet`` (:34), ``SimpleCNN`` (:71), ``AlexNet`` (:106), ``VGG16``
(:161), ``ResNet50`` (:196) and ``TextGenLSTM`` (:323) make the same DSL
calls as the JAX package's, so each graph is node for node the
JAX one, with the same parameter names and the same initial weights from
the same seed.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.learning.updaters import (Adam, IUpdater,
                                                        Nesterovs)
from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalization, ComputationGraph, ConvolutionLayer,
    DenseLayer, DropoutLayer, ElementWiseVertex, GlobalPoolingLayer,
    InputType, LocalResponseNormalization, LSTMLayer, MultiLayerNetwork,
    NeuralNetConfiguration, OutputLayer, RnnOutputLayer, SubsamplingLayer,
    ZeroPaddingLayer)


@dataclasses.dataclass
class LeNet:
    """LeNet-5-style CNN (reference: zoo/model/LeNet.java:85-133): conv
    5x5x20 relu, max pool 2, conv 5x5x50 relu, max pool 2, dense 500
    relu, softmax output; Adam(1e-3)."""
    height: int = 28
    width: int = 28
    channels: int = 1
    num_classes: int = 10
    seed: int = 1234
    updater: IUpdater = None

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Adam(learning_rate=1e-3))
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu",
                                        convolution_mode="SAME"))
                .layer(SubsamplingLayer(pooling_type="MAX",
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu",
                                        convolution_mode="SAME"))
                .layer(SubsamplingLayer(pooling_type="MAX",
                                        kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   loss_function="MCXENT"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)


@dataclasses.dataclass
class SimpleCNN:
    """Compact CNN (reference: zoo/model/SimpleCNN.java — 4 conv blocks
    with BN, dropout head)."""
    height: int = 48
    width: int = 48
    channels: int = 3
    num_classes: int = 10
    seed: int = 1234
    updater: IUpdater = None

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .list())
        for n_out in (16, 32, 64, 128):
            b = (b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                          activation="relu",
                                          convolution_mode="SAME"))
                 .layer(BatchNormalization())
                 .layer(SubsamplingLayer(pooling_type="MAX",
                                         kernel_size=(2, 2), stride=(2, 2))))
        return (b.layer(DropoutLayer(dropout=0.5))
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   loss_function="MCXENT"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)


@dataclasses.dataclass
class AlexNet:
    """AlexNet (reference: zoo/model/AlexNet.java — conv11/4, LRN, conv5,
    LRN, 3x conv3, dense 4096 x2 with dropout)."""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(learning_rate=1e-2,
                                                   momentum=0.9))
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4),
                                        convolution_mode="VALID",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(pooling_type="MAX",
                                        kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        convolution_mode="SAME",
                                        activation="relu", bias_init=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(pooling_type="MAX",
                                        kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="SAME",
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="SAME",
                                        activation="relu", bias_init=1.0))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode="SAME",
                                        activation="relu", bias_init=1.0))
                .layer(SubsamplingLayer(pooling_type="MAX",
                                        kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   loss_function="MCXENT"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)


@dataclasses.dataclass
class VGG16:
    """VGG-16 (reference: zoo/model/VGG16.java — 13 conv3x3 + 3 dense)."""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(learning_rate=1e-2,
                                                momentum=0.9))
             .list())
        for n_out, reps in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
            for _ in range(reps):
                b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                             convolution_mode="SAME",
                                             activation="relu"))
            b = b.layer(SubsamplingLayer(pooling_type="MAX",
                                         kernel_size=(2, 2), stride=(2, 2)))
        return (b.layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   loss_function="MCXENT"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)


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


@dataclasses.dataclass
class TextGenLSTM:
    """Character-level text-generation LSTM (reference:
    zoo/model/TextGenerationLSTM.java): two stacked LSTMs and a softmax
    head a timestep over ``vocab_size`` characters; Adam(1e-3)."""
    vocab_size: int = 77
    timesteps: int = 40
    units: int = 256
    seed: int = 12345
    updater: IUpdater = None

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Adam(learning_rate=1e-3))
                .list()
                .layer(LSTMLayer(n_out=self.units))
                .layer(LSTMLayer(n_out=self.units))
                .layer(RnnOutputLayer(n_out=self.vocab_size,
                                      loss_function="MCXENT"))
                .set_input_type(InputType.recurrent(self.vocab_size,
                                                    self.timesteps))
                .build())

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)
