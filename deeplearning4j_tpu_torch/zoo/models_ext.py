"""Zoo models of the JAX package's second wave (counterpart of
``deeplearning4j_tpu/zoo/models_ext.py``: ``SqueezeNet`` :32, ``UNet``
:91, ``Xception`` :145, ``Darknet19`` :246, ``TinyYOLO`` :281).

Each makes the same DSL calls as the JAX class, so its network is node
for node the JAX one, with the same parameter names and the same initial
weights from the same seed; ``build(device)`` initializes it on the card
unless ``device="cpu"``. All sizes are constructor parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.learning.updaters import Adam, IUpdater
from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalization, CnnLossLayer, ComputationGraph,
    ConvolutionLayer, Deconvolution2DLayer, ElementWiseVertex,
    GlobalPoolingLayer, InputType, MergeVertex, MultiLayerNetwork,
    NeuralNetConfiguration, OutputLayer, SeparableConvolution2DLayer,
    SubsamplingLayer, Yolo2OutputLayer)

@dataclasses.dataclass
class SqueezeNet:
    """(reference: zoo/model/SqueezeNet.java)"""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    def _fire(self, g, name, inp, squeeze, expand):
        (g.add_layer(f"{name}_sq", ConvolutionLayer(
            n_out=squeeze, kernel_size=(1, 1), activation="relu",
            convolution_mode="VALID"), inp)
         .add_layer(f"{name}_e1", ConvolutionLayer(
             n_out=expand, kernel_size=(1, 1), activation="relu",
             convolution_mode="VALID"), f"{name}_sq")
         .add_layer(f"{name}_e3", ConvolutionLayer(
             n_out=expand, kernel_size=(3, 3), activation="relu",
             convolution_mode="SAME"), f"{name}_sq")
         .add_vertex(f"{name}", MergeVertex(), f"{name}_e1", f"{name}_e3"))
        return name

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("conv1", ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), stride=(2, 2), activation="relu",
            convolution_mode="VALID"), "input")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), "conv1")
        prev = self._fire(g, "fire2", "pool1", 16, 64)
        prev = self._fire(g, "fire3", prev, 16, 64)
        g.add_layer("pool3", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), prev)
        prev = self._fire(g, "fire4", "pool3", 32, 128)
        prev = self._fire(g, "fire5", prev, 32, 128)
        g.add_layer("pool5", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), prev)
        prev = self._fire(g, "fire6", "pool5", 48, 192)
        prev = self._fire(g, "fire7", prev, 48, 192)
        prev = self._fire(g, "fire8", prev, 64, 256)
        prev = self._fire(g, "fire9", prev, 64, 256)
        g.add_layer("conv10", ConvolutionLayer(
            n_out=self.num_classes, kernel_size=(1, 1), activation="relu",
            convolution_mode="VALID"), prev)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="AVG"), "conv10")
        g.add_layer("out", OutputLayer(
            n_out=self.num_classes, loss_function="MCXENT",
            has_bias=True), "gap")
        return g.set_outputs("out").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)


@dataclasses.dataclass
class UNet:
    """(reference: zoo/model/UNet.java; depth trimmed by `features`)"""
    height: int = 64
    width: int = 64
    channels: int = 1
    features: int = 16          # reference uses 64; scalable
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        f = self.features
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv_block(name, inp, n):
            (g.add_layer(f"{name}a", ConvolutionLayer(
                n_out=n, kernel_size=(3, 3), activation="relu",
                convolution_mode="SAME"), inp)
             .add_layer(f"{name}b", ConvolutionLayer(
                 n_out=n, kernel_size=(3, 3), activation="relu",
                 convolution_mode="SAME"), f"{name}a"))
            return f"{name}b"

        e1 = conv_block("enc1", "input", f)
        g.add_layer("pool1", SubsamplingLayer(kernel_size=(2, 2)), e1)
        e2 = conv_block("enc2", "pool1", 2 * f)
        g.add_layer("pool2", SubsamplingLayer(kernel_size=(2, 2)), e2)
        mid = conv_block("mid", "pool2", 4 * f)
        g.add_layer("up2", Deconvolution2DLayer(
            n_out=2 * f, kernel_size=(2, 2), stride=(2, 2),
            activation="relu"), mid)
        g.add_vertex("cat2", MergeVertex(), "up2", e2)
        d2 = conv_block("dec2", "cat2", 2 * f)
        g.add_layer("up1", Deconvolution2DLayer(
            n_out=f, kernel_size=(2, 2), stride=(2, 2),
            activation="relu"), d2)
        g.add_vertex("cat1", MergeVertex(), "up1", e1)
        d1 = conv_block("dec1", "cat1", f)
        # per-pixel sigmoid head (reference: 1x1 conv + sigmoid)
        g.add_layer("head", ConvolutionLayer(
            n_out=1, kernel_size=(1, 1), convolution_mode="VALID"), d1)
        g.add_layer("out", CnnLossLayer(loss_function="XENT",
                                        activation="sigmoid"), "head")
        return g.set_outputs("out").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)


@dataclasses.dataclass
class Xception:
    """(reference: zoo/model/Xception.java; middle flow depth scalable)"""
    height: int = 299
    width: int = 299
    channels: int = 3
    num_classes: int = 1000
    middle_blocks: int = 8
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        (g.add_layer("conv1", ConvolutionLayer(
            n_out=32, kernel_size=(3, 3), stride=(2, 2), activation="relu",
            convolution_mode="VALID"), "input")
         .add_layer("bn1", BatchNormalization(), "conv1")
         .add_layer("conv2", ConvolutionLayer(
             n_out=64, kernel_size=(3, 3), activation="relu",
             convolution_mode="SAME"), "bn1")
         .add_layer("bn2", BatchNormalization(), "conv2"))
        prev, width = "bn2", 64

        def xception_block(name, inp, n_in, n_out, relu_first=True):
            cur = inp
            if relu_first:
                g.add_layer(f"{name}_act0", ActivationLayer(
                    activation="relu"), cur)
                cur = f"{name}_act0"
            (g.add_layer(f"{name}_s1", SeparableConvolution2DLayer(
                n_out=n_out, kernel_size=(3, 3),
                convolution_mode="SAME"), cur)
             .add_layer(f"{name}_bn1", BatchNormalization(), f"{name}_s1")
             .add_layer(f"{name}_act1", ActivationLayer(activation="relu"),
                        f"{name}_bn1")
             .add_layer(f"{name}_s2", SeparableConvolution2DLayer(
                 n_out=n_out, kernel_size=(3, 3),
                 convolution_mode="SAME"), f"{name}_act1")
             .add_layer(f"{name}_bn2", BatchNormalization(), f"{name}_s2")
             .add_layer(f"{name}_pool", SubsamplingLayer(
                 kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="SAME"), f"{name}_bn2")
             .add_layer(f"{name}_short", ConvolutionLayer(
                 n_out=n_out, kernel_size=(1, 1), stride=(2, 2),
                 convolution_mode="SAME"), inp))
            g.add_vertex(f"{name}", ElementWiseVertex(op="Add"),
                         f"{name}_pool", f"{name}_short")
            return name

        for n_out, name in ((128, "entry2"), (256, "entry3"),
                            (728, "entry4")):
            prev = xception_block(name, prev, width, n_out,
                                  relu_first=(name != "entry2"))
            width = n_out

        for i in range(self.middle_blocks):
            nm = f"mid{i}"
            cur = prev
            for j in range(3):
                (g.add_layer(f"{nm}_act{j}", ActivationLayer(
                    activation="relu"), cur)
                 .add_layer(f"{nm}_s{j}", SeparableConvolution2DLayer(
                     n_out=728, kernel_size=(3, 3),
                     convolution_mode="SAME"), f"{nm}_act{j}")
                 .add_layer(f"{nm}_bn{j}", BatchNormalization(),
                            f"{nm}_s{j}"))
                cur = f"{nm}_bn{j}"
            g.add_vertex(nm, ElementWiseVertex(op="Add"), cur, prev)
            prev = nm

        (g.add_layer("exit_s1", SeparableConvolution2DLayer(
            n_out=1024, kernel_size=(3, 3), activation="relu",
            convolution_mode="SAME"), prev)
         .add_layer("exit_bn1", BatchNormalization(), "exit_s1")
         .add_layer("exit_s2", SeparableConvolution2DLayer(
             n_out=1536, kernel_size=(3, 3), activation="relu",
             convolution_mode="SAME"), "exit_bn1")
         .add_layer("gap", GlobalPoolingLayer(pooling_type="AVG"),
                    "exit_s2")
         .add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss_function="MCXENT"), "gap"))
        return g.set_outputs("out").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)


def _darknet_conv(b, n_out, kernel):
    b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(kernel, kernel),
                             convolution_mode="SAME", has_bias=False))
    b.layer(BatchNormalization())
    b.layer(ActivationLayer(activation="leaky_relu"))
    return b


@dataclasses.dataclass
class Darknet19:
    """(reference: zoo/model/Darknet19.java)"""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).list())
        plan = [(32, 3, True), (64, 3, True),
                (128, 3, False), (64, 1, False), (128, 3, True),
                (256, 3, False), (128, 1, False), (256, 3, True),
                (512, 3, False), (256, 1, False), (512, 3, False),
                (256, 1, False), (512, 3, True),
                (1024, 3, False), (512, 1, False), (1024, 3, False),
                (512, 1, False), (1024, 3, False)]
        for n_out, k, pool in plan:
            _darknet_conv(b, n_out, k)
            if pool:
                b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                 convolution_mode="VALID"))
        b.layer(GlobalPoolingLayer(pooling_type="AVG"))
        b.layer(OutputLayer(n_out=self.num_classes, loss_function="MCXENT"))
        return b.set_input_type(InputType.convolutional(
            self.height, self.width, self.channels)).build()

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)


@dataclasses.dataclass
class TinyYOLO:
    """(reference: zoo/model/TinyYOLO.java — Darknet trunk + YOLOv2 head;
    anchors in grid units)"""
    height: int = 416
    width: int = 416
    channels: int = 3
    num_classes: int = 20
    anchors: Tuple[float, ...] = (1.08, 1.19, 3.42, 4.41, 6.63, 11.38,
                                  9.42, 5.11, 16.62, 10.52)
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        n_anchors = len(self.anchors) // 2
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).list())
        for i, n_out in enumerate((16, 32, 64, 128, 256, 512)):
            _darknet_conv(b, n_out, 3)
            if i < 5:
                b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        _darknet_conv(b, 1024, 3)
        _darknet_conv(b, 1024, 3)
        b.layer(ConvolutionLayer(
            n_out=n_anchors * (5 + self.num_classes), kernel_size=(1, 1),
            convolution_mode="VALID"))
        b.layer(Yolo2OutputLayer(anchors=self.anchors))
        return b.set_input_type(InputType.convolutional(
            self.height, self.width, self.channels)).build()

    def build(self, device: DeviceLike = None) -> MultiLayerNetwork:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return MultiLayerNetwork(self.conf()).init(device)
