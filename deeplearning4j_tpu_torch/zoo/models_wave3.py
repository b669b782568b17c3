"""Zoo models of the JAX package's third wave (counterpart of
``deeplearning4j_tpu/zoo/models_wave3.py``: ``VGG19`` :40,
``InceptionResNetV1`` :85, ``FaceNet`` :208, ``NASNet`` :233, ``YOLO2``
:308-384).

Each makes the same DSL calls as the JAX class, so its network is node
for node the JAX one, with the same parameter names and the same initial
weights from the same seed; ``build(device)`` initializes it on the card
unless ``device="cpu"``. ``YOLO2`` is Darknet-19's trunk, the
passthrough route from the /16 map through a space-to-depth ("reorg"),
the concatenation, and the ``Yolo2OutputLayer`` over the five VOC
anchors; its 22 batch norms each feed a leaky ReLU, so none is fused
with its activation and each backward is the plain BN kernel pair.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.learning.updaters import Adam, IUpdater, Nesterovs
from deeplearning4j_tpu_torch.nn import (
    ActivationLayer, BatchNormalization, ComputationGraph, ConvolutionLayer,
    DenseLayer, DropoutLayer, ElementWiseVertex, GlobalPoolingLayer,
    InputType, L2NormalizeVertex, MergeVertex, MultiLayerNetwork,
    NeuralNetConfiguration, OutputLayer, ScaleVertex,
    SeparableConvolution2DLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers_ext import (
    CenterLossOutputLayer, SpaceToDepthLayer, Yolo2OutputLayer)

@dataclasses.dataclass
class VGG19:
    """(reference: zoo/model/VGG19.java — VGG16 with conv counts
    2,2,4,4,4)."""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Nesterovs(learning_rate=1e-2,
                                                momentum=0.9)).list())
        for n_out, reps in ((64, 2), (128, 2), (256, 4), (512, 4),
                            (512, 4)):
            for _ in range(reps):
                b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         convolution_mode="SAME",
                                         activation="relu"))
            b.layer(SubsamplingLayer(pooling_type="MAX", kernel_size=(2, 2),
                                     stride=(2, 2)))
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


def _conv_bn(g, name, inp, n_out, kernel, stride=(1, 1), mode="SAME",
             act="relu"):
    g.add_layer(f"{name}_c", ConvolutionLayer(
        n_out=n_out, kernel_size=kernel, stride=stride,
        convolution_mode=mode, has_bias=False), inp)
    g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_c")
    g.add_layer(name, ActivationLayer(activation=act), f"{name}_bn")
    return name


@dataclasses.dataclass
class InceptionResNetV1:
    """Scaled-residual inception net (reference:
    zoo/model/InceptionResNetV1.java — stem, 5x block35, reduction-A,
    10x block17, reduction-B, 5x block8, avgpool, dropout, embedding).

    ``embedding_size > 0`` appends an L2-normalized embedding (the
    FaceNet configuration); otherwise a softmax head.
    """
    height: int = 160
    width: int = 160
    channels: int = 3
    num_classes: int = 1000
    blocks_a: int = 5
    blocks_b: int = 10
    blocks_c: int = 5
    embedding_size: int = 0
    center_loss: bool = False
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        # Stem (InceptionResNetV1.java: conv 3x3/2 .. conv 3x3/2 256)
        p = _conv_bn(g, "stem1", "input", 32, (3, 3), (2, 2))
        p = _conv_bn(g, "stem2", p, 32, (3, 3))
        p = _conv_bn(g, "stem3", p, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="MAX",
            convolution_mode="SAME"), p)
        p = _conv_bn(g, "stem4", "stem_pool", 80, (1, 1))
        p = _conv_bn(g, "stem5", p, 192, (3, 3))
        p = _conv_bn(g, "stem6", p, 256, (3, 3), (2, 2))

        def resblock(name, inp, width, branches, scale):
            """Concat branches -> 1x1 linear conv to `width` -> scale ->
            residual add -> relu (the block35/17/8 pattern)."""
            outs = []
            for bi, chain in enumerate(branches):
                cur = inp
                for ci, (n_out, kernel) in enumerate(chain):
                    cur = _conv_bn(g, f"{name}_b{bi}_{ci}", cur, n_out,
                                   kernel)
                outs.append(cur)
            g.add_vertex(f"{name}_cat", MergeVertex(), *outs)
            g.add_layer(f"{name}_up", ConvolutionLayer(
                n_out=width, kernel_size=(1, 1), activation="identity"),
                f"{name}_cat")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale_factor=scale),
                         f"{name}_up")
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="Add"),
                         inp, f"{name}_scale")
            g.add_layer(name, ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        for i in range(self.blocks_a):       # block35 x5, width 256
            p = resblock(f"a{i}", p, 256,
                         [[(32, (1, 1))],
                          [(32, (1, 1)), (32, (3, 3))],
                          [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]],
                         0.17)
        # Reduction-A: maxpool + conv3x3/2 384 + 1x1->3x3->3x3/2 256
        g.add_layer("redA_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="MAX",
            convolution_mode="SAME"), p)
        rA1 = _conv_bn(g, "redA_c1", p, 384, (3, 3), (2, 2))
        t = _conv_bn(g, "redA_c2a", p, 192, (1, 1))
        t = _conv_bn(g, "redA_c2b", t, 192, (3, 3))
        rA2 = _conv_bn(g, "redA_c2c", t, 256, (3, 3), (2, 2))
        g.add_vertex("redA", MergeVertex(), "redA_pool", rA1, rA2)
        p, width = "redA", 256 + 384 + 256

        for i in range(self.blocks_b):       # block17 x10
            p = resblock(f"b{i}", p, width,
                         [[(128, (1, 1))],
                          [(128, (1, 1)), (128, (1, 7)), (128, (7, 1))]],
                         0.10)
        # Reduction-B: maxpool + three conv chains
        g.add_layer("redB_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="MAX",
            convolution_mode="SAME"), p)
        t = _conv_bn(g, "redB_1a", p, 256, (1, 1))
        rB1 = _conv_bn(g, "redB_1b", t, 384, (3, 3), (2, 2))
        t = _conv_bn(g, "redB_2a", p, 256, (1, 1))
        rB2 = _conv_bn(g, "redB_2b", t, 256, (3, 3), (2, 2))
        t = _conv_bn(g, "redB_3a", p, 256, (1, 1))
        t = _conv_bn(g, "redB_3b", t, 256, (3, 3))
        rB3 = _conv_bn(g, "redB_3c", t, 256, (3, 3), (2, 2))
        g.add_vertex("redB", MergeVertex(), "redB_pool", rB1, rB2, rB3)
        p, width = "redB", width + 384 + 256 + 256

        for i in range(self.blocks_c):       # block8 x5
            p = resblock(f"c{i}", p, width,
                         [[(192, (1, 1))],
                          [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]],
                         0.20)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="AVG"), p)
        g.add_layer("drop", DropoutLayer(dropout=0.8), "gap")
        if self.embedding_size:
            g.add_layer("emb", DenseLayer(n_out=self.embedding_size,
                                          activation="identity"), "drop")
            g.add_vertex("embedding", L2NormalizeVertex(), "emb")
            if self.center_loss:
                g.add_layer("out", CenterLossOutputLayer(
                    n_out=self.num_classes), "embedding")
                return g.set_outputs("out").build()
            g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                           loss_function="MCXENT"),
                        "embedding")
            return g.set_outputs("out").build()
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss_function="MCXENT"), "drop")
        return g.set_outputs("out").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)


@dataclasses.dataclass
class FaceNet:
    """Face-embedding net (reference: zoo/model/FaceNetNN4Small2.java —
    inception trunk, 128-d L2-normalized embedding, center loss). Train
    with class labels; use activations at 'embedding' for verification."""
    height: int = 160
    width: int = 160
    channels: int = 3
    num_classes: int = 1000
    embedding_size: int = 128
    blocks_a: int = 5
    blocks_b: int = 10
    blocks_c: int = 5
    seed: int = 42
    updater: IUpdater = None

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        return InceptionResNetV1(
            height=self.height, width=self.width, channels=self.channels,
            num_classes=self.num_classes, blocks_a=self.blocks_a,
            blocks_b=self.blocks_b, blocks_c=self.blocks_c,
            embedding_size=self.embedding_size, center_loss=True,
            seed=self.seed, updater=self.updater).build(device)


@dataclasses.dataclass
class NASNet:
    """NASNet-A-class cell-stacked net (reference: zoo/model/NASNet.java:
    stem -> (normal x N, reduction) x3 -> pool/softmax; `penultimate
    filters` scale like the reference's mobile=1056 config)."""
    height: int = 224
    width: int = 224
    channels: int = 3
    num_classes: int = 1000
    cells_per_stack: int = 4
    stem_filters: int = 32
    filters: int = 44            # mobile config: 1056 / 24 ≈ 44 per cell
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        p = _conv_bn(g, "stem", "input", self.stem_filters, (3, 3), (2, 2))

        def sep(name, inp, n_out, kernel, stride=(1, 1)):
            g.add_layer(f"{name}_s", SeparableConvolution2DLayer(
                n_out=n_out, kernel_size=kernel, stride=stride,
                convolution_mode="SAME"), inp)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_s")
            g.add_layer(name, ActivationLayer(activation="relu"),
                        f"{name}_bn")
            return name

        def normal_cell(name, inp, f):
            # Branch sums then concat (NASNet-A normal cell skeleton).
            fit = _conv_bn(g, f"{name}_fit", inp, f, (1, 1))
            b1a = sep(f"{name}_b1a", fit, f, (3, 3))
            b1b = sep(f"{name}_b1b", fit, f, (5, 5))
            g.add_vertex(f"{name}_add1", ElementWiseVertex(op="Add"),
                         b1a, b1b)
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel_size=(3, 3), stride=(1, 1), pooling_type="AVG",
                convolution_mode="SAME"), fit)
            g.add_vertex(f"{name}_add2", ElementWiseVertex(op="Add"),
                         f"{name}_pool", fit)
            b3 = sep(f"{name}_b3", fit, f, (3, 3))
            g.add_vertex(name, MergeVertex(), f"{name}_add1",
                         f"{name}_add2", b3)
            return name, 3 * f

        def reduction_cell(name, inp, f):
            r1 = sep(f"{name}_r1", inp, f, (5, 5), (2, 2))
            r2 = sep(f"{name}_r2", inp, f, (7, 7), (2, 2))
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), pooling_type="MAX",
                convolution_mode="SAME"), inp)
            pfit = _conv_bn(g, f"{name}_pfit", f"{name}_pool", f, (1, 1))
            g.add_vertex(name, MergeVertex(), r1, r2, pfit)
            return name, 3 * f

        f = self.filters
        for stack in range(3):
            for i in range(self.cells_per_stack):
                p, _ = normal_cell(f"n{stack}_{i}", p, f)
            if stack < 2:
                p, _ = reduction_cell(f"r{stack}", p, f * 2)
                f *= 2
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="AVG"), p)
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss_function="MCXENT"), "gap")
        return g.set_outputs("out").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)


@dataclasses.dataclass
class YOLO2:
    """Full YOLOv2 (reference: zoo/model/YOLO2.java — Darknet-19 trunk,
    passthrough route from the /16 feature map via space-to-depth (the
    'reorg' layer), concat, 3x3 conv, 1x1 detection conv,
    Yolo2OutputLayer)."""
    height: int = 416
    width: int = 416
    channels: int = 3
    num_classes: int = 20
    anchors: Tuple[float, ...] = (0.57273, 0.677385, 1.87446, 2.06253,
                                  3.33843, 5.47434, 7.88282, 3.52778,
                                  9.77052, 9.16828)
    seed: int = 42
    updater: IUpdater = None

    def conf(self):
        n_anchors = len(self.anchors) // 2
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(1e-3)).graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def dconv(name, inp, n_out, k):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel_size=(k, k), convolution_mode="SAME",
                has_bias=False), inp)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_c")
            g.add_layer(name, ActivationLayer(activation="leaky_relu"),
                        f"{name}_bn")
            return name

        def pool(name, inp):
            g.add_layer(name, SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2), pooling_type="MAX"), inp)
            return name

        # Darknet-19 trunk (Darknet19.java plan), tapping the /16 map.
        p = dconv("c1", "input", 32, 3)
        p = pool("p1", p)
        p = dconv("c2", p, 64, 3)
        p = pool("p2", p)
        p = dconv("c3", p, 128, 3)
        p = dconv("c4", p, 64, 1)
        p = dconv("c5", p, 128, 3)
        p = pool("p3", p)
        p = dconv("c6", p, 256, 3)
        p = dconv("c7", p, 128, 1)
        p = dconv("c8", p, 256, 3)
        p = pool("p4", p)
        p = dconv("c9", p, 512, 3)
        p = dconv("c10", p, 256, 1)
        p = dconv("c11", p, 512, 3)
        p = dconv("c12", p, 256, 1)
        passthrough = dconv("c13", p, 512, 3)    # /16 feature map
        p = pool("p5", passthrough)
        p = dconv("c14", p, 1024, 3)
        p = dconv("c15", p, 512, 1)
        p = dconv("c16", p, 1024, 3)
        p = dconv("c17", p, 512, 1)
        p = dconv("c18", p, 1024, 3)
        # Detection head (YOLO2.java): two 3x3 1024 convs; passthrough
        # route = 1x1 64 conv + reorg(2) concatenated before the last conv.
        p = dconv("h1", p, 1024, 3)
        p = dconv("h2", p, 1024, 3)
        r = dconv("route", passthrough, 64, 1)
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2), r)
        g.add_vertex("cat", MergeVertex(), "reorg", p)
        p = dconv("h3", "cat", 1024, 3)
        g.add_layer("det", ConvolutionLayer(
            n_out=n_anchors * (5 + self.num_classes), kernel_size=(1, 1),
            convolution_mode="VALID"), p)
        g.add_layer("yolo", Yolo2OutputLayer(anchors=self.anchors), "det")
        return g.set_outputs("yolo").build()

    def build(self, device: DeviceLike = None) -> ComputationGraph:
        """The initialized network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        return ComputationGraph(self.conf()).init(device)
