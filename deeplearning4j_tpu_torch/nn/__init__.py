from deeplearning4j_tpu_torch.nn.conf import (ListBuilder,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conv_layers import ZeroPaddingLayer
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, DotProductVertex,
    ElementWiseVertex, GraphBuilder, GraphVertex, L2NormalizeVertex,
    MergeVertex, ScaleVertex, ShiftVertex, SubsetVertex)
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer, DenseLayer,
                                                GlobalPoolingLayer,
                                                InputType, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["ActivationLayer", "BatchNormalization", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvolutionLayer", "DenseLayer",
           "DotProductVertex", "ElementWiseVertex", "GlobalPoolingLayer",
           "GraphBuilder", "GraphVertex", "InputType", "L2NormalizeVertex",
           "ListBuilder", "MergeVertex", "MultiLayerConfiguration",
           "MultiLayerNetwork", "NeuralNetConfiguration", "OutputLayer",
           "ScaleVertex", "ShiftVertex", "SubsamplingLayer",
           "ZeroPaddingLayer"]
