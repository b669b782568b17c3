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
                                                InputType, LSTMLayer,
                                                OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.recurrent_layers import (
    Bidirectional, ConvLSTM2DLayer, LastTimeStepLayer, RnnOutputLayer,
    SimpleRnnLayer)

__all__ = ["ActivationLayer", "BatchNormalization", "Bidirectional",
           "ComputationGraph", "ComputationGraphConfiguration",
           "ConvLSTM2DLayer", "ConvolutionLayer", "DenseLayer",
           "DotProductVertex", "ElementWiseVertex", "GlobalPoolingLayer",
           "GraphBuilder", "GraphVertex", "InputType", "L2NormalizeVertex",
           "LSTMLayer", "LastTimeStepLayer", "ListBuilder", "MergeVertex",
           "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "OutputLayer", "RnnOutputLayer",
           "ScaleVertex", "ShiftVertex", "SimpleRnnLayer",
           "SubsamplingLayer", "ZeroPaddingLayer"]
