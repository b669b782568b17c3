from deeplearning4j_tpu_torch.nn.conf import (ListBuilder,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conv_layers import (
    Cropping2DLayer, Deconvolution2DLayer, DepthwiseConvolution2DLayer,
    LocalResponseNormalization, SeparableConvolution2DLayer,
    Upsampling2DLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph, ComputationGraphConfiguration, DotProductVertex,
    ElementWiseVertex, GraphBuilder, GraphVertex, L2NormalizeVertex,
    MergeVertex, ScaleVertex, ShiftVertex, SubsetVertex)
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer, DenseLayer,
                                                DropoutLayer,
                                                GlobalPoolingLayer,
                                                InputType, LossLayer,
                                                LSTMLayer, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers_ext import (CenterLossOutputLayer,
                                                    CnnLossLayer,
                                                    DepthToSpaceLayer,
                                                    GravesLSTMLayer,
                                                    GRULayer,
                                                    SpaceToDepthLayer,
                                                    Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.noise_layers import (AlphaDropoutLayer,
                                                      GaussianDropoutLayer,
                                                      GaussianNoiseLayer,
                                                      SpatialDropoutLayer)
from deeplearning4j_tpu_torch.nn.recurrent_layers import (
    Bidirectional, ConvLSTM2DLayer, LastTimeStepLayer, RnnOutputLayer,
    SimpleRnnLayer)

__all__ = ["ActivationLayer", "AlphaDropoutLayer", "BatchNormalization",
           "Bidirectional", "GRULayer", "GaussianDropoutLayer",
           "GaussianNoiseLayer", "GravesLSTMLayer", "SpatialDropoutLayer",
           "CenterLossOutputLayer", "CnnLossLayer", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvLSTM2DLayer",
           "ConvolutionLayer", "Cropping2DLayer", "Deconvolution2DLayer",
           "DenseLayer", "DepthToSpaceLayer", "DepthwiseConvolution2DLayer",
           "DotProductVertex", "DropoutLayer", "ElementWiseVertex",
           "GlobalPoolingLayer", "GraphBuilder", "GraphVertex", "InputType",
           "L2NormalizeVertex", "LSTMLayer", "LastTimeStepLayer",
           "ListBuilder", "LocalResponseNormalization", "LossLayer",
           "MergeVertex", "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "OutputLayer", "RnnOutputLayer",
           "ScaleVertex", "SeparableConvolution2DLayer", "ShiftVertex",
           "SimpleRnnLayer", "SpaceToDepthLayer", "SubsamplingLayer",
           "SubsetVertex", "Upsampling2DLayer", "Yolo2OutputLayer",
           "ZeroPaddingLayer"]
