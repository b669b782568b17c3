from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conv_layers import ZeroPaddingLayer
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration,
                                               ElementWiseVertex,
                                               GraphBuilder)
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer, DenseLayer,
                                                GlobalPoolingLayer,
                                                InputType, OutputLayer,
                                                SubsamplingLayer)

__all__ = ["ActivationLayer", "BatchNormalization", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvolutionLayer", "DenseLayer",
           "ElementWiseVertex", "GlobalPoolingLayer", "GraphBuilder",
           "InputType", "NeuralNetConfiguration", "OutputLayer",
           "SubsamplingLayer", "ZeroPaddingLayer"]
