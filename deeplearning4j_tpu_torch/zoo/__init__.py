from deeplearning4j_tpu_torch.zoo.bert import (BERT_BASE, BERT_TINY,
                                               BertConfig, bert_base,
                                               build_bert_graphdef)
from deeplearning4j_tpu_torch.zoo.gpt import (GPT_MEDIUM, GPT_TINY, GPTConfig,
                                              build_gpt, gpt_decode_fns,
                                              gpt_generative_spec,
                                              gpt_kv_scales,
                                              gpt_paged_decode_fns,
                                              gpt_paged_spec, gpt_param_names)
from deeplearning4j_tpu_torch.zoo.models import (VGG16, AlexNet, LeNet,
                                                  ResNet50, SimpleCNN,
                                                  TextGenLSTM)
from deeplearning4j_tpu_torch.zoo.models_ext import (UNet, Darknet19,
                                                      SqueezeNet, TinyYOLO,
                                                      Xception)
from deeplearning4j_tpu_torch.zoo.models_wave3 import (
    VGG19, YOLO2, FaceNet, InceptionResNetV1, NASNet)

__all__ = ["AlexNet", "BERT_BASE", "BERT_TINY", "BertConfig", "Darknet19",
           "FaceNet", "GPTConfig", "GPT_MEDIUM", "GPT_TINY",
           "InceptionResNetV1", "LeNet", "NASNet", "ResNet50", "SimpleCNN",
           "SqueezeNet", "TextGenLSTM", "TinyYOLO", "UNet", "VGG16", "VGG19",
           "Xception", "YOLO2", "bert_base", "build_bert_graphdef",
           "build_gpt", "gpt_decode_fns", "gpt_generative_spec",
           "gpt_kv_scales", "gpt_paged_decode_fns", "gpt_paged_spec",
           "gpt_param_names"]
