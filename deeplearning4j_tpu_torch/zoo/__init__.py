from deeplearning4j_tpu_torch.zoo.bert import (BERT_BASE, BERT_TINY,
                                               BertConfig, bert_base,
                                               build_bert_graphdef)
from deeplearning4j_tpu_torch.zoo.gpt import (GPT_MEDIUM, GPT_TINY, GPTConfig,
                                              build_gpt, gpt_decode_fns,
                                              gpt_generative_spec,
                                              gpt_kv_scales,
                                              gpt_paged_decode_fns,
                                              gpt_paged_spec, gpt_param_names)
from deeplearning4j_tpu_torch.zoo.models import LeNet, ResNet50, TextGenLSTM

__all__ = ["BERT_BASE", "BERT_TINY", "BertConfig", "GPTConfig", "GPT_MEDIUM",
           "GPT_TINY", "LeNet", "ResNet50", "TextGenLSTM", "bert_base", "build_bert_graphdef",
           "build_gpt", "gpt_decode_fns", "gpt_generative_spec",
           "gpt_kv_scales", "gpt_paged_decode_fns", "gpt_paged_spec",
           "gpt_param_names"]
