from deeplearning4j_tpu_torch.zoo.gpt import (GPT_MEDIUM, GPT_TINY, GPTConfig,
                                              build_gpt, gpt_decode_fns,
                                              gpt_generative_spec,
                                              gpt_paged_decode_fns,
                                              gpt_paged_spec, gpt_param_names)
from deeplearning4j_tpu_torch.zoo.models import LeNet, ResNet50

__all__ = ["GPTConfig", "GPT_MEDIUM", "GPT_TINY", "LeNet", "ResNet50", "build_gpt",
           "gpt_decode_fns", "gpt_generative_spec", "gpt_paged_decode_fns",
           "gpt_paged_spec", "gpt_param_names"]
