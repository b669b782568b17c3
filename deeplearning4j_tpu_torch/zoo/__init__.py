from deeplearning4j_tpu_torch.zoo.models import ResNet50

__all__ = ["ResNet50"]
