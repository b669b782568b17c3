from deeplearning4j_tpu_torch.dataset.dataset import DataSet
from deeplearning4j_tpu_torch.dataset.iterators import DeviceCachedIterator
from deeplearning4j_tpu_torch.dataset.mnist import load_mnist, synthetic_mnist

__all__ = ["DataSet", "DeviceCachedIterator", "load_mnist", "synthetic_mnist"]
