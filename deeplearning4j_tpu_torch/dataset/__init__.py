from deeplearning4j_tpu_torch.dataset.dataset import DataSet
from deeplearning4j_tpu_torch.dataset.iterators import DeviceCachedIterator

__all__ = ["DataSet", "DeviceCachedIterator"]
