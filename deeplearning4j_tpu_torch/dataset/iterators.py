"""Device-cached batches (counterpart of
``deeplearning4j_tpu/dataset/iterators.py`` ``DeviceCachedIterator`` :81):
features and labels are uploaded to the device once, and every epoch
yields slices of them, so the training loop moves no data from the
host."""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import DeviceLike, default_device


def _is_multi(v) -> bool:
    return isinstance(v, (list, tuple)) and len(v) > 0 and \
        all(hasattr(e, "ndim") for e in v)


class DeviceCachedIterator:
    """A whole number of batches of ``features``/``labels`` (numpy arrays
    or tensors, or lists of them for several inputs), kept on ``device``
    (the CUDA card unless ``device="cpu"``); the tail short of a batch is
    dropped."""

    def __init__(self, features, labels, batch_size: int = 32,
                 device: DeviceLike = None):
        self.device = default_device(device)
        self._multi_f, self._multi_l = _is_multi(features), _is_multi(labels)
        feats = list(features) if self._multi_f else [features]
        labs = list(labels) if self._multi_l else [labels]
        lens = {len(a) for a in feats + labs}
        if len(lens) != 1:
            raise ValueError(
                f"all feature/label arrays must share the leading length; "
                f"got {[len(a) for a in feats]} / {[len(a) for a in labs]}")
        n = (lens.pop() // batch_size) * batch_size
        if n == 0:
            raise ValueError("dataset smaller than one batch")
        self._batch, self._n = batch_size, n

        def _put(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            return t[:n].to(self.device)

        self.Xs = [_put(f) for f in feats]
        self.Ys = [_put(y) for y in labs]

    def __iter__(self):
        for i in range(0, self._n, self._batch):
            fs = [x[i:i + self._batch] for x in self.Xs]
            ls = [y[i:i + self._batch] for y in self.Ys]
            yield (fs if self._multi_f else fs[0],
                   ls if self._multi_l else ls[0])
