"""A features/labels pair (counterpart of
``deeplearning4j_tpu/dataset/dataset.py`` ``DataSet``)."""
from __future__ import annotations

import numpy as np


class DataSet:
    def __init__(self, features, labels):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
