"""MNIST-style idx data (counterpart of ``deeplearning4j_tpu/dataset/mnist.py``:
``_read_idx``, ``_find``, ``synthetic_mnist`` :49, ``load_mnist`` :62,
copied). Idx files are read from a directory when one is named
(``data_dir`` or the ``MNIST_DIR`` environment variable; the reference's
ubyte file names) and holds them; otherwise a deterministic synthetic
digit set is made, the same arrays as the JAX package's for the same
seed. Nothing is downloaded, and no directory is read by default."""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(dir_: str, base: str) -> Optional[str]:
    for cand in (base, base + ".gz"):
        p = os.path.join(dir_, cand)
        if os.path.exists(p):
            return p
    return None


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable digit-like data: each class is a distinct
    bright 7x7 patch pattern + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    X = rng.normal(0.1, 0.05, size=(n, 1, 28, 28)).astype(np.float32)
    for c in range(10):
        r, col = divmod(c, 4)
        mask = labels == c
        X[mask, 0, 7 * r:7 * r + 7, 7 * col:7 * col + 7] += 0.8
    return np.clip(X, 0, 1), labels.astype(np.int64)


def load_mnist(train: bool = True, data_dir: Optional[str] = None,
               n_synthetic: int = 8192):
    """(features NCHW float32 in [0,1], int labels). Real data when idx
    files exist, synthetic otherwise."""
    data_dir = data_dir or os.environ.get("MNIST_DIR")
    key = "train" if train else "test"
    found = data_dir is not None and os.path.isdir(data_dir)
    img = _find(data_dir, _FILES[f"{key}_images"]) if found else None
    lab = _find(data_dir, _FILES[f"{key}_labels"]) if found else None
    if img and lab:
        X = _read_idx(img).astype(np.float32)[:, None, :, :] / 255.0
        y = _read_idx(lab).astype(np.int64)
        return X, y
    return synthetic_mnist(n_synthetic if train else n_synthetic // 4,
                           seed=0 if train else 1)
