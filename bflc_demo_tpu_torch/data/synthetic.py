"""Seeded stand-ins for the presets' datasets.

Copy of `bflc_demo_tpu/data/synthetic.py` (:19-117), numpy only, with
byte-identical output for the same arguments: the class-template image
generator, the MNIST / CIFAR-10 / CIFAR-100 / FEMNIST-shaped sets, the
SST-2-shaped token data, and `load_image_dataset`.  Nothing is
downloaded: a real set is read only from `$BFLC_DATA_DIR/<name>.npz`
when it is there (arrays 'x' (N, H, W, C) in [0, 1] and 'y' (N,)),
checked for shape, label range and pixel range as the reference checks
it; otherwise the seeded stand-in is the data.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def synthetic_image_classification(n: int, shape: Tuple[int, ...],
                                   num_classes: int, seed: int = 0,
                                   noise: float = 0.35,
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Class template + Gaussian noise images in [0, 1]; learnable by a
    linear probe but not trivially (noise swamps individual pixels)."""
    rng = np.random.default_rng(seed)
    templates = rng.random((num_classes,) + tuple(shape), np.float32)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = templates[y] + rng.standard_normal((n,) + tuple(shape)).astype(
        np.float32) * noise
    return np.clip(x, 0.0, 1.0).astype(np.float32), y


def _real_or_synthetic(name: str, n: int, shape, num_classes: int,
                       seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """$BFLC_DATA_DIR/<name>.npz when present (validated, subsampled to n
    by a seeded permutation), else the seeded synthetic stand-in."""
    data_dir = os.environ.get("BFLC_DATA_DIR", "")
    if data_dir:
        path = os.path.join(data_dir, f"{name}.npz")
        if os.path.exists(path):
            x, y = load_image_dataset(path)
            if tuple(x.shape[1:]) != tuple(shape):
                raise ValueError(f"{path}: images are {x.shape[1:]}, "
                                 f"config expects {shape}")
            if int(y.min()) < 0 or int(y.max()) >= num_classes:
                raise ValueError(f"{path}: labels span "
                                 f"[{int(y.min())}, {int(y.max())}], "
                                 f"need [0, {num_classes})")
            if float(x.min()) < 0.0 or float(x.max()) > 1.0:
                raise ValueError(f"{path}: pixel range "
                                 f"[{float(x.min()):g}, "
                                 f"{float(x.max()):g}] violates the [0, 1] "
                                 f"contract (0-255 file? divide by 255)")
            if n and len(x) < n:
                raise ValueError(f"{path}: {len(x)} samples < requested "
                                 f"{n}; lower n_data or provide more data")
            if n and len(x) > n:
                rng = np.random.default_rng(seed)
                idx = rng.permutation(len(x))[:n]
                return x[idx], y[idx]
            return x, y
    return synthetic_image_classification(n, shape, num_classes, seed)


def synthetic_mnist(n: int = 6000, seed: int = 0):
    return _real_or_synthetic("mnist", n, (28, 28, 1), 10, seed)


def synthetic_cifar10(n: int = 6000, seed: int = 0):
    return _real_or_synthetic("cifar10", n, (32, 32, 3), 10, seed)


def synthetic_cifar100(n: int = 6000, seed: int = 0):
    return _real_or_synthetic("cifar100", n, (32, 32, 3), 100, seed)


def synthetic_femnist(n: int = 8000, seed: int = 0):
    return _real_or_synthetic("femnist", n, (28, 28, 1), 62, seed)


def synthetic_text_classification(n: int, seq_len: int = 64,
                                  vocab_size: int = 1000,
                                  num_classes: int = 2, seed: int = 0,
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional unigram mixtures over a shared background
    distribution (id 0 = PAD), with a random padded tail per row."""
    rng = np.random.default_rng(seed)
    background = rng.dirichlet([0.1] * (vocab_size - 1))
    class_dists = []
    for _ in range(num_classes):
        signal = rng.dirichlet([0.05] * (vocab_size - 1))
        class_dists.append(0.7 * background + 0.3 * signal)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = np.zeros((n, seq_len), np.int32)
    for c in range(num_classes):
        idx = np.flatnonzero(y == c)
        draws = rng.choice(vocab_size - 1, size=(len(idx), seq_len),
                           p=class_dists[c]) + 1
        x[idx] = draws.astype(np.int32)
    # variable lengths: pad a random tail with 0
    lengths = rng.integers(seq_len // 2, seq_len + 1, n)
    for i in range(n):
        x[i, lengths[i]:] = 0
    return x, y


def load_image_dataset(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """An .npz with arrays 'x' (N, H, W, C in [0, 1]) and 'y' (N,) int
    labels, as (float32, int32)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path) as z:
        return (np.asarray(z["x"], np.float32),
                np.asarray(z["y"], np.int32))
