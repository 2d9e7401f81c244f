"""Seeded SST-2-shaped token data.

Copy of `bflc_demo_tpu/data/synthetic.py:synthetic_text_classification`
(numpy only; byte-identical output for the same arguments).  Dropped: the
image generators and the `.npz` loader, which only configs 0-4 use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
