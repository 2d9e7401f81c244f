"""Client-shard partitioning.

Copy of `bflc_demo_tpu/data/partition.py` (`one_hot`, `iid_shards`),
numpy only, byte-identical output.  Dropped: `dirichlet_shards`, which
only the image presets (configs 2-3) use.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(y), num_classes), np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out


def iid_shards(x: np.ndarray, y: np.ndarray, num_clients: int,
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Contiguous near-equal shards (np.array_split semantics)."""
    xs = np.array_split(x, num_clients)
    ys = np.array_split(y, num_clients)
    return list(zip(xs, ys))
