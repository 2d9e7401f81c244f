"""Client-shard partitioning.

Copy of `bflc_demo_tpu/data/partition.py` (`one_hot`, `iid_shards`,
`dirichlet_shards` :31-55), numpy only, byte-identical output: the
Dirichlet split makes the same `default_rng(seed)` draws in the same
order.
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


def dirichlet_shards(x: np.ndarray, y: np.ndarray, num_clients: int,
                     alpha: float = 0.5, seed: int = 0, min_size: int = 2,
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Label-skew non-IID: per class, split indices by Dirichlet(alpha)
    proportions; lower alpha = more skew.  Re-draws until every client
    holds at least `min_size` examples."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    for _ in range(100):
        idx_per_client: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.flatnonzero(y == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[client].extend(part.tolist())
        if min(len(ix) for ix in idx_per_client) >= min_size:
            return [(x[np.asarray(ix, dtype=np.intp)],
                     y[np.asarray(ix, dtype=np.intp)])
                    for ix in idx_per_client]
    raise ValueError(
        f"could not draw a Dirichlet(alpha={alpha}) split giving every one "
        f"of {num_clients} clients >= {min_size} examples from {len(x)} "
        f"rows")
