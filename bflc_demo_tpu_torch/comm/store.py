"""Content-addressed tensor store — the off-ledger payload plane.

Port of `bflc_demo_tpu/comm/store.py`: payloads (flat `{keystr: tensor}`
deltas) stay in device memory keyed by their content hash; only the
32-byte keys go into the ledger.  `get` rehashes, so a payload mutated
after `put` is caught before anyone scores or merges it.
"""

from __future__ import annotations

from typing import Dict

import torch

from bflc_demo_tpu_torch.utils.serialization import hash_pytree

Params = Dict[str, torch.Tensor]


class UpdateStore:
    def __init__(self):
        self._blobs: Dict[bytes, Params] = {}

    def put(self, tree: Params) -> bytes:
        h = hash_pytree(tree)
        self._blobs[h] = tree
        return h

    def get(self, h: bytes) -> Params:
        tree = self._blobs[h]
        if hash_pytree(tree) != h:
            raise ValueError(f"payload integrity failure for {h.hex()[:16]}…")
        return tree

    def drop(self, h: bytes) -> None:
        self._blobs.pop(h, None)

    def __len__(self) -> int:
        return len(self._blobs)
