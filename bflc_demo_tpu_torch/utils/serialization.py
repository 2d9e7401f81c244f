"""Canonical tensor bytes and the 32-byte content hash.

Copy of `bflc_demo_tpu/utils/serialization.py` — `_leaf_entries`,
`_encode_entries`, `canonical_bytes` and `hash_pytree` (:165-208) — so a
port model and a reference model with the same values hash to the same
bytes:

    magic | count | for each leaf in sorted key order:
        key | dtype string ('<f4') | ndim | shape | raw little-endian bytes

The reference flattens a JAX pytree and keys each leaf by its
`jax.tree_util.keystr` path (`['blocks'][0]['wq']`).  The port has no
pytrees: it hashes a flat `{keystr: tensor}` mapping (what
`models.base.canonical_params` returns), read through
`.detach().cpu().numpy()` in the reference's orientation.  Dropped: the
wire/checkpoint codecs (pack/unpack, quantize, sparsify, sketch), which
the host round never moves.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Mapping, Tuple, Union

import numpy as np
import torch

_MAGIC = b"BFLCT\x01"

Leaf = Union[torch.Tensor, np.ndarray]


def _as_numpy(leaf: Leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_entries(flat: Mapping[str, Leaf]) -> List[Tuple[str, np.ndarray]]:
    # sorted by key, as the reference sorts its keystr paths, so insertion
    # order can never leak into the hash
    return sorted(((k, _as_numpy(v)) for k, v in flat.items()),
                  key=lambda kv: kv[0])


def _encode_entries(entries: List[Tuple[str, np.ndarray]]) -> bytes:
    out = [_MAGIC, struct.pack("<q", len(entries))]
    for key, arr in entries:
        kb = key.encode()
        # '<f4' style codes carry endianness; extension dtypes stringify as
        # opaque '<V2', so the reference writes their registered name
        ds = arr.dtype.str
        db = (arr.dtype.name if ds.endswith(f"V{arr.dtype.itemsize}")
              else ds).encode()
        out.append(struct.pack("<q", len(kb)))
        out.append(kb)
        out.append(struct.pack("<q", len(db)))
        out.append(db)
        out.append(struct.pack("<q", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        raw = np.ascontiguousarray(arr).tobytes()
        out.append(struct.pack("<q", len(raw)))
        out.append(raw)
    return b"".join(out)


def canonical_bytes(flat: Mapping[str, Leaf]) -> bytes:
    return _encode_entries(_leaf_entries(flat))


def hash_pytree(flat: Mapping[str, Leaf]) -> bytes:
    """32-byte content hash — the ledger's view of a tensor payload."""
    return hashlib.sha256(canonical_bytes(flat)).digest()
