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
`.detach().cpu().numpy()` in the reference's orientation.

The blob codec of the process fleet (:211-260): `pack_pytree` and
`pack_entries` (the same canonical bytes, so `pack_entries(
unpack_pytree(b)) == b`), `unpack_pytree` (blob -> flat numpy entries)
and `restore_pytree` (entries -> tensors laid out like a template
`Params`).  A blob's SHA-256 is what a client signs and the ledger
certifies, so these are bit-exact.  `dequantize_entries` and
`densify_entries` are the decode chain every consumer runs; the port's
fleet moves only dense float32 deltas, on which both are the identity.
An entry in a codec's layout (a float16 leaf, or a key carrying the
`#qscale`, `#topk` or `#sketch` marker) raises `CodecNotPorted`, a
ValueError, so a writer refuses such an upload as undecodable.  Still
dropped: the codecs themselves (quantize, sparsify, sketch; ROADMAP A9)
and the checkpoint format (A11).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Mapping, Tuple, Union

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


# reserved key markers of the reference's codecs (quantized, top-k and
# count-sketch entries); '#' never occurs in a keystr path
_CODEC_MARKERS = ("#qscale", "#topk", "#sketch")


class CodecNotPorted(ValueError):
    """A blob entry in a codec layout the port does not decode yet."""


def pack_pytree(flat: Mapping[str, Leaf]) -> bytes:
    """The self-describing blob of a flat `{keystr: tensor}` mapping."""
    return canonical_bytes(flat)


def pack_entries(entries: Mapping[str, Leaf]) -> bytes:
    """Already-flat entries in the canonical layout:
    `pack_entries(unpack_pytree(blob)) == blob`."""
    return canonical_bytes(entries)


def unpack_pytree(data: bytes) -> Dict[str, np.ndarray]:
    """Blob -> `{keystr: numpy array}` (read-only views of `data`)."""
    if not data.startswith(_MAGIC):
        raise ValueError("not a bflc tensor blob (bad magic)")
    off = len(_MAGIC)

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return vals

    (n_entries,) = take("<q")
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_entries):
        (klen,) = take("<q")
        key = data[off:off + klen].decode()
        off += klen
        (dlen,) = take("<q")
        dtype = np.dtype(data[off:off + dlen].decode())
        off += dlen
        (ndim,) = take("<q")
        shape = take(f"<{ndim}q") if ndim else ()
        (rawlen,) = take("<q")
        out[key] = np.frombuffer(data[off:off + rawlen],
                                 dtype=dtype).reshape(shape)
        off += rawlen
    return out


def restore_pytree(template: Mapping[str, torch.Tensor],
                   flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """`unpack_pytree` output as tensors keyed, typed and placed like
    `template` (a `Params` dict).  KeyError on a missing leaf,
    ValueError on a shape mismatch."""
    out: Dict[str, torch.Tensor] = {}
    for key, want in template.items():
        if key not in flat:
            raise KeyError(f"blob missing leaf {key}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {key}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        out[key] = torch.as_tensor(np.array(arr), device=want.device).to(
            want.dtype)
    return out


def _dense_only(flat: Mapping[str, np.ndarray], what: str) -> None:
    for key, arr in flat.items():
        if any(m in key for m in _CODEC_MARKERS) or \
                np.asarray(arr).dtype == np.float16:
            raise CodecNotPorted(
                f"{what}: entry {key!r} is in a codec layout (f16/i8/top-k/"
                f"sketch), which the port does not decode yet (ROADMAP A9: "
                f"the delta codecs)")


def dequantize_entries(flat: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """The identity on dense float32 entries (the reference's inverse of
    its quantizer); a quantized entry raises `CodecNotPorted`."""
    _dense_only(flat, "dequantize")
    return flat


def densify_entries(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The identity on dense entries (the reference's inverse of its
    sparsifier); a top-k or sketch record raises `CodecNotPorted`."""
    _dense_only(flat, "densify")
    return flat
