"""The canonical blob layout and the upload codecs, numpy on the host.

Copy of `bflc_demo_tpu/utils/serialization.py`: the canonical entry
encoder (`_encode_entries`, `canonical_bytes`, `hash_pytree`,
`pack_pytree`, `pack_entries`, `unpack_pytree`, :165-276) and the delta
codecs (:71-163, :283-636), so that every encoded byte and every decoded
bit equals the reference's:

- the reserved suffixes (`#qscale`, `#topk`, `#sketch`) and the decode
  bounds; `sparse_legacy`, `sparse_enabled`, `error_feedback_enabled`,
  `delta_codec` and `topk_count`;
- quantization: `quantize_entries` (f16, or i8 with a per-leaf f32
  scale), its one inverse `dequantize_entries`, and `pack_quantized`;
- sparsification: `sparsify_entries` (top-k, ties by ascending flat
  index through a stable argsort), `sketch_entries` (a seeded
  multiply-shift count-sketch, `_sketch_hashes`, `sketch_geometry`),
  their one inverse `densify_entries` with every hostile-blob check in
  the reference's order and with its messages, and `pack_sparse`.

A blob's SHA-256 is what a client signs and the chain certifies, so all
of this is bit-exact host work.  The reference flattens a JAX pytree and
keys each leaf by its `keystr` path; the port encodes a flat
`{keystr: array}` mapping (a `Params` dict of tensors, or numpy arrays),
read through `.detach().cpu().numpy()`.  This module imports no torch:
validators re-execute a sparse upload through `densify_entries` and
never load torch (`comm/bft.check_sparse_upload_op`).
`utils/serialization.py` re-exports every name here.

bfloat16 leaves (the reference's bfloat16 MLP, whose params, deltas and
uploads are bfloat16) encode as the reference encodes them: the dtype
string "bfloat16" and 2 bytes an element.  numpy has no bfloat16 of its
own: `BF16` is ml_dtypes' (the reference's) where it is installed, else
a 2-byte record named "bfloat16" over the same bits, so the port never
needs ml_dtypes; `is_bf16`, `as_float32` (exact widening) and
`cast_like` (round to nearest even) work on either.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

_MAGIC = b"BFLCT\x01"


def _bf16_dtype() -> np.dtype:
    try:
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    except ImportError:
        return np.dtype([("bfloat16", "<u2")])


BF16 = _bf16_dtype()


def is_bf16(dtype) -> bool:
    """Whether `dtype` is a numpy bfloat16 (ml_dtypes' or `BF16`)."""
    dtype = np.dtype(dtype)
    return dtype.name == "bfloat16" or dtype.names == ("bfloat16",)


def as_float32(a) -> np.ndarray:
    """`a` as float32; a bfloat16 array widens exactly, by its bits."""
    a = np.asarray(a)
    if is_bf16(a.dtype):
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << np.uint32(16)).view(np.float32)
    return np.asarray(a, np.float32)


def cast_like(a: np.ndarray, dtype) -> np.ndarray:
    """float32 `a` cast to `dtype`; to bfloat16 rounded to nearest even,
    every NaN to the canonical quiet NaN with its sign (0x7FC0 / 0xFFC0,
    its payload dropped), as numpy's ml_dtypes cast does."""
    if not is_bf16(dtype):
        return np.asarray(a).astype(dtype)
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    with np.errstate(over="ignore"):
        r = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    r = np.where(nan, (u & np.uint32(0x80000000)) | np.uint32(0x7FC00000),
                 r)
    return (r >> np.uint32(16)).astype(np.uint16).view(np.dtype(dtype))

# opt-in reduced-precision delta encodings (--delta-dtype)
DELTA_DTYPES = ("f32", "f16", "i8")

# reserved key suffix carrying an i8 leaf's dequantization scale; '#'
# never occurs in a keystr path, so an honest tree cannot collide
QSCALE_SUFFIX = "#qscale"

# reserved key suffix carrying a sparsified leaf's index/shape record:
# uint32 [ndim, *shape, *ascending idx]
TOPK_SUFFIX = "#topk"

# reserved key suffix carrying a count-sketch leaf's geometry record:
# uint32 [ndim, *shape, depth, width]; the paired values leaf is the
# (depth*width,) float32 sketch table
SKETCH_SUFFIX = "#sketch"

# the sparse codecs the genome may name (ProtocolConfig.delta_codec)
DELTA_CODECS = ("topk", "sketch")

# densify refuses a #sketch record claiming more hash rows than any
# honest encoder emits (encoders use min(3, slots))
_SKETCH_MAX_DEPTH = 4

# densify refuses a #topk record claiming more dimensions than any model
# here could honestly produce
_TOPK_MAX_NDIM = 8

# ... and records whose claimed dense sizes total past 64M elements
# (256 MB of f32) a blob: the allocations happen before any schema
# check, so untrusted records must never size them
_TOPK_MAX_ELEMS = 1 << 26


def sparse_legacy() -> bool:
    """BFLC_SPARSE_LEGACY=1 pins the dense protocol byte for byte:
    encoders never sparsify and decoders treat `#topk` entries as the
    schema garbage they then are."""
    return bool(os.environ.get("BFLC_SPARSE_LEGACY"))


def sparse_enabled(cfg) -> bool:
    """The one arming decision every sparse-aware layer asks: the genome
    opted in (delta_density < 1) and no legacy pin."""
    return float(getattr(cfg, "delta_density", 1.0)) < 1.0 \
        and not sparse_legacy()


def error_feedback_enabled(cfg) -> bool:
    """Client-side error feedback (--error-feedback /
    BFLC_ERROR_FEEDBACK=1): fold what the lossy encode dropped into the
    next delta.  Not part of the genome (the residual never crosses the
    wire), and only armed where the encode is lossy (sparsity or
    quantization)."""
    if os.environ.get("BFLC_ERROR_FEEDBACK", "") in ("", "0"):
        return False
    return sparse_enabled(cfg) or \
        str(getattr(cfg, "delta_dtype", "f32")) != "f32"


def delta_codec(cfg) -> str:
    """The genome's `delta_codec` when sparsity is armed, else 'topk'
    (at density 1.0 the dense identity); an unknown name degrades to
    'topk' (the decode side is self-describing)."""
    codec = str(getattr(cfg, "delta_codec", "topk") or "topk")
    return codec if codec in DELTA_CODECS else "topk"


def topk_count(size: int, density: float) -> int:
    """Deterministic per-leaf k: ceil(density * size), clamped to
    [0, size] (an f64 multiply and ceil, IEEE-pinned)."""
    if size <= 0 or density <= 0.0:
        return 0
    if density >= 1.0:
        return int(size)
    return int(min(size, int(np.ceil(np.float64(density)
                                     * np.float64(size)))))


def _as_numpy(leaf) -> np.ndarray:
    # a torch tensor (duck-typed: this module never imports torch) or an
    # array-like, in the reference's orientation
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu()
        if str(leaf.dtype) == "torch.bfloat16":
            import torch            # a torch tensor: torch is loaded
            return leaf.view(torch.int16).numpy().view(BF16)
        return leaf.numpy()
    return np.asarray(leaf)


def _leaf_entries(flat: Mapping[str, Any]) -> List[Tuple[str, np.ndarray]]:
    # sorted by key, as the reference sorts its keystr paths, so insertion
    # order can never leak into the hash
    return sorted(((k, _as_numpy(v)) for k, v in flat.items()),
                  key=lambda kv: kv[0])


def _encode_entries(entries: List[Tuple[str, np.ndarray]]) -> bytes:
    """The one canonical entry encoder:

    magic | count | for each leaf in sorted key order:
        key | dtype string ('<f4') | ndim | shape | raw little-endian bytes
    """
    out = [_MAGIC, struct.pack("<q", len(entries))]
    for key, arr in entries:
        kb = key.encode()
        # '<f4' style codes carry endianness; extension dtypes stringify as
        # opaque '<V2', so the reference writes their registered name
        ds = arr.dtype.str
        db = ("bfloat16" if is_bf16(arr.dtype) else arr.dtype.name
              if ds.endswith(f"V{arr.dtype.itemsize}") else ds).encode()
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


def canonical_bytes(flat: Mapping[str, Any]) -> bytes:
    return _encode_entries(_leaf_entries(flat))


def hash_pytree(flat: Mapping[str, Any]) -> bytes:
    """32-byte content hash — the ledger's view of a tensor payload."""
    return hashlib.sha256(canonical_bytes(flat)).digest()


def pack_pytree(flat: Mapping[str, Any]) -> bytes:
    """The self-describing blob of a flat `{keystr: tensor}` mapping."""
    return canonical_bytes(flat)


def pack_entries(entries: Mapping[str, Any]) -> bytes:
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
        name = data[off:off + dlen].decode()
        dtype = BF16 if name == "bfloat16" else np.dtype(name)
        off += dlen
        (ndim,) = take("<q")
        shape = take(f"<{ndim}q") if ndim else ()
        (rawlen,) = take("<q")
        out[key] = np.frombuffer(data[off:off + rawlen],
                                 dtype=dtype).reshape(shape)
        off += rawlen
    return out


# ----------------------------------------------------- quantized encodings
def quantize_entries(flat: Dict[str, np.ndarray],
                     dtype: str) -> Dict[str, np.ndarray]:
    """Reduced-precision image of flat entries: f32 is the identity; f16
    casts float leaves to IEEE float16; i8 stores each float leaf as
    symmetric int8 with one per-leaf float32 scale (max|x|/127, or 1.0
    for an all-zero leaf) under `<key>#qscale`.  Non-float leaves pass
    through.  np.rint (ties to even) and float32 divides are IEEE-pinned,
    so the bytes are the same on every host."""
    if dtype not in DELTA_DTYPES:
        raise ValueError(f"delta dtype must be one of {DELTA_DTYPES}, "
                         f"got {dtype!r}")
    if dtype == "f32":
        return dict(flat)
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        if not np.issubdtype(a.dtype, np.floating):
            out[key] = a
            continue
        if dtype == "f16":
            out[key] = a.astype(np.float16)
            continue
        a32 = a.astype(np.float32)
        amax = np.float32(np.max(np.abs(a32))) if a32.size else np.float32(0)
        scale = np.float32(amax / np.float32(127.0)) if amax else \
            np.float32(1.0)
        q = np.clip(np.rint(a32 / scale), -127, 127).astype(np.int8)
        out[key] = q
        out[key + QSCALE_SUFFIX] = np.float32(scale)
    return out


def dequantize_entries(flat: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """The one inverse of `quantize_entries`: f32 entries pass through,
    float16 leaves decode to float32, an int8 leaf with a `#qscale` entry
    decodes as `int8.astype(f32) * scale`; an int8 leaf without one is an
    honest integer tensor and stays."""
    scales = {k: v for k, v in flat.items() if k.endswith(QSCALE_SUFFIX)}
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        if key.endswith(QSCALE_SUFFIX):
            continue
        a = np.asarray(arr)
        skey = key + QSCALE_SUFFIX
        if a.dtype == np.int8 and skey in scales:
            scale = np.float32(np.asarray(scales[skey]).reshape(()))
            out[key] = a.astype(np.float32) * scale
        elif a.dtype == np.float16:
            out[key] = a.astype(np.float32)
        else:
            out[key] = a
    return out


def pack_quantized(flat: Mapping[str, Any], dtype: str) -> bytes:
    """Canonical bytes of the quantized entries: what an opt-in client
    uploads, hashes and signs."""
    entries = dict(_leaf_entries(flat))
    return pack_entries(quantize_entries(entries, dtype))


# ------------------------------------------------------ sparse encodings
def sparsify_entries(flat: Dict[str, np.ndarray],
                     density: float) -> Dict[str, np.ndarray]:
    """Deterministic per-leaf top-k image: each float leaf keeps its
    k = `topk_count(size, density)` entries of largest |value|, ties by
    ascending flat index, as a (k,) float32 vector in ascending-index
    order plus a `<key>#topk` uint32 record ``[ndim, *shape, *indices]``.
    A leaf whose k reaches its size stays dense, so density >= 1 is the
    identity.  Non-float leaves pass through.  Apply before
    `quantize_entries`."""
    if density >= 1.0:
        return dict(flat)
    if density < 0.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        if not np.issubdtype(a.dtype, np.floating):
            out[key] = a
            continue
        size = int(a.size)
        k = topk_count(size, density)
        if k >= size:
            out[key] = a
            continue
        vals = a.astype(np.float32, copy=False).ravel()
        # stable argsort on -|v|: equal magnitudes keep ascending flat
        # index, the documented deterministic tie-break
        order = np.argsort(-np.abs(vals), kind="stable")
        idx = np.sort(order[:k]).astype(np.uint32)
        out[key] = vals[idx].astype(np.float32)
        out[key + TOPK_SUFFIX] = np.concatenate([
            np.asarray([a.ndim] + list(a.shape), np.uint32), idx])
    return out


def _sketch_hashes(key: str, row: int, size: int,
                   width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bucket, sign) over a leaf's flat indices for one hash row: a
    multiply-shift family seeded by sha256 of (key, row) alone, so the
    sketch is self-describing; pure uint64 modular arithmetic."""
    seed = hashlib.sha256(
        b"bflc-sketch|" + key.encode() + b"|" + struct.pack("<q", row)
    ).digest()
    a = np.uint64(int.from_bytes(seed[:8], "little") | 1)
    c = np.uint64(int.from_bytes(seed[8:16], "little"))
    j = np.arange(size, dtype=np.uint64)
    with np.errstate(over="ignore"):
        mixed = a * j + c
    bucket = ((mixed >> np.uint64(32)) % np.uint64(width)).astype(np.int64)
    sign = (1.0 - 2.0 * ((mixed >> np.uint64(31)) & np.uint64(1)).astype(
        np.float64))
    return bucket, sign


def sketch_geometry(size: int, density: float) -> Tuple[int, int]:
    """(depth, width) for a leaf at this density, or (0, 0): pass through
    dense (the slot budget `topk_count(size, density)` covers the leaf).
    Depth is min(3, budget)."""
    slots = topk_count(size, density)
    if slots <= 0 or slots >= size:
        return 0, 0
    depth = min(3, slots)
    width = (slots + depth - 1) // depth
    return depth, width


def sketch_entries(flat: Dict[str, np.ndarray],
                   density: float) -> Dict[str, np.ndarray]:
    """Deterministic count-sketch image: each float leaf folds into a
    (depth*width,) float32 table (f64 accumulation, one f32 round) plus
    a `<key>#sketch` uint32 record ``[ndim, *shape, depth, width]``.
    Leaves whose budget reaches their size stay dense; density >= 1 is
    the identity."""
    if density >= 1.0:
        return dict(flat)
    if density < 0.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        if not np.issubdtype(a.dtype, np.floating):
            out[key] = a
            continue
        size = int(a.size)
        depth, width = sketch_geometry(size, density)
        if depth <= 0:
            out[key] = a
            continue
        vals = a.astype(np.float32, copy=False).ravel().astype(np.float64)
        table = np.zeros((depth, width), np.float64)
        for r in range(depth):
            bucket, sign = _sketch_hashes(key, r, size, width)
            table[r] = np.bincount(bucket, weights=sign * vals,
                                   minlength=width)
        out[key] = table.astype(np.float32).ravel()
        out[key + SKETCH_SUFFIX] = np.asarray(
            [a.ndim] + list(a.shape) + [depth, width], np.uint32)
    return out


def _densify_sketch(tkey: str, rec: np.ndarray,
                    vals: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """One validated #sketch record and table -> the dense
    median-of-rows estimate (float32)."""
    ndim = int(rec[0])
    shape = tuple(int(d) for d in rec[1:1 + ndim])
    depth, width = int(rec[1 + ndim]), int(rec[2 + ndim])
    size = 1
    for d in shape:
        size *= d
    table = vals.astype(np.float32, copy=False).reshape(depth, width)
    est = np.empty((depth, size), np.float32)
    for r in range(depth):
        bucket, sign = _sketch_hashes(tkey[:-len(SKETCH_SUFFIX)], r,
                                      size, width)
        est[r] = sign.astype(np.float32) * table[r, bucket]
    return np.median(est, axis=0).astype(np.float32).reshape(shape), shape


def densify_entries(flat: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """The one inverse of `sparsify_entries` and `sketch_entries`, shared
    by admission, the scorers, the merge and validator re-execution: the
    identity on dense entries; a `#topk` record scatters its values into
    float32 zeros of the recorded shape, a `#sketch` record decodes to
    the median-of-rows estimate.  Any malformed record raises ValueError
    (wrong dtype, impossible ndim, a count mismatch, out-of-bounds,
    duplicate or unsorted indices, impossible geometry, a leaf claimed
    by both record types, an orphan record).  Run after
    `dequantize_entries`."""
    topks = {k: v for k, v in flat.items() if k.endswith(TOPK_SUFFIX)}
    sketches = {k: v for k, v in flat.items()
                if k.endswith(SKETCH_SUFFIX)}
    if not topks and not sketches:
        return dict(flat)
    out: Dict[str, np.ndarray] = {}
    seen = set()
    claimed_total = 0
    for skey, rec in sketches.items():
        base = skey[:-len(SKETCH_SUFFIX)]
        if base + TOPK_SUFFIX in topks:
            raise ValueError(f"{base}: claimed by both #topk and "
                             f"#sketch records")
        seen.add(base)
        rec = np.asarray(rec)
        if rec.dtype != np.uint32 or rec.ndim != 1 or rec.size < 3:
            raise ValueError(f"{skey}: malformed record (want a 1-D "
                             f"uint32 vector [ndim, *shape, depth, "
                             f"width])")
        ndim = int(rec[0])
        if ndim > _TOPK_MAX_NDIM or rec.size != 3 + ndim:
            raise ValueError(f"{skey}: impossible ndim {ndim}")
        shape = tuple(int(d) for d in rec[1:1 + ndim])
        size = 1
        for d in shape:
            size *= d
        depth, width = int(rec[1 + ndim]), int(rec[2 + ndim])
        if not 1 <= depth <= _SKETCH_MAX_DEPTH or width < 1:
            raise ValueError(f"{skey}: impossible sketch geometry "
                             f"depth={depth} width={width}")
        # the decode's working set, (depth+1) x size floats plus the
        # table, bounded cumulatively before any allocation
        claimed_total += size * (depth + 1) + depth * width
        if claimed_total > _TOPK_MAX_ELEMS:
            raise ValueError(f"{skey}: claimed decode sizes total "
                             f"{claimed_total}, exceeding "
                             f"{_TOPK_MAX_ELEMS} elements")
        if base not in flat:
            raise ValueError(f"{skey}: record without its table leaf")
        vals = np.asarray(flat[base])
        if not np.issubdtype(vals.dtype, np.floating) or vals.ndim != 1:
            raise ValueError(f"{base}: sketch table must be a 1-D "
                             f"float vector, got {vals.dtype} "
                             f"rank {vals.ndim}")
        if int(vals.size) != depth * width:
            raise ValueError(f"{skey}: table size {vals.size} != "
                             f"depth*width {depth * width}")
        if size < 1:
            raise ValueError(f"{skey}: empty dense shape {shape}")
        out[base], _ = _densify_sketch(skey, rec, vals)
    for tkey, rec in topks.items():
        base = tkey[:-len(TOPK_SUFFIX)]
        seen.add(base)
        rec = np.asarray(rec)
        if rec.dtype != np.uint32 or rec.ndim != 1 or rec.size < 1:
            raise ValueError(f"{tkey}: malformed record (want a 1-D "
                             f"uint32 vector)")
        ndim = int(rec[0])
        if ndim > _TOPK_MAX_NDIM or rec.size < 1 + ndim:
            raise ValueError(f"{tkey}: impossible ndim {ndim}")
        shape = tuple(int(d) for d in rec[1:1 + ndim])
        size = 1
        for d in shape:
            size *= d
        claimed_total += size
        if claimed_total > _TOPK_MAX_ELEMS:
            # refused before the np.zeros below, and cumulatively: many
            # tiny records each claiming a large shape must not add up
            raise ValueError(f"{tkey}: claimed dense sizes total "
                             f"{claimed_total}, exceeding "
                             f"{_TOPK_MAX_ELEMS} elements")
        idx = rec[1 + ndim:].astype(np.int64)
        if base not in flat:
            raise ValueError(f"{tkey}: record without its values leaf")
        vals = np.asarray(flat[base])
        if not np.issubdtype(vals.dtype, np.floating) or vals.ndim != 1:
            raise ValueError(f"{base}: sparse values must be a 1-D "
                             f"float vector, got {vals.dtype} "
                             f"rank {vals.ndim}")
        if len(idx) != vals.size:
            raise ValueError(f"{tkey}: {len(idx)} indices for "
                             f"{vals.size} values")
        if len(idx) > size or (len(idx) and
                               (int(idx[-1]) >= size or int(idx[0]) < 0)):
            raise ValueError(f"{tkey}: index out of bounds for a "
                             f"{size}-element leaf")
        if len(idx) > 1 and not np.all(np.diff(idx) > 0):
            raise ValueError(f"{tkey}: indices must be strictly "
                             f"ascending (no duplicates)")
        dense = np.zeros(size, np.float32)
        dense[idx] = vals.astype(np.float32, copy=False)
        out[base] = dense.reshape(shape)
    for key, arr in flat.items():
        if key.endswith(TOPK_SUFFIX) or key.endswith(SKETCH_SUFFIX) \
                or key in seen:
            continue
        out[key] = np.asarray(arr)
    return out


def pack_sparse(flat: Mapping[str, Any], density: float,
                dtype: str = "f32", codec: str = "topk") -> bytes:
    """Canonical bytes of the sparsified (then quantized) entries: what a
    density-armed client uploads, hashes and signs.  `codec` picks
    'topk' records or 'sketch' tables; both decode through
    `densify_entries`.  At density >= 1 and dtype 'f32' this is
    `pack_pytree`'s bytes."""
    if codec not in DELTA_CODECS:
        raise ValueError(f"delta codec must be one of {DELTA_CODECS}, "
                         f"got {codec!r}")
    encode = sketch_entries if codec == "sketch" else sparsify_entries
    entries = encode(dict(_leaf_entries(flat)), density)
    return pack_entries(quantize_entries(entries, dtype))
