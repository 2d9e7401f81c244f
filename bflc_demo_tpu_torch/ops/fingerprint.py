"""Payload fingerprints: the 32-byte ids the mesh round puts on the ledger.

Port of `bflc_demo_tpu/ops/fingerprint.py` — `_to_words` (:37-59),
`fingerprint_pytree` (:62-93), `fingerprint_stacked` (:96-99) and
`fingerprint_to_bytes` (:102-107) — bit for bit: an 8-lane uint32 FNV
multiply-xor chain over the bitcast words of every leaf, salted with the
leaf's index, row count, dtype and shape, then two mixing rounds.  NOT
cryptographic; the ledger's SHA-256 chain over the recorded ids is what
makes them tamper-evident.

Each wrapper runs the hand-written CUDA kernel (`csrc/fingerprint.cu`,
one block per candidate, every leaf in one launch) on CUDA tensors and
`fingerprint_plain` on CPU tensors; a CUDA tensor the kernel cannot take
raises.  `LAUNCHES["fingerprint"]` counts kernel launches.

Where bit-exactness breaks, and what this module does about it:
- leaf order is `jax.tree_util.tree_leaves` order — dict keys sorted at
  every level, sequence indices numerically — parsed from the keystr
  keys (`leaf_order`), not a sort of whole keystr strings (where
  "[10]" would sort before "[2]");
- the dtype salt hashes JAX's dtype *name* (`JAX_DTYPE_NAMES`);
- the shape salt takes each slice's own shape, without the stacked axis;
- sub-32-bit elements widen after a bitcast (int8 -1 -> 255, bool through
  uint8); 64-bit elements give two words, low word first;
- every leaf is zero-padded to a multiple of 8 words, and the padding
  rows are part of the chain.

Fingerprints are (K, 8) (or (8,)) int64 tensors holding the uint32 words:
torch's uint32 supports few operations, and the plain chain runs in int64
with `& 0xFFFFFFFF` after every multiply (the low 32 bits of a product are
exact; P < 2**25 keeps h * P below 2**57, so nothing wraps).
"""

from __future__ import annotations

import ctypes
import hashlib
import re
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.device import upload

LANES = 8                      # 8 x uint32 = 32 bytes, the ledger digest
FNV_PRIME = 16777619
FNV_OFFSET = 2166136261
GOLDEN = 0x9E3779B9
MASK = 0xFFFFFFFF

# JAX's dtype names, which the dtype salt hashes
JAX_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint16: "uint16", torch.uint32: "uint32",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
}

# kernel launches since the last reset (plain runs excluded)
LAUNCHES = {"fingerprint": 0}

# mirrors csrc/fingerprint.cu:LeafDesc
_LEAF_DTYPE = np.dtype({
    "names": ["base", "stride", "n_words", "esize", "salt_off", "n_mx",
              "unused"],
    "formats": ["<u8", "<i8", "<i8", "<i4", "<i4", "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 28, 32, 36], "itemsize": 40})

_KEY_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def reset_launches() -> None:
    LAUNCHES["fingerprint"] = 0


def _path(key: str) -> Tuple[Tuple[int, object], ...]:
    """keystr "['blocks'][10]['wq']" -> ((1, 'blocks'), (0, 10), (1, 'wq'))
    — sequence indices compare as numbers, dict keys as strings."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        pos = m.end()
        parts.append((1, m.group(1)) if m.group(2) is None
                     else (0, int(m.group(2))))
    if pos != len(key) or not parts:
        raise ValueError(f"not a keystr path: {key!r}")
    return tuple(parts)


def leaf_order(keys: Sequence[str]) -> List[str]:
    """The keys in `jax.tree_util.tree_leaves` order of the tree they
    flatten."""
    return sorted(keys, key=_path)


def _leaf_words(leaf: torch.Tensor, batch: int) -> int:
    """uint32 words per slice of `leaf` (leading axis of `batch`)."""
    per = leaf.numel() // batch if batch else 0
    if leaf.element_size() == 8:
        return 2 * per
    if leaf.element_size() in (1, 2, 4):
        return per
    raise TypeError(f"unsupported dtype for fingerprint: {leaf.dtype}")


def _salts(index: int, shape: Sequence[int], dtype: torch.dtype,
           n_words: int) -> List[int]:
    """[xor salt, dtype salt, one salt per dim] of leaf `index`."""
    if dtype not in JAX_DTYPE_NAMES:
        raise TypeError(f"unsupported dtype for fingerprint: {dtype}")
    rows = -(-n_words // LANES)
    salts = [(((index + 1) * GOLDEN) & MASK) ^ rows,
             int.from_bytes(hashlib.sha256(
                 JAX_DTYPE_NAMES[dtype].encode()).digest()[:4], "little")]
    salts += [((s + 1) * GOLDEN + d) & MASK for d, s in enumerate(shape)]
    return salts


def _leaves(tree: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    leaves = [tree[k] for k in leaf_order(list(tree))]
    if not leaves:
        raise ValueError("fingerprint of an empty tree")
    if len({t.device for t in leaves}) != 1:
        raise ValueError("fingerprint leaves lie on different devices")
    if leaves[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {leaves[0].device}")
    return leaves


def _words(leaf: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch, n_words) int64 words of each slice, as `_to_words` makes
    them."""
    x = leaf.detach().contiguous().reshape(batch, -1)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    size = x.element_size()
    if size == 1:
        return x.view(torch.uint8).to(torch.int64)
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    return x.view(torch.int32).to(torch.int64) & MASK   # 4 or 8 bytes


def _chain(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h <- (h * FNV_PRIME mod 2**32) ^ w[r] for every row r of w (rows,
    K, 8), in order.  On the CPU the loop runs in numpy's uint32, which
    wraps: two ufuncs a row instead of three torch ops."""
    if h.device.type != "cpu":
        for r in range(w.shape[0]):
            h.mul_(FNV_PRIME).bitwise_and_(MASK).bitwise_xor_(w[r])
        return h
    hn = h.numpy().astype(np.uint32)
    wn = w.numpy().astype(np.uint32)
    prime = np.uint32(FNV_PRIME)
    for row in wn:
        np.multiply(hn, prime, out=hn)
        np.bitwise_xor(hn, row, out=hn)
    return torch.from_numpy(hn.astype(np.int64))


def fingerprint_plain(stacked: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(K, 8) fingerprints of a tree whose leaves carry a leading axis K —
    the reference's arithmetic, one row of every lane at a time."""
    leaves = _leaves(stacked)
    batch = leaves[0].shape[0]
    h = torch.full((batch, LANES), FNV_OFFSET, dtype=torch.int64,
                   device=leaves[0].device)
    for i, leaf in enumerate(leaves):
        n_words = _leaf_words(leaf, batch)
        salts = _salts(i, leaf.shape[1:], leaf.dtype, n_words)
        h ^= salts[0]
        for s in salts[1:]:
            h = ((h * FNV_PRIME) & MASK) ^ s
        rows = -(-n_words // LANES)
        w = torch.zeros((batch, rows * LANES), dtype=torch.int64,
                        device=h.device)
        w[:, :n_words] = _words(leaf, batch)
        h = _chain(h, w.reshape(batch, rows, LANES).transpose(0, 1)
                   .contiguous())
    for _ in range(2):
        h = ((h * FNV_PRIME) & MASK) ^ torch.roll(h, 1, dims=1)
    return h


# ------------------------------------------------------------------ kernel
_P = ctypes.c_void_p
_ARGTYPES = {
    "bflc_fingerprint": [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P],
    "bflc_fnv_chain": [ctypes.c_uint, ctypes.c_longlong, _P, _P, _P],
    "bflc_fingerprint_leaf_desc_size": [],
}


def _entry(name: str):
    from bflc_demo_tpu_torch.ops.build import load
    fn = getattr(load("fingerprint"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream



class KernelPlan:
    """The kernel's leaf table for one tree of CUDA tensors, on the card.

    Building it copies the table to the device; `launch` then runs the
    kernel over the same tensors as often as asked (the timing loop
    captures `launch` alone in a CUDA graph)."""

    def __init__(self, stacked: Mapping[str, torch.Tensor]):
        size = _entry("bflc_fingerprint_leaf_desc_size")()
        if size != _LEAF_DTYPE.itemsize:
            raise RuntimeError("the kernel's leaf table layout differs from "
                               "_LEAF_DTYPE")
        leaves = _leaves(stacked)
        dev = leaves[0].device
        self.batch = leaves[0].shape[0]
        # contiguous copies where needed; kept alive for the launches
        self.leaves = [t.detach().contiguous() for t in leaves]
        table = np.zeros(len(self.leaves), _LEAF_DTYPE)
        salts: List[int] = []
        for i, leaf in enumerate(self.leaves):
            n_words = _leaf_words(leaf, self.batch)
            s = _salts(i, leaf.shape[1:], leaf.dtype, n_words)
            wide = leaf.element_size() == 8        # two 4-byte words each
            table[i] = (leaf.data_ptr(),
                        (leaf.numel() // max(self.batch, 1))
                        * leaf.element_size(),
                        n_words, 4 if wide else leaf.element_size(),
                        len(salts), len(s) - 1, 0)
            salts += s
        self.table = upload(table.view(np.uint8).copy(), dev)
        self.salts = upload(np.asarray(salts, np.uint32).view(np.int32),
                            dev)
        self.device = dev

    def launch(self) -> torch.Tensor:
        out = torch.empty((self.batch, LANES), dtype=torch.int64,
                          device=self.device)
        err = _entry("bflc_fingerprint")(
            self.table.data_ptr(), len(self.leaves), self.salts.data_ptr(),
            self.batch, out.data_ptr(), _stream(out))
        if err != 0:
            raise RuntimeError(f"bflc_fingerprint: CUDA error {err} at "
                               f"launch")
        LAUNCHES["fingerprint"] += 1
        return out


def chain_steps(stacked: Mapping[str, torch.Tensor]) -> int:
    """Dependent multiply-xor steps in each lane's chain for one slice of
    `stacked`: every word row, each leaf's dtype and dim salts, and the
    two mixing rounds — the kernel's critical path."""
    leaves = _leaves(stacked)
    batch = leaves[0].shape[0]
    return 2 + sum(-(-_leaf_words(t, batch) // LANES) + t.ndim
                   for t in leaves)


def fnv_chain_latency(steps: int, device) -> Tuple[float, float]:
    """(ms, clock cycles) per step of one thread's dependent multiply-xor
    chain on the card — the floor under every lane of the kernel."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    fn = _entry("bflc_fnv_chain")
    for _ in range(2):                 # the first launch loads the module
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(12345, steps, out.data_ptr(), cycles.data_ptr(),
              _stream(out)) != 0:
            raise RuntimeError("bflc_fnv_chain: CUDA error at launch")
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / steps, float(cycles.item()) / steps


# --------------------------------------------------------------- wrappers
def fingerprint_stacked(stacked: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(K, 8) fingerprints of a tree with a stacked leading axis K, one
    per slice — a round's per-candidate payload ids."""
    if not _leaves(stacked)[0].is_cuda:
        return fingerprint_plain(stacked)
    return KernelPlan(stacked).launch()


def fingerprint_pytree(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(8,) fingerprint of one tree."""
    return fingerprint_stacked({k: v[None] for k, v in tree.items()})[0]


def fingerprint_to_bytes(fp) -> bytes:
    """uint32[8] -> canonical little-endian 32 bytes (the ledger digest)."""
    if isinstance(fp, torch.Tensor):
        fp = fp.detach().cpu().numpy()
    arr = np.asarray(fp)
    if arr.shape != (LANES,):
        raise ValueError(f"expected ({LANES},) uint32, got {arr.shape}")
    if arr.dtype != np.uint32:
        if arr.min() < 0 or arr.max() > MASK:
            raise ValueError("fingerprint words must lie in [0, 2**32)")
        arr = arr.astype(np.uint32)
    return arr.astype("<u4").tobytes()
