"""Secure aggregation's masked fixed-point encode: kernel B7.

Port of the per-leaf encode and mask of
`bflc_demo_tpu/parallel/secure.py:secure_fedavg_body` (:235-307) with
`_client_mask` (:55-81) and `_client_mask_dh` (:84-121), an XLA program
in the reference (no `pallas_call`), bit for bit.  For a leaf of S
slot-stacked deltas (S, P), the slots' normalised weights `wn` (S,), the
pairs' keys (uint32 words, the leaf index already folded in, packed as
the upper triangle (i, j), i < j in row order:
`parallel/secure.py:leaf_pair_keys`) and the clip, each slot's masked
word is

    q_i + sum_{j>i} m_ij - sum_{j<i} m_ij   (mod 2**32)

with q_i = int32(round(clip(clip(nan_to_num(d_i)) * wn_i) * 2**16)) and
m_ij = x0 ^ x1 of Threefry-2x32 under key_ij over the leaf's flat iota
(hi word, lo word) — `jax.random.bits`' partitionable draw, which
`utils/prng.bits` reproduces.  Summed over the slots the masks cancel,
so the sum is the sum of the q_i.

`masked_encode_leaves` runs the hand-written CUDA kernel
(`csrc/secure_mask.cu`) once over every leaf of a round on CUDA tensors
(a `RoundPlan`: a device table of the leaves, one block a tile of one
leaf, each pair's mask drawn once) into one (S, total) output, and
`masked_encode_leaves_plain` (`masked_encode_plain` leaf by leaf) on CPU
tensors; `masked_encode` is the one-leaf form.  A CUDA tensor the kernel
cannot take raises.  `LAUNCHES["secure_mask"]` counts kernel launches.

Masked words are int32 tensors holding the uint32 bits (torch's uint32
supports few operations); the plain version draws the masks in int64
with ``& 0xFFFFFFFF`` after every add and shift on the card, in numpy's
uint32 on the CPU, exact either way.  Where bit-exactness is at risk,
and what both versions do:
- `jnp.round` rounds half to even: `torch.round` does, the kernel uses
  `__float2int_rn` (never `roundf`);
- NaN becomes 0 and +-inf +-clip before the clip (a clip carries NaN);
- the weighted value is clipped again after the product, as the
  reference does (a no-op in value; the capacity bound rests on it);
- the kernel's counter is 32-bit (the high word is 0 below 2**32
  elements a leaf; a larger leaf raises);
- `offset` shifts the plain version's counters, so that a window of a
  leaf can be held against the kernel's words without drawing the whole
  leaf.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from bflc_demo_tpu_torch.device import upload
from bflc_demo_tpu_torch.utils import prng

MASK = 0xFFFFFFFF
FRAC_BITS = 16
SCALE = float(1 << FRAC_BITS)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the plain version draws at most this many mask words at once
_PLAIN_CHUNK = 1 << 26
# the kernel's block
THREADS = 128
# the most slots the kernel takes (its shared memory: 65 KB a block at 40)
MAX_SLOTS = 40
# the most elements a leaf (the counter's high word is 0)
MAX_LEAF = (1 << 32) - 1
# shared memory a block may use on an H100 (227 KB); blocks a launch
_MAX_SMEM = 232448
_MAX_GRID = (1 << 31) - 1

# kernel launches since the last reset (plain runs excluded)
LAUNCHES = {"secure_mask": 0}


def reset_launches() -> None:
    LAUNCHES["secure_mask"] = 0


def encode_plain(deltas: torch.Tensor, wn: torch.Tensor,
                 clip: float) -> torch.Tensor:
    """(S, W) int64 fixed-point words in [0, 2**32) of (S, W) deltas."""
    x = torch.nan_to_num(deltas.to(torch.float32), nan=0.0, posinf=clip,
                         neginf=-clip).clamp(-clip, clip)
    x = (x * wn.to(torch.float32)[:, None]).clamp(-clip, clip)
    q = torch.round(x * SCALE).to(torch.int32)
    return q.to(torch.int64) & MASK


def threefry_bits_plain(k0: torch.Tensor, k1: torch.Tensor,
                        counters: torch.Tensor) -> torch.Tensor:
    """(M, W) int64 words x0 ^ x1 of Threefry-2x32 under the M keys (k0,
    k1) (each (M, 1) int64) over the counters (W,) int64 (hi and lo
    words of each)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = ((counters >> 32) + ks[0]) & MASK
    x1 = ((counters & MASK) + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r) & MASK).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0.bitwise_xor_(x1)


def masked_encode_plain(deltas: torch.Tensor, wn: torch.Tensor,
                        keys: torch.Tensor, clip: float,
                        offset: int = 0) -> torch.Tensor:
    """(S, W) int32 masked words of the (S, W) deltas whose first element
    is element `offset` of the leaf, under the leaf's packed (S(S-1)/2, 2)
    pair keys — the reference's arithmetic, each pair's mask drawn once
    for all W elements.  On the CPU the masks are
    `utils/prng`'s numpy uint32 Threefry (wrapping natively: half the
    bytes and no masking a step); elsewhere torch's int64."""
    slots, width = deltas.shape
    dev = deltas.device
    acc = encode_plain(deltas, wn, clip)
    lo, hi = torch.triu_indices(slots, slots, offset=1, device=dev)
    kk = keys.to(dev, torch.int64) & MASK
    k0, k1 = kk[:, 0:1], kk[:, 1:2]
    counters = torch.arange(offset, offset + width, dtype=torch.int64,
                            device=dev)
    step = max(1, _PLAIN_CHUNK // max(width, 1))
    for p in range(0, lo.numel(), step):
        if dev.type == "cpu":
            key = torch.cat([k0[p:p + step], k1[p:p + step]], 1)
            c = counters.numpy()
            x0, x1 = prng.threefry2x32(
                key.numpy().astype(np.uint32)[:, None],
                (c >> 32).astype(np.uint32), (c & MASK).astype(np.uint32))
            m = torch.from_numpy(np.bitwise_xor(x0, x1).astype(np.int64))
        else:
            m = threefry_bits_plain(k0[p:p + step], k1[p:p + step],
                                    counters)
        acc.index_add_(0, lo[p:p + step], m)
        acc.index_add_(0, hi[p:p + step], -m)
    acc.bitwise_and_(MASK)
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def masked_encode_leaves_plain(leaves: Sequence[torch.Tensor],
                               wn: torch.Tensor, keys: torch.Tensor,
                               clip: float):
    """`masked_encode_leaves` leaf by leaf with `masked_encode_plain`:
    the (S, total) int32 words and each leaf's (S, n) view of them."""
    words = torch.cat([masked_encode_plain(d, wn, k, clip)
                       for d, k in zip(leaves, keys)], 1)
    return words, _views(words, leaves)


# ------------------------------------------------------------------ kernel
_P = ctypes.c_void_p
_ARGTYPES = {
    "bflc_secure_mask": [_P, ctypes.c_int, ctypes.c_int, _P, _P,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                         _P, _P],
    "bflc_secure_mask_smem": [ctypes.c_int],
    "bflc_secure_mask_tile": [],
    "bflc_secure_mask_leaf_desc_size": [],
}
_RESTYPES = {"bflc_secure_mask_smem": ctypes.c_longlong}

# mirrors csrc/secure_mask.cu:LeafDesc
_LEAF_DTYPE = np.dtype({
    "names": ["deltas", "out_off", "n", "first_block", "key_off", "unused"],
    "formats": ["<u8", "<i8", "<u4", "<i4", "<i4", "<i4"],
    "offsets": [0, 8, 16, 20, 24, 28], "itemsize": 32})


def _entry(name: str):
    from bflc_demo_tpu_torch.ops.build import load
    fn = getattr(load("secure_mask"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return fn


def elements_a_thread() -> int:
    """Elements each of the kernel's 128 threads carries (its tile over
    its block)."""
    return _entry("bflc_secure_mask_tile")() // THREADS


def leaf_table(sizes: Sequence[int], slots: int, tile: int,
               pointers: Optional[Sequence[int]] = None):
    """The kernel's leaf table for leaves of `sizes` elements a slot, at
    `tile` elements a block: (the `_LEAF_DTYPE` rows, the blocks).  Leaf
    l's blocks follow leaf l-1's, ceil(n_l / tile) of them, so no block
    straddles two leaves and each leaf's counters start at 0 in its
    first block; its words start at column sum(sizes[:l]) of the (S,
    total) output and its pairs at row l * S(S-1)/2 of the packed keys.
    The counter is 32-bit: a leaf of 2**32 elements or more raises."""
    pairs = slots * (slots - 1) // 2
    table = np.zeros(len(sizes), _LEAF_DTYPE)
    block = column = 0
    for leaf, n in enumerate(sizes):
        if n > MAX_LEAF:
            raise ValueError(f"secure_mask: leaf {leaf} has {n} elements; "
                             f"the kernel's counter takes fewer than 2**32")
        table[leaf] = (0 if pointers is None else pointers[leaf], column,
                       n, block, leaf * pairs, 0)
        block += -(-n // tile)
        column += n
    if block > _MAX_GRID:
        raise ValueError(f"secure_mask: {block} blocks, over {_MAX_GRID}")
    return table, block


def _views(words: torch.Tensor, leaves: Sequence[torch.Tensor]) -> list:
    return list(torch.split(words, [d.shape[1] for d in leaves], 1))


class RoundPlan:
    """The kernel's leaf table for one round of CUDA tensors, on the card:
    leaves (S, n_l) float32, wn (S,) float32, keys (L, S(S-1)/2, 2) int32
    holding the uint32 words.  Building it copies the table to the card;
    `launch` then runs the kernel over the same tensors as often as asked
    (the timing loop captures `launch` alone in a CUDA graph)."""

    def __init__(self, leaves: Sequence[torch.Tensor], wn: torch.Tensor,
                 keys: torch.Tensor, clip: float):
        if _entry("bflc_secure_mask_leaf_desc_size")() \
                != _LEAF_DTYPE.itemsize:
            raise RuntimeError("the kernel's leaf table layout differs from "
                               "_LEAF_DTYPE")
        self.slots = leaves[0].shape[0]
        smem = _entry("bflc_secure_mask_smem")(self.slots)
        if smem > _MAX_SMEM:
            raise ValueError(f"secure_mask: {self.slots} slots need {smem} "
                             f"bytes of shared memory a block, over "
                             f"{_MAX_SMEM}")
        self.device = leaves[0].device
        # contiguous float32 copies where needed; kept alive for launches
        self.leaves = [d.to(torch.float32).contiguous() for d in leaves]
        self.wn = wn.to(torch.float32).contiguous()
        self.keys = keys.contiguous()
        self.clip = float(clip)
        self.total = sum(d.shape[1] for d in self.leaves)
        table, self.blocks = leaf_table(
            [d.shape[1] for d in self.leaves], self.slots,
            _entry("bflc_secure_mask_tile")(),
            [d.data_ptr() for d in self.leaves])
        self.table = upload(table.view(np.uint8).copy(), self.device)

    def args(self, out: torch.Tensor) -> tuple:
        """The C entry's arguments for a launch into `out` (S, total)."""
        return (self.table.data_ptr(), len(self.leaves), self.blocks,
                self.keys.data_ptr(), self.wn.data_ptr(), self.slots,
                self.total, self.clip, out.data_ptr(),
                torch.cuda.current_stream(self.device).cuda_stream)

    def launch(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One launch into `out` (S, total) int32 (made when None)."""
        if out is None:
            out = torch.empty((self.slots, self.total), dtype=torch.int32,
                              device=self.device)
        if self.blocks and self.slots:
            err = _entry("bflc_secure_mask")(*self.args(out))
            if err != 0:
                raise RuntimeError(f"bflc_secure_mask: CUDA error {err} at "
                                   f"launch")
            LAUNCHES["secure_mask"] += 1
        return out


def _check(leaves: Sequence[torch.Tensor], wn: torch.Tensor,
           keys: torch.Tensor) -> bool:
    """Shapes of a round's inputs; True on the card.  A CUDA tensor the
    kernel cannot take raises."""
    if not leaves:
        raise ValueError("secure_mask: no leaves")
    slots = leaves[0].shape[0]
    pairs = slots * (slots - 1) // 2
    if any(d.ndim != 2 or d.shape[0] != slots for d in leaves) \
            or tuple(wn.shape) != (slots,) \
            or tuple(keys.shape) != (len(leaves), pairs, 2):
        raise ValueError(
            f"secure_mask: leaves (S, n_l), wn (S,), keys (L, S(S-1)/2, 2); "
            f"got {[tuple(d.shape) for d in leaves]}, {tuple(wn.shape)}, "
            f"{tuple(keys.shape)}")
    dev = leaves[0].device
    if any(t.device != dev for t in (*leaves, wn, keys)):
        raise ValueError("secure_mask: leaves, wn and keys must lie on one "
                         "card")
    if dev.type != "cuda":
        return False
    if keys.dtype != torch.int32:
        raise TypeError(f"secure_mask: keys must be int32 (uint32 words), "
                        f"got {keys.dtype}")
    if not (wn.dtype.is_floating_point
            and all(d.dtype.is_floating_point for d in leaves)):
        raise TypeError("secure_mask: leaves and wn must be floating point")
    if slots > MAX_SLOTS:
        raise ValueError(f"secure_mask: {slots} slots, over {MAX_SLOTS}")
    return True


def masked_encode_leaves(leaves: Sequence[torch.Tensor], wn: torch.Tensor,
                         keys: torch.Tensor, clip: float):
    """Every leaf of a round, (S, n_l) deltas each, with the slots'
    weights `wn` (S,) and the packed pair keys (L, S(S-1)/2, 2) int32
    (`parallel/secure.py:leaf_pair_keys`): the (S, total) int32 masked
    words (uint32 bits), leaf l's at columns sum(n[:l]) .. + n_l, and
    each leaf's (S, n_l) view of them.  One launch of the kernel on CUDA
    tensors, the plain version on CPU ones."""
    if not _check(leaves, wn, keys):
        return masked_encode_leaves_plain(leaves, wn, keys, clip)
    words = RoundPlan(leaves, wn, keys, clip).launch()
    return words, _views(words, leaves)


def masked_encode(deltas: torch.Tensor, wn: torch.Tensor,
                  keys: torch.Tensor, clip: float) -> torch.Tensor:
    """(S, P) int32 masked words (uint32 bits) of one leaf's (S, P)
    deltas under its (S, S, 2) pair keys: a one-leaf table launch of the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if deltas.ndim != 2 or tuple(keys.shape) != (deltas.shape[0],) * 2 + (2,):
        raise ValueError(f"secure_mask: deltas (S, P), wn (S,), keys "
                         f"(S, S, 2); got {tuple(deltas.shape)}, "
                         f"{tuple(wn.shape)}, {tuple(keys.shape)}")
    slots = deltas.shape[0]
    lo, hi = torch.triu_indices(slots, slots, offset=1, device=keys.device)
    packed = keys[lo, hi]
    if not _check([deltas], wn, packed[None]):
        return masked_encode_plain(deltas, wn, packed, clip)
    return RoundPlan([deltas], wn, packed[None], clip).launch()


def unmask_sum(masked: torch.Tensor) -> torch.Tensor:
    """The sum over the slots of (S, ...) masked words, mod 2**32, read as
    int32 and dequantised: float32 sum / 2**16 (the reference's psum,
    `astype(int32).astype(float32) / _SCALE`)."""
    total = masked.to(torch.int64).sum(0) & MASK
    total = total - ((total >> 31) << 32)
    return total.to(torch.float32) / SCALE
