"""Secure aggregation's masked fixed-point encode: kernel B7.

Port of the per-leaf encode and mask of
`bflc_demo_tpu/parallel/secure.py:secure_fedavg_body` (:217-295) with
`_client_mask` (:54-83) and `_client_mask_dh` (:86-117), an XLA program
in the reference (no `pallas_call`), bit for bit.  For one leaf of S
slot-stacked deltas (S, P), the slots' normalised weights `wn` (S,), the
pairs' keys (S, S, 2) (uint32 words, symmetric, the leaf index already
folded in: `parallel/secure.py:leaf_keys`) and the clip, each slot's
masked word is

    q_i + sum_{j>i} m_ij - sum_{j<i} m_ij   (mod 2**32)

with q_i = int32(round(clip(clip(nan_to_num(d_i)) * wn_i) * 2**16)) and
m_ij = x0 ^ x1 of Threefry-2x32 under key_ij over the leaf's flat iota
(hi word, lo word) — `jax.random.bits`' partitionable draw, which
`utils/prng.bits` reproduces.  Summed over the slots the masks cancel,
so the sum is the sum of the q_i.

`masked_encode` runs the hand-written CUDA kernel (`csrc/secure_mask.cu`,
one thread an element, every slot and pair in one launch, each pair's
mask drawn once) on CUDA tensors and `masked_encode_plain` on CPU
tensors; a CUDA tensor the kernel cannot take raises.
`LAUNCHES["secure_mask"]` counts kernel launches.

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
- `offset` shifts the counters, so that a window of a leaf can be held
  against the kernel's words without drawing the whole leaf.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.utils import prng

MASK = 0xFFFFFFFF
FRAC_BITS = 16
SCALE = float(1 << FRAC_BITS)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the plain version draws at most this many mask words at once
_PLAIN_CHUNK = 1 << 26
# the kernel's block, and blocks a launch at most (grid-stride beyond)
_THREADS = 128
_MAX_BLOCKS = 132 * 16
# shared memory a block may use on an H100 (227 KB)
_MAX_SMEM = 232448

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
    is element `offset` of the leaf — the reference's arithmetic, each
    pair's mask drawn once for all W elements.  On the CPU the masks are
    `utils/prng`'s numpy uint32 Threefry (wrapping natively: half the
    bytes and no masking a step); elsewhere torch's int64."""
    slots, width = deltas.shape
    dev = deltas.device
    acc = encode_plain(deltas, wn, clip)
    lo, hi = torch.triu_indices(slots, slots, offset=1, device=dev)
    kk = keys.to(dev, torch.int64) & MASK
    k0, k1 = kk[lo, hi, 0][:, None], kk[lo, hi, 1][:, None]
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


# ------------------------------------------------------------------ kernel
_P = ctypes.c_void_p
_ARGTYPES = {
    "bflc_secure_mask": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float, _P, ctypes.c_int, _P],
    "bflc_secure_mask_smem": [ctypes.c_int],
}


def _entry(name: str):
    from bflc_demo_tpu_torch.ops.build import load
    fn = getattr(load("secure_mask"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = (ctypes.c_longlong if name.endswith("smem")
                      else ctypes.c_int)
    return fn


def launch(deltas: torch.Tensor, wn: torch.Tensor, keys: torch.Tensor,
           clip: float, out: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel into `out` (S, P) int32, on checked CUDA
    tensors: deltas (S, P) float32, wn (S,) float32, keys (S, S, 2)
    int32 holding the uint32 words, all contiguous on one card."""
    slots, n = deltas.shape
    smem = _entry("bflc_secure_mask_smem")(slots)
    if smem > _MAX_SMEM:
        raise ValueError(f"secure_mask: {slots} slots need {smem} bytes of "
                         f"shared memory a block, over {_MAX_SMEM}")
    blocks = max(1, min(-(-n // _THREADS), _MAX_BLOCKS))
    err = _entry("bflc_secure_mask")(
        deltas.data_ptr(), wn.data_ptr(), keys.data_ptr(), slots, n,
        float(clip), out.data_ptr(), blocks,
        torch.cuda.current_stream(deltas.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bflc_secure_mask: CUDA error {err} at launch")
    LAUNCHES["secure_mask"] += 1
    return out


def masked_encode(deltas: torch.Tensor, wn: torch.Tensor,
                  keys: torch.Tensor, clip: float,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, P) int32 masked words (uint32 bits) of one leaf's (S, P)
    deltas: the kernel on CUDA tensors, the plain version on CPU ones."""
    if deltas.ndim != 2 or wn.shape != (deltas.shape[0],) \
            or tuple(keys.shape) != (deltas.shape[0], deltas.shape[0], 2):
        raise ValueError(f"secure_mask: deltas (S, P), wn (S,), keys "
                         f"(S, S, 2); got {tuple(deltas.shape)}, "
                         f"{tuple(wn.shape)}, {tuple(keys.shape)}")
    if not deltas.is_cuda:
        return masked_encode_plain(deltas, wn, keys, clip)
    dev = deltas.device
    if wn.device != dev or keys.device != dev:
        raise ValueError("secure_mask: deltas, wn and keys must lie on one "
                         "card")
    if keys.dtype != torch.int32:
        raise TypeError(f"secure_mask: keys must be int32 (uint32 words), "
                        f"got {keys.dtype}")
    deltas = deltas.to(torch.float32).contiguous()
    if out is None:
        out = torch.empty(deltas.shape, dtype=torch.int32, device=dev)
    return launch(deltas, wn.to(torch.float32).contiguous(),
                  keys.contiguous(), clip, out)


def unmask_sum(masked: torch.Tensor) -> torch.Tensor:
    """The sum over the slots of (S, ...) masked words, mod 2**32, read as
    int32 and dequantised: float32 sum / 2**16 (the reference's psum,
    `astype(int32).astype(float32) / _SCALE`)."""
    total = masked.to(torch.int64).sum(0) & MASK
    total = total - ((total >> 31) << 32)
    return total.to(torch.float32) / SCALE
