"""Secure aggregation: pairwise-masked fixed-point FedAvg (config 4's
variant) on one card.

Port of `bflc_demo_tpu/parallel/secure.py`, whole: `_FRAC_BITS` /
`_SCALE`, the mask keys of `_client_mask` (:55-81) and `_client_mask_dh`
(:84-121), `derive_pair_seeds` (:124-147), `secure_masked_sum`
(:153-232), `secure_fedavg_body` (:235-307) and `secure_fedavg`
(:310-344).  Every slot pair (i, j) shares a key; slot i adds the pair's
mask for j > i and subtracts it for j < i, so the masks cancel exactly in
the sum mod 2**32, which therefore equals the sum of the unmasked
fixed-point values bit for bit, while a single slot's words are noise
to anyone without the pair keys.  Two key modes, as in the reference:

- shared round key (`round_key`, a `utils.prng` key): the pair's key is
  ``fold_in(fold_in(round_key, lo * n + hi), leaf_idx)``; privacy holds
  against observers without the key;
- X25519 pair seeds (`pair_seeds`, (N, N, 8) uint32 from
  `derive_pair_seeds`): the pair's key folds the seed's 8 words into
  ``PRNGKey(0)``, then the optional `tweak`, then the leaf index; the
  aggregator, holding no private key, cannot strip a mask.

The merge: nan_to_num -> clip -> times w_i / sum(w) -> clip ->
``round(x * 2**16)`` int32 -> mask -> sum mod 2**32 -> int32 -> float32 /
2**16 -> ``g - lr * m`` in g's dtype.  The encode and mask of every
leaf is kernel B7 (`ops/secure_mask.py`, `csrc/secure_mask.cu`), one
launch a merge into one (S, total) array of words; the sum over slots
and the unmask are elementwise torch, once over that array.  One card
has no psum: the client axis is the slots' leading axis, and the sum
over it is the sum mod 2**32, which no order changes.  The mask keys are
derived on the host (`leaf_pair_keys`: every pair, every leaf, one
vectorised Threefry pass a fold) and copied to the card once a merge.

Leaf order is `jax.tree_util.tree_flatten`'s (`ops.fingerprint.
leaf_order` of the keystr keys), so each leaf's index, and with it every
masked word, is the reference's.

Dropped: the mesh argument and the shard_map program cache (one card,
no compile).  `secure_masked_sum` maps a NaN input to 0 before the clip
(it shares B7's encode at unit weights); the reference's int32 cast of a
NaN there is implementation-defined.  The pair seeds must be symmetric
(`derive_pair_seeds` makes them so): one key a pair draws its mask once.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.core.losses import fma32, xla_cpu_order
from bflc_demo_tpu_torch.device import upload
from bflc_demo_tpu_torch.models.base import Params
from bflc_demo_tpu_torch.ops import secure_mask
from bflc_demo_tpu_torch.ops.fingerprint import leaf_order
from bflc_demo_tpu_torch.utils import prng

_FRAC_BITS = secure_mask.FRAC_BITS           # fixed-point fractional bits
_SCALE = secure_mask.SCALE
_CAPACITY = float(1 << (31 - _FRAC_BITS))    # int32 fixed-point ceiling


def leaf_pair_keys(key_or_seeds, n: int, n_leaves: int, dh_mode: bool,
                   tweak: Optional[int] = None) -> np.ndarray:
    """(n_leaves, n(n-1)/2, 2) uint32: the mask key of every slot pair
    (i, j), i < j in row order, and leaf — `_client_mask`'s chain in
    shared-key mode and `_client_mask_dh`'s in DH mode; B7's packed key
    table."""
    lo, hi = np.triu_indices(n, k=1)
    if dh_mode:
        seeds = np.asarray(key_or_seeds, np.uint32)
        base = np.broadcast_to(prng.PRNGKey(0), (lo.size, 2))
        for word in range(8):
            base = prng.fold_in_many(base, seeds[lo, hi, word])
        if tweak is not None:
            base = prng.fold_in_many(base, int(tweak))
    else:
        key = np.asarray(key_or_seeds, np.uint32)
        base = prng.fold_in_many(np.broadcast_to(key, (lo.size, 2)),
                                 lo * n + hi)
    leaves = np.arange(n_leaves)[:, None]
    return prng.fold_in_many(
        np.broadcast_to(base, (n_leaves,) + base.shape), leaves)


def leaf_keys(key_or_seeds, n: int, n_leaves: int, dh_mode: bool,
              tweak: Optional[int] = None) -> np.ndarray:
    """(n_leaves, n, n, 2) uint32: `leaf_pair_keys` as symmetric pair
    matrices (the diagonal unused)."""
    keys = leaf_pair_keys(key_or_seeds, n, n_leaves, dh_mode, tweak)
    lo, hi = np.triu_indices(n, k=1)
    out = np.zeros((n_leaves, n, n, 2), np.uint32)
    out[:, lo, hi] = keys
    out[:, hi, lo] = keys
    return out


def _client_mask(round_key, i: int, n: int, shape,
                 leaf_idx: int) -> np.ndarray:
    """Slot i's summed signed pair masks (uint32, `shape`) in shared-key
    mode — the reference's `_client_mask`, drawn on the host."""
    keys = leaf_keys(round_key, n, leaf_idx + 1, False)[leaf_idx]
    return _signed_sum(keys, i, n, shape)


def _client_mask_dh(pair_seeds, i: int, n: int, shape, leaf_idx: int,
                    tweak: Optional[int] = None) -> np.ndarray:
    """`_client_mask` keyed by the X25519 pair seeds (`_client_mask_dh`)."""
    keys = leaf_keys(pair_seeds, n, leaf_idx + 1, True, tweak)[leaf_idx]
    return _signed_sum(keys, i, n, shape)


def _signed_sum(keys: np.ndarray, i: int, n: int, shape) -> np.ndarray:
    acc = np.zeros(shape, np.uint32)
    with np.errstate(over="ignore"):
        for j in range(n):
            if j != i:
                m = prng.bits(keys[i, j], shape)
                acc = acc + m if j > i else acc - m
    return acc


def derive_pair_seeds(wallets, round_index: int) -> np.ndarray:
    """(N, N, 8) uint32 symmetric pair-seed matrix: entry [i, j] is the
    32 bytes of wallet i's X25519 exchange with wallet j bound to the
    round (`Wallet.pair_secret`, context ``struct.pack("<q", round)``),
    as 8 little-endian words.  Both endpoints derive the same bytes; the
    aggregator cannot.  Here the whole matrix is assembled in one place;
    a deployment computes row i on client i."""
    n = len(wallets)
    seeds = np.zeros((n, n, 8), np.uint32)
    ctx = struct.pack("<q", round_index)
    for i in range(n):
        for j in range(i + 1, n):
            s = wallets[i].pair_secret(wallets[j].dh_public_bytes,
                                       context=ctx)
            seeds[i, j] = seeds[j, i] = np.frombuffer(s, "<u4")
    return seeds


def _check_seeds(pair_seeds, n: int) -> np.ndarray:
    seeds = np.asarray(pair_seeds)
    if seeds.shape != (n, n, 8):
        raise ValueError(f"pair_seeds must be ({n}, {n}, 8), got "
                         f"{tuple(seeds.shape)}")
    seeds = seeds.astype(np.uint32)
    if not np.array_equal(seeds, seeds.transpose(1, 0, 2)):
        raise ValueError("pair_seeds must be symmetric (seeds[i, j] == "
                         "seeds[j, i]): each pair draws one mask")
    return seeds


def _masked_leaves(values: Params, wn: torch.Tensor, key_or_seeds,
                   clip: float, dh_mode: bool,
                   tweak: Optional[int]) -> dict:
    """{key: dequantised float32 sum over the slots} of the stacked
    `values`: every leaf's slots encoded and masked by one B7 launch
    (`wn` the slots' weights), summed mod 2**32 and unmasked once over
    the round's (S, total) words; each leaf's sum is a view of that."""
    order = leaf_order(list(values))
    first = values[order[0]]
    n = first.shape[0]
    keys = upload(leaf_pair_keys(key_or_seeds, n, len(order), dh_mode,
                                 tweak).view(np.int32), first.device)
    flat = [values[k].reshape(n, -1) for k in order]
    words, _ = secure_mask.masked_encode_leaves(flat, wn, keys, clip)
    sums = torch.split(secure_mask.unmask_sum(words),
                       [d.shape[1] for d in flat])
    return {k: m.reshape(values[k].shape[1:]) for k, m in zip(order, sums)}


def secure_masked_sum(values: Params, round_key=None, clip: float = 64.0,
                      sum_bound: Optional[float] = None,
                      pair_seeds=None) -> Params:
    """The sum over the leading (client) axis of stacked `values`, each
    client's fixed-point contribution blinded by pairwise-cancelling masks
    before the sum; dequantised float32.  `pair_seeds` (N, N, 8) selects
    the DH mode (`round_key` is then unused).

    Capacity: the unmasked total must stay below 2**(31 - _FRAC_BITS) =
    32768 in magnitude or the sum mod 2**32 wraps; the guard takes
    `sum_bound` when given, else the worst case N * clip."""
    n = next(iter(values.values())).shape[0]
    bound = sum_bound if sum_bound is not None else n * clip
    if bound >= _CAPACITY:
        raise ValueError(
            f"fixed-point capacity exceeded: sum bound {bound:g} >= "
            f"{int(_CAPACITY)}; lower clip, pre-normalise, or pass a "
            f"tighter sum_bound")
    dh_mode = pair_seeds is not None
    key = _check_seeds(pair_seeds, n) if dh_mode else round_key
    ones = torch.ones(n, dtype=torch.float32,
                      device=next(iter(values.values())).device)
    return _masked_leaves(values, ones, key, clip, dh_mode, None)


def _step(g: torch.Tensor, lr: float, m: torch.Tensor) -> torch.Tensor:
    """``g - lr * m`` in g's dtype: on CPU tensors float32 takes XLA:CPU's
    one rounding (the multiply-subtract contracts into an FMA)."""
    if g.dtype == torch.float32:
        if xla_cpu_order(g):
            return fma32(-lr, m, g)
        return g - lr * m
    return g - torch.tensor(lr, dtype=g.dtype, device=g.device) * m.to(
        g.dtype)


def secure_fedavg_body(params: Params, deltas: Params,
                       n_samples: torch.Tensor, sel: torch.Tensor,
                       lr: float, key_or_seeds, *, clip: float,
                       dh_mode: bool,
                       round_tweak: Optional[int] = None) -> Params:
    """The secure merge of one round: `params - lr * wmean(selected
    deltas)` with every slot's weighted, clipped fixed-point delta
    blinded before the sum.  deltas: stacked, leading axis the N slots;
    n_samples (N,) int and sel (N,) bool on the deltas' device;
    key_or_seeds a round key (shared-key mode) or the (N, N, 8) pair
    seeds (DH mode).  `round_tweak` (an int) re-keys a round of a
    multi-round dispatch: folded into the key in shared-key mode, into
    each pair's chain in DH mode.  Each delta is clipped BEFORE the
    weighting, so the weighted sum is bounded by `clip` for any N
    (weights sum to 1), which must stay below the int32 fixed-point
    ceiling — checked here."""
    if clip >= _CAPACITY:
        raise ValueError(f"fixed-point capacity exceeded: clip {clip:g} >= "
                         f"{int(_CAPACITY)}")
    n = next(iter(deltas.values())).shape[0]
    if dh_mode:
        key_or_seeds = _check_seeds(key_or_seeds, n)
    elif round_tweak is not None:
        key_or_seeds = prng.fold_in(key_or_seeds, int(round_tweak))
        round_tweak = None
    w = n_samples.to(torch.float32) * sel.to(torch.float32)
    wn = w / w.sum().clamp_min(1e-12)
    mean = _masked_leaves(deltas, wn, key_or_seeds, clip, dh_mode,
                          round_tweak)
    return {k: _step(g, lr, mean[k]) for k, g in params.items()}


def secure_fedavg(deltas: Params, n_samples: torch.Tensor,
                  sel_mask: torch.Tensor, global_params: Params, lr: float,
                  round_key=None, clip: float = 64.0,
                  pair_seeds=None) -> Params:
    """Sample-weighted FedAvg with each selected delta blinded before the
    sum (pass `pair_seeds` for the DH mode the aggregator cannot strip):
    `apply_selection` up to fixed-point quantisation and per-delta
    clipping at +-clip.  The reference's standalone wrapper, without its
    mesh argument."""
    n = next(iter(deltas.values())).shape[0]
    dh_mode = pair_seeds is not None
    if dh_mode:
        _check_seeds(pair_seeds, n)
    return secure_fedavg_body(global_params, deltas, n_samples, sel_mask,
                              lr, pair_seeds if dh_mode else round_key,
                              clip=clip, dh_mode=dh_mode)
