"""The deterministic leaf-shard partition of sharded re-derivation.

Copy of `bflc_demo_tpu/rederive/shards.py` (:1-73), byte for byte in its
arithmetic.  The map is protocol-adjacent: every validator, the
writer's cross-check and an auditor compute it from public inputs, so it
is a pure function of (leaf count, validator count, epoch).  Integer
arithmetic on the host; nothing here touches a device.

Coverage: each leaf is re-derived by ``shard_coverage(n)`` =
``min(n, max(2, 2f+1))`` validators, f = (n-1)//3.  With f colluders a
wrong leaf still has f+1 honest coverers, whose refusals leave the
writer at most 2f < 2f+1 signers.  Rotation: leaf j at epoch e is
covered by ``{(j + e + t) mod n : t < coverage}``.

A leaf's index is its place in ``sorted(flat.keys())`` of the model blob
both packages unpack, so a mixed fleet's validators shard the same
leaves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set


def shard_coverage(n_validators: int) -> int:
    """How many validators re-derive each leaf."""
    n = int(n_validators)
    if n <= 0:
        raise ValueError(f"need a positive validator count, got {n}")
    f = (n - 1) // 3
    return min(n, max(2, 2 * f + 1))


def leaf_owners(leaf_index: int, n_validators: int, epoch: int,
                coverage: int = 0) -> Set[int]:
    """The validator indices covering one leaf: the assignment rule."""
    n = int(n_validators)
    c = coverage or shard_coverage(n)
    base = (int(leaf_index) + int(epoch)) % n
    return {(base + t) % n for t in range(c)}


def leaf_shard(keys: Sequence[str], validator_index: int,
               n_validators: int, epoch: int) -> List[str]:
    """The leaf keys validator `validator_index` re-derives at `epoch`;
    `keys` is the canonical sorted leaf order."""
    n = int(n_validators)
    if n <= 1:
        return list(keys)
    c = shard_coverage(n)
    v = int(validator_index) % n
    return [k for j, k in enumerate(keys)
            if v in leaf_owners(j, n, epoch, c)]


def shard_map(keys: Sequence[str], n_validators: int,
              epoch: int) -> Dict[int, List[str]]:
    """{validator index: its shard} over the whole set."""
    return {v: leaf_shard(keys, v, n_validators, epoch)
            for v in range(max(int(n_validators), 1))}
