"""The validator re-derivation plane: the commit's model hash re-run.

Copy of `bflc_demo_tpu/rederive/__init__.py` (:1-84): the mode names
and their one resolution point.  Every other writer claim is re-executed
by the BFT quorum before it binds; the commit op's model hash was taken
on the writer's word, because validators hold no payload blob.  With the
plane armed, a validator fetches the round's admitted deltas through the
read path (each blob checked against an upload op it co-signed), runs
the one decode chain and REDUCTION SPEC v2's merge for its leaves on the
certified merge engine (kernel B5 on the card, `rederive/core.py`), and
refuses (status `REDERIVE`) a commit whose bytes it cannot reproduce or
whose aggregate holds a NaN or an Inf.

Modes (`BFLC_REDERIVE` / `--rederive`):

- ``off`` (the default): the guard check alone, bytes unchanged;
- ``shard``: each validator re-derives a leaf subset that is a pure
  function of (leaf count, validator count, epoch) (`rederive/shards.py`),
  every leaf covered by min(n, max(2, 2f+1)) validators, so f colluders
  cannot save a lying writer; a disagreeing leaf escalates that
  validator to the full model before it votes;
- ``full``: every validator re-derives every leaf.

An input that is unavailable (no evidence from a writer that does not
arm the plane, no serving replica) is a counted skip on the guard check,
never a wedge.  `BFLC_REDERIVE_LEGACY=1` pins the plane off.

This module imports nothing but `os`: a disarmed validator stays free of
torch.
"""

from __future__ import annotations

import os

REDERIVE_MODES = ("off", "shard", "full")


def rederive_legacy() -> bool:
    """True when BFLC_REDERIVE_LEGACY pins the plane off whatever the
    mode says."""
    return bool(os.environ.get("BFLC_REDERIVE_LEGACY"))


def rederive_mode() -> str:
    """BFLC_REDERIVE in {off, shard, full}; 'off' on anything unknown (a
    typo degrades to the guard check, never crashes a validator), and the
    legacy pin wins."""
    if rederive_legacy():
        return "off"
    mode = os.environ.get("BFLC_REDERIVE", "off").strip().lower()
    return mode if mode in REDERIVE_MODES else "off"


def rederive_armed() -> bool:
    """True when this process takes part in the plane: validators
    re-derive before voting, writers attach commit evidence (the claimed
    model blob and the read set) and keep the round's blobs one round
    for the validators' fetches."""
    return rederive_mode() != "off"
