"""Shared ledger types and the canonical client-op encoders.

Copy of `bflc_demo_tpu/ledger/base.py`, synchronous subset: the status
codes, the record views and the register/upload/scores/commit encoders,
byte for byte (the encoders define the op bytes the hash chain covers),
the encoders of the stall detector's recovery ops (close_round,
force_aggregate, reseat_committee), which the reference writes inline
in `ledger/pyledger.py:404-460`, and
`staleness_weight`, the FedBuff merge weight the certified merge's
checker draws (`meshagg/check.py`).  Dropped:
the async (`OP_AUPLOAD`/`OP_ASCORES`/`OP_ACOMMIT`) and genome (`OP_GENOME`)
encoders and the legacy/arming switches of the modes this port has not
reached.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import struct
from typing import List, Sequence

import numpy as np

OP_REGISTER, OP_UPLOAD, OP_SCORES, OP_COMMIT = 1, 2, 3, 4
OP_CLOSE, OP_FORCE, OP_RESEAT = 5, 6, 7


def staleness_weight(staleness: int) -> float:
    """FedBuff's staleness discount 1/sqrt(1+s) (reference :100-105)."""
    return 1.0 / math.sqrt(1.0 + max(int(staleness), 0))


def _put_str(b: bytearray, s: str) -> None:
    raw = s.encode()
    b += struct.pack("<q", len(raw)) + raw


def encode_register_op(addr: str) -> bytes:
    op = bytearray([OP_REGISTER])
    _put_str(op, addr)
    return bytes(op)


def encode_upload_op(sender: str, payload_hash: bytes, n_samples: int,
                     avg_cost: float, epoch: int) -> bytes:
    op = bytearray([OP_UPLOAD])
    _put_str(op, sender)
    op += bytes(payload_hash)
    op += struct.pack("<q", n_samples)
    op += struct.pack("<f", np.float32(avg_cost))
    op += struct.pack("<q", epoch)
    return bytes(op)


def encode_scores_op(sender: str, epoch: int,
                     scores: Sequence[float]) -> bytes:
    op = bytearray([OP_SCORES])
    _put_str(op, sender)
    op += struct.pack("<q", epoch)
    op += struct.pack("<q", len(scores))
    for s in scores:
        op += struct.pack("<f", np.float32(s))
    return bytes(op)


def encode_commit_op(model_hash: bytes, epoch: int) -> bytes:
    """REDUCTION SPEC v1 commit body (no block-geometry tail)."""
    return bytes([OP_COMMIT]) + bytes(model_hash) + struct.pack("<q", epoch)


def encode_close_op(epoch: int) -> bytes:
    return bytes([OP_CLOSE]) + struct.pack("<q", epoch)


def encode_force_op(epoch: int) -> bytes:
    return bytes([OP_FORCE]) + struct.pack("<q", epoch)


def encode_reseat_op(epoch: int, addrs: Sequence[str]) -> bytes:
    op = bytearray([OP_RESEAT])
    op += struct.pack("<q", epoch)
    op += struct.pack("<q", len(addrs))
    for a in addrs:
        _put_str(op, a)
    return bytes(op)


class LedgerStatus(enum.IntEnum):
    OK = 0
    NOT_STARTED = 1        # registration phase (epoch at genesis sentinel)
    WRONG_EPOCH = 2        # stale upload
    DUPLICATE = 3          # same sender re-upload
    CAP_REACHED = 4        # needed_update_count hit
    NOT_COMMITTEE = 5      # scores from non-committee
    ALREADY_REGISTERED = 6
    NOT_READY = 7
    BAD_ARG = 8


@dataclasses.dataclass(frozen=True)
class UpdateInfo:
    """Ledger view of one collected update — hash + meta, no tensors."""
    sender: str
    payload_hash: bytes
    n_samples: int
    avg_cost: float


@dataclasses.dataclass(frozen=True)
class PendingInfo:
    """Outcome of a completed scoring phase, awaiting model commit."""
    medians: np.ndarray        # (update_count,)
    order: List[int]           # slots best-first (median desc, slot asc)
    selected: List[int]        # top-aggregate_count slots
    global_loss: float
