"""Shared ledger types and the canonical client-op encoders.

Copy of `bflc_demo_tpu/ledger/base.py`, synchronous subset: the status
codes, the record views and the register/upload/scores/commit encoders,
byte for byte (the encoders define the op bytes the hash chain covers),
the encoders of the stall detector's recovery ops (close_round,
force_aggregate, reseat_committee), which the reference writes inline
in `ledger/pyledger.py:404-460`, the writer promotion fence (opcode 8,
written inline at `ledger/pyledger.py:466-488`), `decode_op`, the op
decoder of `ledger/tool.py:85-168` for opcodes 1-12 (the standby reads an
upload's payload hash and a commit's model hash with it), and
`staleness_weight`, the FedBuff merge weight, REDUCTION SPEC v2's
switches (`blocked_legacy`, `reduce_blocks`, `blocked_enabled`, :57-81)
and the asynchronous buffered family (:31-54, :141-240): `OP_AUPLOAD`/
`OP_ASCORES`/`OP_ACOMMIT`, `async_legacy`, `async_enabled`,
`encode_aupload_op`, `encode_ascores_op`, `ascores_sign_payload`,
`AsyncUpdateInfo` and `parse_acommit`, the opcode-12 body parse of the
reference's `PyLedger.apply_op` (:1307-1338), which the ledger's replay
and the writer's chain record share, and the closed compression loop:
`OP_GENOME` (opcode 13, :39), `encode_genome_op` (:170-190),
`adapt_legacy` and `adapt_enabled` (:84-97).  `decode_op` renders
opcode 13 too, which the reference's tool names unknown.  `ADDR_CAP`
(:26) is the address length the native ledger's C ABI carries.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
import struct
from typing import List, Sequence, Tuple

import numpy as np

ADDR_CAP = 128   # max address string length crossing the C ABI (incl. NUL)

OP_REGISTER, OP_UPLOAD, OP_SCORES, OP_COMMIT = 1, 2, 3, 4
OP_CLOSE, OP_FORCE, OP_RESEAT, OP_PROMOTE = 5, 6, 7, 8
OP_SNAPSHOT = 9
# asynchronous buffered aggregation (FedBuff on the certified op stream)
OP_AUPLOAD, OP_ASCORES, OP_ACOMMIT = 10, 11, 12
# the certified genome update (the closed compression loop)
OP_GENOME = 13
OP_NAMES = {OP_REGISTER: "register", OP_UPLOAD: "upload",
            OP_SCORES: "scores", OP_COMMIT: "commit",
            OP_CLOSE: "close_round", OP_FORCE: "force_aggregate",
            OP_RESEAT: "reseat_committee", OP_PROMOTE: "promote_writer",
            OP_SNAPSHOT: "snapshot", OP_AUPLOAD: "async_upload",
            OP_ASCORES: "async_scores", OP_ACOMMIT: "async_commit",
            OP_GENOME: "genome_update"}


def async_legacy() -> bool:
    """True when BFLC_ASYNC_LEGACY pins the synchronous round barrier
    whatever ProtocolConfig.async_buffer says."""
    return bool(os.environ.get("BFLC_ASYNC_LEGACY"))


def async_enabled(cfg) -> bool:
    """The one decision point for the async buffered mode: a positive
    buffer in the genome and no legacy pin.  The ledger, the writer, the
    clients and the fleet all read it here."""
    return getattr(cfg, "async_buffer", 0) > 0 and not async_legacy()


def blocked_legacy() -> bool:
    """True when BFLC_BLOCKED_LEGACY pins REDUCTION SPEC v1's
    single-block wire format whatever ProtocolConfig.reduce_blocks says."""
    return bool(os.environ.get("BFLC_BLOCKED_LEGACY"))


def reduce_blocks(cfg) -> int:
    """The one decision point for the block geometry (REDUCTION SPEC
    v2): the genome's reduce_blocks unless the legacy pin flattens it to
    1.  The ledger, the writer's merge and the CLI all read it here, so
    no layer can disagree about the geometry a commit op must claim."""
    if blocked_legacy():
        return 1
    try:
        return max(int(getattr(cfg, "reduce_blocks", 1) or 1), 1)
    except (TypeError, ValueError):
        return 1


def blocked_enabled(cfg) -> bool:
    """True when commit ops carry (and replicas enforce) a geometry
    claim: the chain speaks the v2 wire format."""
    return reduce_blocks(cfg) > 1


def adapt_legacy() -> bool:
    """True when BFLC_ADAPT_LEGACY pins the static compression knobs
    whatever ProtocolConfig.adapt_every says: no genome-update op is
    proposed or accepted, and the bytes are the static protocol's."""
    return bool(os.environ.get("BFLC_ADAPT_LEGACY"))


def adapt_enabled(cfg) -> bool:
    """The one decision point for the closed compression loop: a
    positive adapt interval in the genome and no legacy pin.  The
    ledger, the writer, the clients, the cells and the validators all
    read it here."""
    return getattr(cfg, "adapt_every", 0) > 0 and not adapt_legacy()


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


def encode_aupload_op(sender: str, payload_hash: bytes, n_samples: int,
                      avg_cost: float, base_epoch: int) -> bytes:
    """Opcode 2's layout with the trailing epoch read as the BASE epoch
    the client trained from; admission stamps the staleness."""
    op = bytearray([OP_AUPLOAD])
    _put_str(op, sender)
    op += bytes(payload_hash)
    op += struct.pack("<q", n_samples)
    op += struct.pack("<f", np.float32(avg_cost))
    op += struct.pack("<q", base_epoch)
    return bytes(op)


def encode_ascores_op(sender: str,
                      pairs: Sequence[Tuple[int, float]]) -> bytes:
    """(admission seq, f32 score) pairs; no epoch: the entry id binds."""
    op = bytearray([OP_ASCORES])
    _put_str(op, sender)
    op += struct.pack("<q", len(pairs))
    for aseq, s in pairs:
        op += struct.pack("<q", int(aseq))
        op += struct.pack("<f", np.float32(s))
    return bytes(op)


def encode_genome_op(epoch: int, new_density: float, new_staleness: int,
                     update_norm: float, drift: float,
                     disagreement: float) -> bytes:
    """Genome update (opcode 13): the writer's proposed effective-knob
    transition and the telemetry it derived it from.  Every replica
    re-runs the rule (`control/loop.decide`) over the carried inputs,
    re-derives `disagreement` from its own certified score state and
    refuses BAD_ARG on a mismatch.  Floats store f32."""
    op = bytearray([OP_GENOME])
    op += struct.pack("<q", int(epoch))
    op += struct.pack("<f", np.float32(new_density))
    op += struct.pack("<q", int(new_staleness))
    op += struct.pack("<f", np.float32(update_norm))
    op += struct.pack("<f", np.float32(drift))
    op += struct.pack("<f", np.float32(disagreement))
    return bytes(op)


def ascores_sign_payload(pairs: Sequence[Tuple[int, float]]) -> bytes:
    """The f64 payload an async score tag signs (the op stores f32;
    `comm/bft.check_op_auth` pins the rounding)."""
    b = bytearray()
    for aseq, s in pairs:
        b += struct.pack("<qd", int(aseq), float(s))
    return bytes(b)


def parse_acommit(op: bytes):
    """(model hash, epoch, k, seats, blocks) of an opcode-12 op: `seats`
    is the reseat claim's address list (None without one), `blocks` the
    BLK1 geometry claim (None without one).  None when the op is no
    well-formed opcode 12 (the ledger's replay refuses it)."""
    if op[:1] != bytes([OP_ACOMMIT]) or len(op) < 49:
        return None
    body = op[1:]
    try:
        ep, k = struct.unpack_from("<qq", body, 32)
        seats = blocks = None
        off = 48
        if len(body) > off and body[off:off + 4] != b"BLK1":
            # the reseat claim: <q n> then n length-prefixed addresses
            n, = struct.unpack_from("<q", body, 48)
            if n <= 0 or n > (len(body) - 56) // 8:
                return None
            off, seats = 56, []
            for _ in range(n):
                ln, = struct.unpack_from("<q", body, off)
                if ln < 0 or off + 8 + ln > len(body):
                    return None
                seats.append(body[off + 8:off + 8 + ln].decode())
                off += 8 + ln
        if len(body) > off:
            # what trails must be exactly the BLK1 claim
            if body[off:off + 4] != b"BLK1" or off + 12 != len(body):
                return None
            blocks, = struct.unpack_from("<q", body, off + 4)
    except (struct.error, UnicodeDecodeError):
        return None
    return body[:32], ep, k, seats, blocks


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


def encode_promote_op(generation: int, writer_index: int) -> bytes:
    return bytes([OP_PROMOTE]) + struct.pack("<qq", generation, writer_index)


def decode_op(op: bytes) -> dict:
    """One op's fields, rendered as the reference's `ledger/tool.py`
    does; no state rules applied.  Opcodes 1-13 (the reference's tool
    stops at 12 and names 13 unknown); others are named unknown, and a
    malformed body adds `malformed`."""
    if not op:
        return {"op": "empty"}
    code, body = op[0], op[1:]
    out = {"op": OP_NAMES.get(code, f"unknown({code})"), "bytes": len(op)}

    def s_at(off):
        (n,) = struct.unpack_from("<q", body, off)
        if n < 0 or off + 8 + n > len(body):
            raise ValueError("string past end of op")
        return body[off + 8:off + 8 + n].decode(), off + 8 + n

    try:
        if code == OP_REGISTER:
            out["addr"], _ = s_at(0)
        elif code == OP_UPLOAD:
            out["sender"], off = s_at(0)
            out["payload_hash"] = body[off:off + 32].hex()
            out["n_samples"], = struct.unpack_from("<q", body, off + 32)
            out["avg_cost"] = round(
                struct.unpack_from("<f", body, off + 40)[0], 6)
            out["epoch"], = struct.unpack_from("<q", body, off + 44)
        elif code == OP_SCORES:
            out["sender"], off = s_at(0)
            out["epoch"], = struct.unpack_from("<q", body, off)
            cnt, = struct.unpack_from("<q", body, off + 8)
            out["scores"] = [round(v, 4) for v in
                             struct.unpack_from(f"<{cnt}f", body, off + 16)]
        elif code == OP_COMMIT:
            out["model_hash"] = body[:32].hex()
            out["epoch"], = struct.unpack_from("<q", body, 32)
        elif code in (OP_CLOSE, OP_FORCE):
            out["epoch"], = struct.unpack_from("<q", body, 0)
        elif code == OP_RESEAT:
            out["epoch"], = struct.unpack_from("<q", body, 0)
            n, = struct.unpack_from("<q", body, 8)
            off, addrs = 16, []
            for _ in range(max(0, min(n, (len(body) - 16) // 8))):
                a, off = s_at(off)
                addrs.append(a)
            out["committee"] = addrs
        elif code == OP_PROMOTE:
            out["generation"], = struct.unpack_from("<q", body, 0)
            out["writer_index"], = struct.unpack_from("<q", body, 8)
        elif code == OP_SNAPSHOT:
            out["epoch"], = struct.unpack_from("<q", body, 0)
            out["state_digest"] = body[8:40].hex()
        elif code == OP_AUPLOAD:
            out["sender"], off = s_at(0)
            out["payload_hash"] = body[off:off + 32].hex()
            out["n_samples"], = struct.unpack_from("<q", body, off + 32)
            out["avg_cost"] = round(
                struct.unpack_from("<f", body, off + 40)[0], 6)
            out["epoch"], = struct.unpack_from("<q", body, off + 44)
            out["base_epoch"] = out["epoch"]
        elif code == OP_ASCORES:
            out["sender"], off = s_at(0)
            cnt, = struct.unpack_from("<q", body, off)
            pairs, p = [], off + 8
            for _ in range(max(0, min(cnt, (len(body) - off - 8) // 12))):
                a, = struct.unpack_from("<q", body, p)
                s, = struct.unpack_from("<f", body, p + 8)
                pairs.append([a, round(s, 4)])
                p += 12
            out["pairs"] = pairs
        elif code == OP_ACOMMIT:
            out["model_hash"] = body[:32].hex()
            out["epoch"], = struct.unpack_from("<q", body, 32)
            out["drained"], = struct.unpack_from("<q", body, 40)
            if len(body) > 48:
                # the reference reads any extended body as the reseat
                # claim (a bare BLK1 tail renders as an empty committee)
                n, = struct.unpack_from("<q", body, 48)
                off, addrs = 56, []
                for _ in range(max(0, min(n, (len(body) - 56) // 8))):
                    a, off = s_at(off)
                    addrs.append(a)
                out["committee"] = addrs
        elif code == OP_GENOME:
            out["epoch"], = struct.unpack_from("<q", body, 0)
            out["density"], = struct.unpack_from("<f", body, 8)
            out["staleness"], = struct.unpack_from("<q", body, 12)
            out["update_norm"], out["drift"], out["disagreement"] = \
                struct.unpack_from("<fff", body, 20)
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        out["malformed"] = f"{type(e).__name__}: {e}"
    return out


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
class AsyncUpdateInfo:
    """One staleness-tagged entry in the async admission buffer."""
    aseq: int                  # admission sequence number (chain-global)
    sender: str
    payload_hash: bytes
    n_samples: int
    avg_cost: float
    base_epoch: int            # epoch of the model the client trained on
    staleness: int             # epoch_at_admission - base_epoch


@dataclasses.dataclass(frozen=True)
class PendingInfo:
    """Outcome of a completed scoring phase, awaiting model commit."""
    medians: np.ndarray        # (update_count,)
    order: List[int]           # slots best-first (median desc, slot asc)
    selected: List[int]        # top-aggregate_count slots
    global_loss: float
