"""Pure-Python committee ledger — the synchronous subset.

Copy of `bflc_demo_tpu/ledger/pyledger.py:PyLedger`, cut to what the
host, threaded and process runtimes and the fleet's standbys drive:
`register_node`, `query_state`, `query_global_model`,
`upload_local_update`, `upload_scores`, `query_all_updates`,
`aggregate_ready`, `pending`, `commit_model`; the stall detector's
recovery ops `close_round` (:404), `force_aggregate` (:422) and
`reseat_committee` (:437) with `round_closed` (:462); the writer fence
`promote_writer` (opcode 8, :466-488) with `generation` and
`writer_index` read from the chain; the inspection properties
(`num_registered` :945, `last_disagreement` :922, which stays 0.0
without the closed compression loop); the SHA-256 op-log chain
(`_append_log`, `log_head`, `log_size`, `verify_log`, `log_op`,
`head_at`); the write-ahead log in the `BFLCWAL1` format byte for byte
(`attach_wal`, `save_wal`, `detach_wal`, `replay_wal`, :148-253: a
failed journal write detaches the WAL and the ledger keeps serving);
certified snapshots and compaction (:176-300, :993-1160): `log_base`,
`encode_state`, `state_digest`, `_install_state`, `gc_prefix` (chain
positions stay absolute: every accessor counts from the base) and the
compacted `BFLCWAL2` journal with `compact_wal` and its replay;
REDUCTION SPEC v2's block geometry on the chain (`reduce_blocks`, the
`BLK1` claim tail of a blocked genome's commit op, `commit_model`'s
`blocks` claim, :56-97, :545-590); `apply_op` (:1207), the replica's
replay, for opcodes 1-9, the commit's 40-byte v1 and 52-byte v2 bodies
included (:1242-1255), the snapshot op re-deriving its digest; and the
BFT validator's probe `validate_op` with
`_snapshot`/`_restore` (:1161-1205), which leaves the state and the WAL
untouched.  Same op bytes, same statuses, same median / rank / election
order, so the same op sequence gives the same chain head as the
reference ledger, bit for bit.

Not ported, each with its own A9 item: the asynchronous buffered family
(10-12, with the async commit's geometry tail) and genome updates (13),
with their state tails.  `apply_op` refuses those opcodes with BAD_ARG,
as the reference does an unknown one.  The native `.so` is not bound.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.ledger.base import (
    OP_CLOSE, OP_COMMIT, OP_FORCE, OP_PROMOTE, OP_REGISTER, OP_RESEAT,
    OP_SCORES, OP_SNAPSHOT, OP_UPLOAD, LedgerStatus, PendingInfo,
    UpdateInfo, encode_close_op, encode_commit_op, encode_force_op,
    encode_promote_op, encode_register_op, encode_reseat_op,
    encode_scores_op, encode_upload_op)

# commit_model's `blocks` default: "derive the claim from this replica's
# genome" (the writer path).  Distinct from None, which means "the op
# carried no geometry claim" (a v1 body on the replay path).
_DERIVE_BLOCKS = object()

# magic tag introducing the block-geometry claim tail on commit ops
_BLOCKS_MAGIC = b"BLK1"


class PyLedger:
    def __init__(self, client_num: int, comm_count: int, aggregate_count: int,
                 needed_update_count: int, genesis_epoch: int = -999,
                 reduce_blocks: int = 1):
        self.client_num = client_num
        self.comm_count = comm_count
        self.aggregate_count = aggregate_count
        self.needed_update_count = needed_update_count
        self.genesis_epoch = genesis_epoch
        # REDUCTION SPEC v2's block count (ledger.base.reduce_blocks): a
        # genome constant, never state.  With B > 1 every commit op
        # carries the claim, and a claim that disagrees is BAD_ARG, so a
        # writer lying about its geometry dies at every honest replica.
        self.reduce_blocks = max(int(reduce_blocks), 1)

        self._epoch = genesis_epoch
        self._model_hash = b"\0" * 32
        self._last_loss = 0.0
        self._reg_order: List[str] = []
        self._roles: Dict[str, str] = {}
        self._updates: List[UpdateInfo] = []
        self._update_slot: Dict[str, int] = {}
        self._scores: Dict[str, List[float]] = {}
        self._pending: Optional[PendingInfo] = None
        self._closed = False
        self._generation = 0
        self._writer_index = 0
        self._ops: List[bytes] = []
        self._log: List[bytes] = []
        self._wal = None
        self._wal_path = ""
        # compaction: ops[0.._base) were garbage-collected behind a
        # certified snapshot; _base_head is the chain head at that offset
        # (after the snapshot op) and _base_state the canonical state the
        # prefix reduced to, kept for clone_prefix and the BFLCWAL2 header
        self._base = 0
        self._base_head = b""
        self._base_state: Optional[bytes] = None

    # --- log plumbing (matches the reference's append_log) ---
    def _append_log(self, op: bytes) -> None:
        h = hashlib.sha256()
        if self._log:
            h.update(self._log[-1])
        elif self._base:
            h.update(self._base_head)
        h.update(op)
        self._ops.append(op)
        self._log.append(h.digest())
        if self._wal is not None:
            # a failed write detaches the journal: the state machine keeps
            # serving, observably un-journaled
            try:
                self._wal.write(struct.pack("<Q", len(op)) + op)
                self._wal.flush()
            except OSError:
                self.detach_wal()

    # --- write-ahead log (the reference's BFLCWAL1 format) ---
    _WAL_MAGIC = b"BFLCWAL1"
    # the compacted journal: magic, <q> base, the 32-byte base head, <q>
    # state length and the canonical state bytes, then the tail records
    # in BFLCWAL1 framing — replayable without the GC'd prefix
    _WAL2_MAGIC = b"BFLCWAL2"

    def attach_wal(self, path: str) -> bool:
        """Journal to `path`: the ops so far, then every later one."""
        self.detach_wal()
        try:
            f = open(path, "wb")
        except OSError:
            return False
        self._write_wal_body(f)
        self._wal = f
        self._wal_path = path
        return True

    def _write_wal_body(self, f) -> None:
        """The journal's bytes: the header (BFLCWAL1, or BFLCWAL2 with
        the snapshot base once compacted), then the retained records."""
        self._write_wal_head(f)
        for op in self._ops:
            f.write(struct.pack("<Q", len(op)) + op)
        f.flush()

    def save_wal(self, path: str) -> None:
        """One-shot journal write to `path`, tmp-then-rename, without
        attaching.  Raises OSError with `path` untouched."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            self._write_wal_body(f)
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _write_wal_head(self, f) -> None:
        if not self._base:
            f.write(self._WAL_MAGIC)
            return
        if self._base_state is None:
            raise RuntimeError("compacted ledger without base state bytes "
                               "cannot journal a self-contained WAL")
        f.write(self._WAL2_MAGIC)
        f.write(struct.pack("<q", self._base))
        f.write(self._base_head)
        f.write(struct.pack("<q", len(self._base_state)))
        f.write(self._base_state)

    def detach_wal(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
            self._wal_path = ""

    def compact_wal(self) -> bool:
        """Rewrite the attached WAL as a BFLCWAL2 file (snapshot header
        and tail records), tmp-then-rename, so a crash leaves the whole
        old journal or the whole compacted one.  False, with the journal
        unchanged, when no WAL is attached or the rewrite failed."""
        if self._wal is None or not self._wal_path:
            return False
        path, tmp = self._wal_path, self._wal_path + ".tmp"
        new = None
        try:
            with open(tmp, "wb") as f:
                self._write_wal_body(f)
                os.fsync(f.fileno())
            # reopen before the rename: the append handle follows the
            # inode, so once the rename lands later appends go to the
            # compacted file (a reopen failing after it would journal to
            # the old, unlinked inode)
            new = open(tmp, "ab")
            os.replace(tmp, path)
        except OSError:
            if new is not None:
                new.close()
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        self._wal.close()
        self._wal = new
        return True

    def replay_wal(self, path: str) -> int:
        """Apply every record of the journal at `path`; returns how many.
        A torn trailing record ends the replay; an op the state machine
        refuses raises ValueError."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise ValueError(
                f"not a bflc WAL (or unreadable): {path}") from e
        if blob.startswith(self._WAL2_MAGIC):
            off = self._replay_wal2_head(blob, path)
        elif blob.startswith(self._WAL_MAGIC):
            off = len(self._WAL_MAGIC)
        else:
            raise ValueError(f"not a bflc WAL (or unreadable): {path}")
        applied = 0
        while off + 8 <= len(blob):
            (n,) = struct.unpack_from("<Q", blob, off)
            if n > (1 << 26) or off + 8 + n > len(blob):
                break                      # torn/corrupt trailing record
            op = blob[off + 8:off + 8 + n]
            off += 8 + n
            if self.apply_op(op) != LedgerStatus.OK:
                raise ValueError(f"WAL replay rejected op {applied}: {path}")
            applied += 1
        return applied

    def _replay_wal2_head(self, blob: bytes, path: str) -> int:
        """Install a compacted WAL's snapshot header into this fresh
        ledger; the offset of the first tail record.  A torn header
        refuses the whole file."""
        if self.log_size() or self._epoch != self.genesis_epoch:
            raise ValueError(
                f"compacted WAL replays only into a fresh ledger: {path}")
        off = len(self._WAL2_MAGIC)
        if off + 8 + 32 + 8 > len(blob):
            raise ValueError(f"torn compacted-WAL header: {path}")
        (base,) = struct.unpack_from("<q", blob, off)
        base_head = blob[off + 8:off + 40]
        (n_state,) = struct.unpack_from("<q", blob, off + 40)
        off += 48
        if base < 0 or n_state < 0 or off + n_state > len(blob):
            raise ValueError(f"torn compacted-WAL header: {path}")
        try:
            self._install_state(blob[off:off + n_state], base, base_head)
        except ValueError as e:
            raise ValueError(f"corrupt compacted-WAL snapshot state: "
                             f"{path}: {e}") from e
        return off + n_state

    # --- protocol surface ---
    def register_node(self, addr: str) -> LedgerStatus:
        if not addr:
            return LedgerStatus.BAD_ARG
        if addr in self._roles:
            return LedgerStatus.ALREADY_REGISTERED
        self._roles[addr] = "trainer"
        self._reg_order.append(addr)
        self._append_log(encode_register_op(addr))
        if (len(self._reg_order) == self.client_num
                and self._epoch == self.genesis_epoch):
            for a in self._reg_order[: self.comm_count]:
                self._roles[a] = "comm"
            self._epoch = 0
        return LedgerStatus.OK

    def query_state(self, addr: str) -> Tuple[str, int]:
        return self._roles.get(addr, "trainer"), self._epoch

    def query_global_model(self) -> Tuple[bytes, int]:
        return self._model_hash, self._epoch

    def upload_local_update(self, sender: str, payload_hash: bytes,
                            n_samples: int, avg_cost: float,
                            epoch: int) -> LedgerStatus:
        if not sender or n_samples <= 0:
            return LedgerStatus.BAD_ARG
        if self._epoch == self.genesis_epoch:
            return LedgerStatus.NOT_STARTED
        if epoch != self._epoch:
            return LedgerStatus.WRONG_EPOCH
        if sender in self._update_slot:
            return LedgerStatus.DUPLICATE
        # the update set freezes once scoring can begin
        if self._closed or self._scores:
            return LedgerStatus.CAP_REACHED
        if len(self._updates) >= self.needed_update_count:
            return LedgerStatus.CAP_REACHED
        self._update_slot[sender] = len(self._updates)
        self._updates.append(UpdateInfo(sender, bytes(payload_hash),
                                        n_samples, float(avg_cost)))
        self._append_log(encode_upload_op(sender, payload_hash, n_samples,
                                          avg_cost, epoch))
        return LedgerStatus.OK

    def upload_scores(self, sender: str, epoch: int,
                      scores: Sequence[float]) -> LedgerStatus:
        if not sender:
            return LedgerStatus.BAD_ARG
        if self._epoch == self.genesis_epoch:
            return LedgerStatus.NOT_STARTED
        if epoch != self._epoch:
            return LedgerStatus.WRONG_EPOCH
        if self._roles.get(sender) != "comm":
            return LedgerStatus.NOT_COMMITTEE
        if len(scores) != len(self._updates):
            return LedgerStatus.BAD_ARG
        # non-finite scores never enter the log: checked after float32
        # conversion — a finite float64 can overflow to inf in f32
        with np.errstate(over="ignore"):
            vals = [float(np.float32(s)) for s in scores]
        if any(not math.isfinite(v) for v in vals):
            return LedgerStatus.BAD_ARG
        if len(self._updates) < self.needed_update_count and \
                not self._closed:
            return LedgerStatus.NOT_READY
        if self._pending is not None:
            return LedgerStatus.NOT_READY
        self._scores[sender] = vals
        self._append_log(encode_scores_op(sender, epoch, scores))
        self._maybe_fire()
        return LedgerStatus.OK

    def _maybe_fire(self) -> None:
        """Fire when every CURRENT committee member's row is in."""
        comm_now = sum(1 for r in self._roles.values() if r == "comm")
        present = sum(1 for a in self._scores
                      if self._roles.get(a) == "comm")
        if present == comm_now and comm_now > 0:
            self._finish_scoring()

    # --- stall recovery (no reference-protocol equivalent: it stalls) ---
    def close_round(self) -> LedgerStatus:
        """Close an under-filled round so scoring proceeds with the
        updates present (dead trainers)."""
        if self._epoch == self.genesis_epoch:
            return LedgerStatus.NOT_STARTED
        if self._closed or self._pending is not None:
            return LedgerStatus.NOT_READY
        if not self._updates or \
                len(self._updates) >= self.needed_update_count:
            return LedgerStatus.NOT_READY
        self._closed = True
        self._append_log(encode_close_op(self._epoch))
        return LedgerStatus.OK

    def force_aggregate(self) -> LedgerStatus:
        """Finish scoring with the committee rows present (a dead
        committee member)."""
        if self._epoch == self.genesis_epoch:
            return LedgerStatus.NOT_STARTED
        if self._pending is not None or not self._scores:
            return LedgerStatus.NOT_READY
        self._append_log(encode_force_op(self._epoch))
        self._finish_scoring()
        return LedgerStatus.OK

    def reseat_committee(self, addrs: Sequence[str]) -> LedgerStatus:
        """Mid-round committee re-election (a dead committee)."""
        if self._epoch == self.genesis_epoch:
            return LedgerStatus.NOT_STARTED
        if self._pending is not None:
            return LedgerStatus.NOT_READY
        if not addrs or len(addrs) > self.comm_count:
            return LedgerStatus.BAD_ARG
        if any(a not in self._roles for a in addrs):
            return LedgerStatus.BAD_ARG
        for a in self._roles:
            self._roles[a] = "trainer"
        for a in addrs:
            self._roles[a] = "comm"
        self._append_log(encode_reseat_op(self._epoch, addrs))
        self._maybe_fire()
        return LedgerStatus.OK

    @property
    def round_closed(self) -> bool:
        return self._closed

    # --- writer fencing (the split-brain defense) ---
    def promote_writer(self, generation: int,
                       writer_index: int) -> LedgerStatus:
        """Record a writer promotion in the chain.  The fence advances by
        exactly one per promotion; valid at any epoch, genesis included."""
        if generation != self._generation + 1 or writer_index < 0:
            return LedgerStatus.BAD_ARG
        self._generation = generation
        self._writer_index = writer_index
        self._append_log(encode_promote_op(generation, writer_index))
        return LedgerStatus.OK

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def writer_index(self) -> int:
        return self._writer_index

    def _finish_scoring(self) -> None:
        k = len(self._updates)
        # scorer rows in address order (bytewise == sorted() for ASCII)
        rows = [self._scores[a] for a in sorted(self._scores)
                if len(self._scores[a]) == k]
        if not rows:
            medians = np.zeros(k, np.float32)
        else:
            cols = np.asarray(rows, np.float32)          # (C, k)
            srt = np.sort(cols, axis=0)
            n = cols.shape[0]
            medians = 0.5 * (srt[(n - 1) // 2] + srt[n // 2])
        order = sorted(range(k), key=lambda s: (-medians[s], s))
        take = min(self.aggregate_count, k)
        selected = order[:take]
        loss = (sum(self._updates[s].avg_cost for s in selected) / take
                if take else 0.0)
        self._pending = PendingInfo(medians=medians.astype(np.float32),
                                    order=order, selected=selected,
                                    global_loss=float(np.float32(loss)))

    def query_all_updates(self) -> List[UpdateInfo]:
        if len(self._updates) < self.needed_update_count and \
                not self._closed:
            return []
        return list(self._updates)

    # --- aggregation handshake ---
    def aggregate_ready(self) -> bool:
        return self._pending is not None

    def pending(self) -> Optional[PendingInfo]:
        return self._pending

    def commit_model(self, new_model_hash: bytes, epoch: int,
                     blocks=_DERIVE_BLOCKS) -> LedgerStatus:
        """Commit the aggregated model.  `blocks` is the geometry claim:
        the writer leaves the default ("derive it from the genome"), the
        replay passes the op's claim (None for a v1 40-byte body).  A
        claim that disagrees with this replica's genome is BAD_ARG
        before any state changes."""
        if self._pending is None:
            return LedgerStatus.NOT_READY
        if epoch != self._epoch:
            return LedgerStatus.WRONG_EPOCH
        derived_blocks = (self.reduce_blocks
                          if self.reduce_blocks > 1 else None)
        if blocks is not _DERIVE_BLOCKS and blocks != derived_blocks:
            return LedgerStatus.BAD_ARG
        self._model_hash = bytes(new_model_hash)
        self._last_loss = self._pending.global_loss
        for a in self._roles:
            self._roles[a] = "trainer"
        for s in self._pending.order[: self.comm_count]:
            self._roles[self._updates[s].sender] = "comm"
        self._updates = []
        self._update_slot = {}
        self._scores = {}
        self._pending = None
        self._closed = False
        self._epoch += 1
        op = encode_commit_op(new_model_hash, epoch)
        if derived_blocks is not None:
            # the claim rides the certified op (v1 chains: no tail)
            op += _BLOCKS_MAGIC + struct.pack("<q", derived_blocks)
        self._append_log(op)
        return LedgerStatus.OK

    # --- inspection ---
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def num_registered(self) -> int:
        return len(self._roles)

    @property
    def last_disagreement(self) -> float:
        return 0.0

    @property
    def update_count(self) -> int:
        return len(self._updates)

    @property
    def score_count(self) -> int:
        return len(self._scores)

    @property
    def last_global_loss(self) -> float:
        return self._last_loss

    def committee(self) -> List[str]:
        return [a for a in self._reg_order if self._roles.get(a) == "comm"]

    # --- op log (positions are absolute; the GC'd prefix counts) ---
    def log_size(self) -> int:
        return self._base + len(self._log)

    def log_head(self) -> bytes:
        if self._log:
            return self._log[-1]
        return self._base_head if self._base else b"\0" * 32

    def verify_log(self) -> bool:
        prev = self._base_head if self._base else b""
        for op, dig in zip(self._ops, self._log):
            h = hashlib.sha256()
            if prev:
                h.update(prev)
            h.update(op)
            prev = h.digest()
            if prev != dig:
                return False
        return True

    def log_op(self, i: int) -> bytes:
        j = i - self._base
        if j < 0:
            raise IndexError(
                f"op {i} was garbage-collected (log base {self._base})")
        return self._ops[j]

    def head_at(self, upto: int) -> bytes:
        """Chain head after ops[0..upto) — b"" at upto == 0.  Raises
        ValueError below the GC base: those heads went with the prefix."""
        if upto < self._base:
            raise ValueError(f"chain head at {upto} was garbage-collected "
                             f"(log base {self._base})")
        if upto == self._base:
            return self._base_head if self._base else b""
        return self._log[upto - self._base - 1]

    # --- compaction (ledger/snapshot.py) ---
    @property
    def log_base(self) -> int:
        """The first chain position whose op bytes this ledger holds."""
        return self._base

    def encode_state(self) -> bytes:
        """Canonical bytes of the current protocol state (the snapshot
        payload, `ledger/snapshot.py`'s layout)."""
        from bflc_demo_tpu_torch.ledger.snapshot import encode_state_dict
        pend = None
        if self._pending is not None:
            pend = ([float(v) for v in self._pending.medians],
                    list(self._pending.order),
                    list(self._pending.selected),
                    self._pending.global_loss)
        return encode_state_dict({
            "epoch": self._epoch, "model_hash": self._model_hash,
            "last_loss": self._last_loss,
            "generation": self._generation,
            "writer_index": self._writer_index, "closed": self._closed,
            "reg_order": self._reg_order, "roles": self._roles,
            "updates": [(u.sender, u.payload_hash, u.n_samples,
                         u.avg_cost) for u in self._updates],
            "scores": self._scores, "pending": pend})

    def state_digest(self) -> bytes:
        """SHA-256 of the canonical state: what a snapshot op embeds and
        every replica re-derives."""
        return hashlib.sha256(self.encode_state()).digest()

    def _install_state(self, state_bytes: bytes, base: int,
                       base_head: bytes) -> None:
        """Install canonical state at chain offset `base` (snapshot
        restore and BFLCWAL2 replay; the caller verified the bytes)."""
        from bflc_demo_tpu_torch.ledger.snapshot import (
            decode_state, refuse_unported_tails)
        d = decode_state(state_bytes)
        refuse_unported_tails(d)
        self._epoch = int(d["epoch"])
        self._model_hash = bytes(d["model_hash"])
        self._last_loss = float(d["last_loss"])
        self._generation = int(d["generation"])
        self._writer_index = int(d["writer_index"])
        self._closed = bool(d["closed"])
        self._reg_order = list(d["reg_order"])
        self._roles = dict(d["roles"])
        self._updates = [UpdateInfo(s, bytes(ph), int(n), float(c))
                         for s, ph, n, c in d["updates"]]
        self._update_slot = {u.sender: i
                             for i, u in enumerate(self._updates)}
        self._scores = {k: list(v) for k, v in d["scores"].items()}
        pend = d.get("pending")
        if pend is None:
            self._pending = None
        else:
            medians, order, selected, loss = pend
            self._pending = PendingInfo(
                medians=np.asarray(medians, np.float32),
                order=list(order), selected=list(selected),
                global_loss=float(np.float32(loss)))
        self._ops = []
        self._log = []
        self._base = int(base)
        self._base_head = bytes(base_head)
        self._base_state = bytes(state_bytes)

    def gc_prefix(self, upto: int,
                  state_bytes: Optional[bytes] = None) -> int:
        """Drop ops[_base..upto): garbage behind a certified snapshot at
        `upto` (the position after the snapshot op).  `state_bytes` is
        the snapshot's canonical state; omitted, upto must be log_size
        and the current state is encoded.  Compacts the attached WAL in
        the same step.  Returns the number of ops dropped."""
        if not self._base <= upto <= self.log_size():
            raise ValueError(f"gc_prefix({upto}) outside [{self._base}, "
                             f"{self.log_size()}]")
        if state_bytes is None:
            if upto != self.log_size():
                raise ValueError("gc_prefix mid-chain needs the snapshot's "
                                 "state bytes at that position")
            state_bytes = self.encode_state()
        dropped = upto - self._base
        if dropped == 0:
            return 0
        new_head = self.head_at(upto)
        del self._ops[:dropped]
        del self._log[:dropped]
        self._base = upto
        self._base_head = new_head
        self._base_state = bytes(state_bytes)
        if self._wal is not None:
            self.compact_wal()
        return dropped

    # --- validate-without-apply (the BFT validator's probe) ---
    def _snapshot(self):
        """A cheap copy of every mutable field apply_op can touch."""
        return (self._epoch, self._model_hash, self._last_loss,
                list(self._reg_order), dict(self._roles),
                list(self._updates), dict(self._update_slot),
                {k: list(v) for k, v in self._scores.items()},
                self._pending, self._closed, self._generation,
                self._writer_index, len(self._ops))

    def _restore(self, snap) -> None:
        (self._epoch, self._model_hash, self._last_loss, self._reg_order,
         self._roles, self._updates, self._update_slot, self._scores,
         self._pending, self._closed, self._generation,
         self._writer_index, n_ops) = snap
        del self._ops[n_ops:]
        del self._log[n_ops:]

    def validate_op(self, op: bytes) -> LedgerStatus:
        """Would `apply_op(op)` succeed here?  Runs it and restores the
        state, with the WAL detached for the probe, so nothing changes
        and nothing is journaled either way."""
        snap = self._snapshot()
        wal, self._wal = self._wal, None
        try:
            return self.apply_op(op)
        finally:
            self._restore(snap)
            self._wal = wal

    # --- replay (the replica path) ---
    def apply_op(self, op: bytes) -> LedgerStatus:
        """Deterministic replay of a serialized op, opcodes 1-9; every
        other opcode (and a malformed body) is BAD_ARG."""
        if not op:
            return LedgerStatus.BAD_ARG
        code, body = op[0], op[1:]

        def _str_at(off: int):
            # bounds-checked, as the reference's (a length past the
            # buffer is a malformed op, never a truncated slice)
            (n,) = struct.unpack_from("<q", body, off)
            if n < 0 or off + 8 + n > len(body):
                raise IndexError("string past end of op")
            return body[off + 8:off + 8 + n].decode(), off + 8 + n

        try:
            if code == OP_REGISTER:
                addr, _ = _str_at(0)
                return self.register_node(addr)
            if code == OP_UPLOAD:
                sender, off = _str_at(0)
                payload = body[off:off + 32]
                ns, = struct.unpack_from("<q", body, off + 32)
                cost, = struct.unpack_from("<f", body, off + 40)
                ep, = struct.unpack_from("<q", body, off + 44)
                return self.upload_local_update(sender, payload, ns, cost,
                                                ep)
            if code == OP_SCORES:
                sender, off = _str_at(0)
                ep, = struct.unpack_from("<q", body, off)
                cnt, = struct.unpack_from("<q", body, off + 8)
                if cnt < 0 or off + 16 + 4 * cnt > len(body):
                    return LedgerStatus.BAD_ARG
                scores = list(struct.unpack_from(f"<{cnt}f", body, off + 16))
                return self.upload_scores(sender, ep, scores)
            if code == OP_COMMIT:
                # 40 bytes (v1), or 40 + the tagged 12-byte geometry
                # claim (v2); anything else is malformed
                if len(body) == 40:
                    claim = None
                elif len(body) == 52 and body[40:44] == _BLOCKS_MAGIC:
                    claim, = struct.unpack_from("<q", body, 44)
                else:
                    return LedgerStatus.BAD_ARG
                ep, = struct.unpack_from("<q", body, 32)
                return self.commit_model(body[:32], ep, blocks=claim)
            if code in (OP_CLOSE, OP_FORCE):
                ep, = struct.unpack_from("<q", body, 0)
                if ep != self._epoch:
                    return LedgerStatus.BAD_ARG
                return (self.close_round() if code == OP_CLOSE
                        else self.force_aggregate())
            if code == OP_RESEAT:
                ep, = struct.unpack_from("<q", body, 0)
                n, = struct.unpack_from("<q", body, 8)
                if ep != self._epoch or n <= 0 or \
                        n > (len(body) - 16) // 8:
                    return LedgerStatus.BAD_ARG
                off = 16
                addrs = []
                for _ in range(n):
                    a, off = _str_at(off)
                    addrs.append(a)
                return self.reseat_committee(addrs)
            if code == OP_PROMOTE:
                gen, idx = struct.unpack_from("<qq", body, 0)
                return self.promote_writer(gen, idx)
            if code == OP_SNAPSHOT:
                # the replica re-derives the digest from its own state: a
                # validator's co-signature is its independent proof, and a
                # lying writer's snapshot binds on no honest replica
                if len(body) != 40:
                    return LedgerStatus.BAD_ARG
                ep, = struct.unpack_from("<q", body, 0)
                if ep != self._epoch or body[8:40] != self.state_digest():
                    return LedgerStatus.BAD_ARG
                self._append_log(op)
                return LedgerStatus.OK
        except (struct.error, UnicodeDecodeError, IndexError):
            return LedgerStatus.BAD_ARG
        return LedgerStatus.BAD_ARG
