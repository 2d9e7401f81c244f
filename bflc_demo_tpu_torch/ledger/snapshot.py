"""Certified snapshots: canonical ledger-state bytes and artifact files.

Copy of `bflc_demo_tpu/ledger/snapshot.py`.  Without compaction the op log
grows without bound and a replica that joins late replays from genesis.
Raft's log compaction gives the shape this module implements for the
committee ledger:

- the **canonical state encoding** (`encode_state_dict` / `decode_state`,
  layout `BFLCSNST1`): epoch, model hash, roles in registration order,
  the update set, score rows in address order, the pending aggregate and
  the writer fence, serialized deterministically — the reference's bytes,
  so both packages derive the same state digest from the same history;
- the **snapshot op** (opcode 9): `[9][epoch <q>][state_digest 32]`,
  appended to the hash chain like any mutation.  A replica applying it
  re-derives the digest from its own state and refuses a mismatch, so a
  BFT quorum's co-signature is each validator's independent
  re-derivation.  Once the op is certified, everything before it can be
  garbage-collected (`PyLedger.gc_prefix`);
- the **artifact file** (`BFLCSNAPF1`, written tmp-then-rename; a torn
  or bit-flipped file is refused): the state bytes, the model blob, the
  op, its certificate and the chain head before it — what a rejoining
  replica verifies (`verify_snapshot_meta`) and installs
  (`restore_snapshot`).

`BFLC_SNAPSHOT_LEGACY=1` (or `snapshot_interval=0`, the default) keeps
every snapshot op off the chain.

The state bytes carry the asynchronous buffered-aggregation tails
(reference :124-153, :296-330): `async` (the admission counter, the
buffered entries and their committee scores), emitted only when the mode
is armed, and `async_acommits` (the drain counter), emitted only when
re-election is armed.  A synchronous ledger keeps the legacy bytes.

Not ported: the closed-loop genome tail (ROADMAP A9 (rederive): the
port's ledger does not run the closed loop).  `decode_state` reads it
byte for byte; `encode_state_dict` and `restore_snapshot` raise naming
the item for a state that carries it.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as _np

STATE_MAGIC = b"BFLCSNST1"          # canonical state encoding, version 1
FILE_MAGIC = b"BFLCSNAPF1"          # on-disk snapshot artifact, version 1
OP_SNAPSHOT = 9                     # ledger op codec (ledger/base)

_EMPTY_HEAD = b"\0" * 32

# magic tag introducing the closed-loop (genome) state tail.  The tail
# is always exactly 28 bytes and always LAST, so the parser can test
# "exactly 28 bytes remain and they start with the tag" — an async
# tail's leading <q aseq_next> can never satisfy both (its minimal
# section is 24 bytes and any extension crosses 28).
_GENOME_MAGIC = b"GNM1"
_GENOME_TAIL_LEN = 4 + 4 + 8 + 8 + 4


def _put_str(b: bytearray, s: str) -> None:
    raw = s.encode()
    b += struct.pack("<q", len(raw)) + raw


_UNPORTED_TAILS = {"genome": "A9 (rederive)"}


def refuse_unported_tails(d: Dict) -> None:
    """Raise naming the ROADMAP item of every state tail the port's
    ledger cannot hold (the genome section)."""
    asked = sorted(k for k in _UNPORTED_TAILS if d.get(k) is not None)
    if asked:
        raise NotImplementedError(
            "snapshot state tails not ported yet: " + ", ".join(
                f"{k} (ROADMAP {_UNPORTED_TAILS[k]})" for k in asked))


def encode_state_dict(d: Dict) -> bytes:
    """Canonical bytes of a ledger-state dict (see `decode_state` for the
    field set), the reference's layout: registration order carries the
    roles, score rows sort by sender (bytewise == sorted() for ASCII
    addresses), floats are f32, counts are <q>, slots are <i>; the async
    tails follow when present.  A dict carrying a genome tail raises
    (not ported)."""
    refuse_unported_tails(d)
    b = bytearray(STATE_MAGIC)
    b += struct.pack("<q", int(d["epoch"]))
    mh = bytes(d["model_hash"])
    if len(mh) != 32:
        raise ValueError(f"model_hash must be 32 bytes, got {len(mh)}")
    b += mh
    b += struct.pack("<f", _np.float32(d["last_loss"]))
    b += struct.pack("<q", int(d["generation"]))
    b += struct.pack("<q", int(d["writer_index"]))
    b += struct.pack("<B", 1 if d["closed"] else 0)
    reg = list(d["reg_order"])
    roles = dict(d["roles"])
    b += struct.pack("<q", len(reg))
    for addr in reg:
        _put_str(b, addr)
        b += struct.pack("<B", 1 if roles.get(addr) == "comm" else 0)
    updates = list(d["updates"])        # (sender, hash32, n, cost)
    b += struct.pack("<q", len(updates))
    for sender, ph, n, cost in updates:
        _put_str(b, sender)
        ph = bytes(ph)
        if len(ph) != 32:
            raise ValueError("update payload_hash must be 32 bytes")
        b += ph
        b += struct.pack("<q", int(n))
        b += struct.pack("<f", _np.float32(cost))
    scores = dict(d["scores"])
    b += struct.pack("<q", len(scores))
    for sender in sorted(scores):
        row = scores[sender]
        _put_str(b, sender)
        b += struct.pack("<q", len(row))
        for v in row:
            b += struct.pack("<f", _np.float32(v))
    pending = d.get("pending")
    if pending is None:
        b += struct.pack("<B", 0)
    else:
        medians, order, selected, loss = pending
        b += struct.pack("<B", 1)
        b += struct.pack("<q", len(medians))
        for v in medians:
            b += struct.pack("<f", _np.float32(v))
        b += struct.pack("<q", len(order))
        for s in order:
            b += struct.pack("<i", int(s))
        b += struct.pack("<q", len(selected))
        for s in selected:
            b += struct.pack("<i", int(s))
        b += struct.pack("<f", _np.float32(loss))
    asy = d.get("async")
    if asy is not None:
        aseq_next, entries, rows = asy
        b += struct.pack("<q", int(aseq_next))
        b += struct.pack("<q", len(entries))
        for aseq, sender, ph, n, cost, base_ep, stale in entries:
            b += struct.pack("<q", int(aseq))
            _put_str(b, sender)
            ph = bytes(ph)
            if len(ph) != 32:
                raise ValueError("async payload_hash must be 32 bytes")
            b += ph
            b += struct.pack("<q", int(n))
            b += struct.pack("<f", _np.float32(cost))
            b += struct.pack("<q", int(base_ep))
            b += struct.pack("<q", int(stale))
        b += struct.pack("<q", len(rows))
        for aseq in sorted(rows):
            b += struct.pack("<q", int(aseq))
            row = rows[aseq]
            b += struct.pack("<q", len(row))
            for scorer in sorted(row):
                _put_str(b, scorer)
                b += struct.pack("<f", _np.float32(row[scorer]))
    acommits = d.get("async_acommits")
    if acommits is not None:
        if asy is None:
            raise ValueError(
                "async_acommits tail requires the async tail")
        b += struct.pack("<q", int(acommits))
    return bytes(b)


def decode_state(blob: bytes) -> Dict:
    """Inverse of `encode_state_dict`; raises ValueError on malformed or
    truncated bytes (a torn snapshot must refuse, never half-install)."""
    if not blob.startswith(STATE_MAGIC):
        raise ValueError("not a bflc snapshot state blob")
    off = len(STATE_MAGIC)

    def need(n: int) -> None:
        if off + n > len(blob):
            raise ValueError("snapshot state truncated")

    def rd_q() -> int:
        nonlocal off
        need(8)
        (v,) = struct.unpack_from("<q", blob, off)
        off += 8
        return v

    def rd_f() -> float:
        nonlocal off
        need(4)
        (v,) = struct.unpack_from("<f", blob, off)
        off += 4
        return float(v)

    def rd_i() -> int:
        nonlocal off
        need(4)
        (v,) = struct.unpack_from("<i", blob, off)
        off += 4
        return v

    def rd_b() -> int:
        nonlocal off
        need(1)
        v = blob[off]
        off += 1
        return v

    def rd_bytes(n: int) -> bytes:
        nonlocal off
        need(n)
        v = blob[off:off + n]
        off += n
        return v

    def rd_str() -> str:
        n = rd_q()
        if n < 0 or n > len(blob):
            raise ValueError("snapshot state: bad string length")
        return rd_bytes(n).decode()

    d: Dict = {"epoch": rd_q(), "model_hash": rd_bytes(32),
               "last_loss": rd_f(), "generation": rd_q(),
               "writer_index": rd_q(), "closed": bool(rd_b())}
    n_reg = rd_q()
    if not 0 <= n_reg <= len(blob):
        raise ValueError("snapshot state: bad registration count")
    reg, roles = [], {}
    for _ in range(n_reg):
        addr = rd_str()
        reg.append(addr)
        roles[addr] = "comm" if rd_b() else "trainer"
    d["reg_order"], d["roles"] = reg, roles
    n_up = rd_q()
    if not 0 <= n_up <= len(blob):
        raise ValueError("snapshot state: bad update count")
    d["updates"] = [(rd_str(), rd_bytes(32), rd_q(), rd_f())
                    for _ in range(n_up)]
    n_sc = rd_q()
    if not 0 <= n_sc <= len(blob):
        raise ValueError("snapshot state: bad score-row count")
    scores = {}
    for _ in range(n_sc):
        sender = rd_str()
        ln = rd_q()
        if not 0 <= ln <= len(blob):
            raise ValueError("snapshot state: bad score-row length")
        scores[sender] = [rd_f() for _ in range(ln)]
    d["scores"] = scores
    if rd_b():
        k = rd_q()
        if not 0 <= k <= len(blob):
            raise ValueError("snapshot state: bad pending size")
        medians = [rd_f() for _ in range(k)]
        n_ord = rd_q()
        if not 0 <= n_ord <= len(blob):
            raise ValueError("snapshot state: bad order size")
        order = [rd_i() for _ in range(n_ord)]
        n_sel = rd_q()
        if not 0 <= n_sel <= len(blob):
            raise ValueError("snapshot state: bad selection size")
        selected = [rd_i() for _ in range(n_sel)]
        d["pending"] = (medians, order, selected, rd_f())
    else:
        d["pending"] = None
    d["async"] = None                   # legacy / synchronous layout
    d["async_acommits"] = None
    d["genome"] = None

    def genome_next() -> bool:
        return (len(blob) - off == _GENOME_TAIL_LEN
                and blob[off:off + 4] == _GENOME_MAGIC)

    def rd_genome() -> None:
        nonlocal off
        off += 4
        dens = rd_f()
        stale = rd_q()
        gep = rd_q()
        d["genome"] = (dens, stale, gep, rd_f())

    if off == len(blob):
        return d
    if genome_next():                   # sync chain, adaptive armed
        rd_genome()
        return d
    # async buffered-aggregation tail (present iff the emitting ledger
    # ran with async_buffer > 0)
    aseq_next = rd_q()
    n_ab = rd_q()
    if not 0 <= n_ab <= len(blob):
        raise ValueError("snapshot state: bad async buffer count")
    entries = []
    for _ in range(n_ab):
        aseq = rd_q()
        sender = rd_str()
        ph = rd_bytes(32)
        entries.append((aseq, sender, ph, rd_q(), rd_f(), rd_q(),
                        rd_q()))
    n_rows = rd_q()
    if not 0 <= n_rows <= len(blob):
        raise ValueError("snapshot state: bad async score-row count")
    rows = {}
    for _ in range(n_rows):
        aseq = rd_q()
        ln = rd_q()
        if not 0 <= ln <= len(blob):
            raise ValueError("snapshot state: bad async score-row "
                             "length")
        rows[aseq] = {rd_str(): rd_f() for _ in range(ln)}
    d["async"] = (aseq_next, entries, rows)
    # optional re-election tail: the acommit counter (present iff the
    # emitting ledger ran with async_reseat_every > 0) — the genome
    # tail's magic + fixed length disambiguates it from a counter
    if off != len(blob) and not genome_next():
        d["async_acommits"] = rd_q()
    if off != len(blob) and genome_next():
        rd_genome()
    if off != len(blob):
        raise ValueError(f"snapshot state: {len(blob) - off} trailing "
                         f"bytes")
    return d


def make_snapshot_op(ledger) -> bytes:
    """The snapshot op for `ledger`'s CURRENT state: the emitting writer
    self-applies this (apply re-derives the digest, so self-application
    is the same check every replica runs)."""
    op = bytearray([OP_SNAPSHOT])
    op += struct.pack("<q", ledger.epoch)
    op += ledger.state_digest()
    return bytes(op)


def parse_snapshot_op(op: bytes):
    """(epoch, state_digest) of a snapshot op, or None when `op` is not
    a well-formed snapshot op."""
    if len(op) != 1 + 8 + 32 or op[0] != OP_SNAPSHOT:
        return None
    (epoch,) = struct.unpack_from("<q", op, 1)
    return epoch, op[9:41]


def restore_snapshot(state_bytes: bytes, cfg, base: int, base_head: bytes):
    """Fresh python-backend ledger installed from canonical state bytes,
    positioned at chain offset `base` with head `base_head` (the head
    AFTER the certified snapshot op).  The installer's trust argument is
    the caller's (`verify_snapshot_meta`): this only decodes + installs,
    raising ValueError on malformed bytes."""
    from bflc_demo_tpu_torch.ledger import make_ledger
    refuse_unported_tails(decode_state(state_bytes))
    led = make_ledger(cfg, backend="python")
    led._install_state(state_bytes, base, base_head)
    return led


def verify_snapshot_meta(meta: Dict, *, bft_quorum: int = 0,
                         bft_keys: Optional[Dict[int, bytes]] = None,
                         min_generation: int = 0) -> str:
    """'' when a snapshot offer is installable; a reason string otherwise.

    meta: {"i": chain position of the snapshot op, "op": op bytes/hex,
    "prev_head": head before the op (hex), "state": canonical state
    bytes, "model": model blob bytes, "cert": commit-certificate wire
    dict or None, "gen": writer generation, "epoch": int}.

    Checks, in trust order:
    - the op parses as a snapshot op and its embedded digest equals
      sha256(state) — a torn or bit-flipped state blob refuses here;
    - the state decodes and its model hash equals sha256(model) — a
      corrupt model blob refuses here;
    - with validator keys provisioned, the commit certificate must bind
      exactly (i, prev_head, op) with a quorum of authentic signatures —
      this chain-links the snapshot into the certified op stream, so a
      forged or stale certificate (or one lifted from a different
      position) refuses; without keys the hash checks are the
      (documented, weaker) bar, the same trust as uncertified
      replication;
    - the recorded generation must not regress below `min_generation`
      (a replica never syncs backwards across a fence).
    """
    try:
        i = int(meta["i"])
        op = meta["op"]
        if isinstance(op, str):
            op = bytes.fromhex(op)
        prev_head = meta["prev_head"]
        if isinstance(prev_head, str):
            prev_head = bytes.fromhex(prev_head)
        state = bytes(meta["state"])
        # model is optional: a validator installs ledger state only (it
        # holds no blobs); a standby/joiner ALWAYS passes the model blob
        # and gets the hash check
        model = (bytes(meta["model"]) if meta.get("model") is not None
                 else None)
        gen = int(meta.get("gen", 0))
    except (KeyError, TypeError, ValueError) as e:
        return f"malformed snapshot offer: {type(e).__name__}: {e}"
    parsed = parse_snapshot_op(op)
    if parsed is None:
        return "offered op is not a snapshot op"
    _, digest = parsed
    if hashlib.sha256(state).digest() != digest:
        return ("state bytes do not hash to the snapshot op's digest "
                "(torn or corrupt snapshot)")
    try:
        d = decode_state(state)
    except ValueError as e:
        return f"undecodable snapshot state: {e}"
    if model is not None:
        mh = bytes(d["model_hash"])
        if mh == _EMPTY_HEAD:
            # a state that binds no model must not smuggle one in: the
            # quorum certificate covers only the state bytes, so any
            # attached blob here would be unverifiable — refuse rather
            # than install attacker-chosen model bytes
            return ("snapshot state binds no model but the offer "
                    "carries a model blob")
        if hashlib.sha256(model).digest() != mh:
            return "model blob does not hash to the snapshot's model hash"
    if int(d["generation"]) < min_generation or gen < min_generation:
        return (f"snapshot generation {d['generation']} behind ours "
                f"({min_generation}): refusing to sync backwards")
    if bft_keys:
        from bflc_demo_tpu_torch.comm.bft import verify_certificate
        from bflc_demo_tpu_torch.protocol.types import CommitCertificate
        cert_wire = meta.get("cert")
        if not isinstance(cert_wire, dict):
            return "snapshot offer without a commit certificate"
        try:
            cert = CommitCertificate.from_wire(cert_wire)
        except (ValueError, TypeError):
            return "undecodable snapshot certificate"
        if not verify_certificate(cert, index=i, prev_head=prev_head,
                                  op=op, quorum=bft_quorum,
                                  validator_keys=bft_keys):
            return ("snapshot certificate does not quorum-bind this op "
                    "at this chain position (forged or stale)")
    return ""


def snapshot_base_head(meta: Dict) -> bytes:
    """Chain head AFTER the snapshot op — the installed ledger's base
    head (the next streamed op chains onto it)."""
    from bflc_demo_tpu_torch.comm.bft import next_head
    op = meta["op"]
    if isinstance(op, str):
        op = bytes.fromhex(op)
    prev = meta["prev_head"]
    if isinstance(prev, str):
        prev = bytes.fromhex(prev)
    return next_head(prev, op)


def offer_to_wire(meta: Dict) -> Dict:
    """The one wire shape of a snapshot offer (`snapshot` RPC on the
    writer AND on read-fan-out replicas): hex for op/prev_head, the raw
    state/model bytes riding the binary frame tail (comm.wire)."""
    op = meta["op"]
    prev = meta["prev_head"]
    return {"ok": True, "i": int(meta["i"]), "epoch": int(meta["epoch"]),
            "gen": int(meta.get("gen", 0)),
            "op": op if isinstance(op, str) else op.hex(),
            "prev_head": (prev if isinstance(prev, str) else prev.hex()),
            "cert": meta.get("cert"),
            "state": bytes(meta["state"]),
            "model": bytes(meta["model"])}


# ------------------------------------------------------- artifact files
def write_snapshot_file(dirpath: str, meta: Dict) -> str:
    """Persist a snapshot artifact as snap-<epoch>-<i>.bflcsnap under
    `dirpath`, tmp-then-rename so a SIGKILL at any instruction leaves
    either no file or a complete one — never a half-written artifact a
    later install could trip over.  Returns the final path."""
    os.makedirs(dirpath, exist_ok=True)
    state = bytes(meta["state"])
    model = bytes(meta["model"])
    op = meta["op"]
    op_hex = op if isinstance(op, str) else op.hex()
    prev = meta["prev_head"]
    prev_hex = prev if isinstance(prev, str) else prev.hex()
    header = {
        "i": int(meta["i"]), "epoch": int(meta["epoch"]),
        "gen": int(meta.get("gen", 0)), "op": op_hex,
        "prev_head": prev_hex, "cert": meta.get("cert"),
        "state_len": len(state), "model_len": len(model),
        "state_sha": hashlib.sha256(state).hexdigest(),
        "model_sha": hashlib.sha256(model).hexdigest(),
    }
    hdata = json.dumps(header, separators=(",", ":")).encode()
    path = os.path.join(dirpath,
                        f"snap-{header['epoch']:08d}-{header['i']}.bflcsnap")
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(FILE_MAGIC)
        fh.write(struct.pack("<I", len(hdata)))
        fh.write(hdata)
        fh.write(state)
        fh.write(model)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def read_snapshot_file(path: str) -> Dict:
    """Load + integrity-check one artifact file; raises ValueError on a
    torn, truncated or bit-flipped file (callers fall back to the
    previous retained snapshot)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if not blob.startswith(FILE_MAGIC):
        raise ValueError(f"not a bflc snapshot artifact: {path}")
    off = len(FILE_MAGIC)
    if off + 4 > len(blob):
        raise ValueError(f"truncated snapshot artifact: {path}")
    (hlen,) = struct.unpack_from("<I", blob, off)
    off += 4
    if hlen > len(blob) - off:
        raise ValueError(f"truncated snapshot artifact header: {path}")
    try:
        header = json.loads(blob[off:off + hlen].decode())
        state_len = int(header["state_len"])
        model_len = int(header["model_len"])
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
            TypeError, ValueError) as e:
        raise ValueError(f"corrupt snapshot artifact header: {path}: "
                         f"{e}") from e
    off += hlen
    if state_len < 0 or model_len < 0 \
            or off + state_len + model_len != len(blob):
        raise ValueError(f"snapshot artifact length mismatch "
                         f"(torn write?): {path}")
    state = blob[off:off + state_len]
    model = blob[off + state_len:off + state_len + model_len]
    if hashlib.sha256(state).hexdigest() != header.get("state_sha"):
        raise ValueError(f"snapshot state bytes corrupt: {path}")
    if hashlib.sha256(model).hexdigest() != header.get("model_sha"):
        raise ValueError(f"snapshot model bytes corrupt: {path}")
    return {"i": int(header["i"]), "epoch": int(header["epoch"]),
            "gen": int(header.get("gen", 0)), "op": header["op"],
            "prev_head": header["prev_head"], "cert": header.get("cert"),
            "state": state, "model": model, "path": path}


def list_snapshot_files(dirpath: str) -> List[str]:
    """Artifact paths under `dirpath`, oldest first (the name embeds
    epoch + position, so lexicographic order IS chain order)."""
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith("snap-") and
                       n.endswith(".bflcsnap"))
    except OSError:
        return []
    return [os.path.join(dirpath, n) for n in names]


def latest_snapshot(dirpath: str) -> Optional[Dict]:
    """Newest artifact that passes integrity checks, or None.  A torn or
    corrupt newest file FALLS BACK to the previous retained snapshot —
    the installer must refuse bad bytes, not the whole directory."""
    for path in reversed(list_snapshot_files(dirpath)):
        try:
            return read_snapshot_file(path)
        except ValueError:
            continue
    return None


def prune_snapshots(dirpath: str, keep: int) -> int:
    """Delete all but the newest `keep` artifacts; returns the number
    removed.  Unlinking is atomic per file, so a SIGKILL mid-prune
    leaves a superset of the retention set — never a hole."""
    paths = list_snapshot_files(dirpath)
    removed = 0
    for p in paths[:-keep] if keep > 0 else paths:
        try:
            os.remove(p)
            removed += 1
        except OSError:
            continue
    return removed


def snapshot_legacy() -> bool:
    """True when BFLC_SNAPSHOT_LEGACY pins snapshots off (the
    replay-from-genesis baseline switch)."""
    return bool(os.environ.get("BFLC_SNAPSHOT_LEGACY"))
