"""Byzantine no-fork commits: quorum-validated, co-signed ledger binding.

Port of `bflc_demo_tpu/comm/bft.py`.  The reference system is a 4-node
PBFT chain: every op runs on all nodes and binds only with a 2f+1 quorum,
so one arbitrarily faulty node can neither fork history nor fabricate
state.  This module gives the writer the same property:

- **validators** (`ValidatorNode`) each hold their own replica of the
  chain.  Before an op binds, the writer collects a **commit
  certificate**: `bft_quorum(n)` validators re-execute the op against
  their replicas (the ledger's whole guard set, `validate_op`, and for a
  client op the client's Ed25519 tag against their own directory
  mirror) and co-sign `(index, chain head before, op digest, chain head
  after, attempt)` with their wallets;
- a validator signs at most one op per chain position and refuses a
  client op whose tag does not verify, so a writer that forges a score
  row, drops a client's op or shows different ops to different
  validators never gathers a quorum: any two quorums share an honest
  validator;
- the writer acknowledges, and certificate-checking clients and standbys
  accept, only state that carries a valid certificate.  At 4 validators
  this tolerates one crashed or lying validator.

Liveness: a validator that bound a different op at the tip re-votes on
quorum evidence only — a certificate for the competing op (resync and
retry, `_peer_certificate` then `_rollback_to`) or a repair proof: 2f+1
signed abandon statements at a higher attempt whose mandate admits the
op (`verify_repair_proof`).  `CertificateAssembler.certify` drives the
loop; a proposer whose own op loses the mandate learns the canonical op
through `superseded_op`.

Everything here is host work (SHA-256, Ed25519, the ledger's guards); a
disarmed validator holds no tensor and never imports torch.  The votes, the
certificates and the wire frames are the reference's byte for byte
(Ed25519 is deterministic), so port and reference validators, writers
and clients certify each other's op streams.

Snapshots: a writer's backlog below its GC base raises
`PrefixCompacted` with the certified snapshot offer, and the assembler
installs it on the lagging validator (`bft_snapshot`, which checks the
quorum certificate and the state digest itself); a state-synced replica
counts its heads from that base (`_head_base`).  `ValidatorClient` and
`CertificateAssembler` take `tls=` (a client context); the fleet dials
its validators in plaintext, as the reference does.

Sparse uploads (reference :425-470, :644-650): on a density-armed
quorum (`codecs.sparse_enabled`) every upload and aupload op must carry
its blob as auth evidence, hash to the op's payload hash and survive
`densify_entries(dequantize_entries(...))` (`check_sparse_upload_op`,
run outside the lock; a refusal is `SPARSE`), so a colluding writer
cannot certify a malformed `#topk` or `#sketch` blob; certified backlog
admits on its certificate, and a dense quorum ignores the gate.  The
decode is numpy (`utils/codecs.py`): a validator still imports no
torch.

Hierarchical cells (reference :634-643, :924-928): a validator given
the `cell_registry` refuses (`CELL`) a root upload op whose sender is no
registered cell aggregator or whose client count exceeds that cell's
registered membership (`hier/partial.check_cell_upload_op`, numpy only).

The re-derivation plane (reference :651-675, :936-956, :1039-1085,
:1590-1606; `rederive/`): an armed validator (`rederive` or
`BFLC_REDERIVE` shard/full, the legacy pin aside) builds a
`rederive.core.Rederiver` that re-derives every commit op (4, 12) from
the admitted deltas on the validator's own merge engine (`device`,
`cuda` unless the caller asks for the CPU: kernel B5 on the card) and
refuses (`REDERIVE`) one it cannot reproduce; a re-proposed commit
without a certificate is judged the same way, certified backlog admits
on its certificate.  The per-leaf digest vector of each re-derivation
rides the vote (`rl`, `rmode`), and the assembler cross-checks the
vectors of a certificate's votes (`crosscheck_rl`; its counts in
`CertificateAssembler.crosscheck`).  At a hier root each cell upload's
partial is re-derived from its member-signed deltas outside the lock
(`_cell_rederive_err`).  Opcode 13, the genome update, passes the same
re-execution as every op.  Only an armed validator imports torch; its
`info` reply carries the `Rederiver.stats` and the process's kernel
launches (the port's own fields).

Dropped: the obs metrics, flight recorder and trace spans (ROADMAP A14;
`utils/tracing.PROC` still charges `bft.validate_s` / `bft.validate_n`
on the validator).  Validators default to the python ledger, as the
reference's do (a native one probes each op by replaying its log into a
python mirror); one of another backend runs no `Rederiver`, as in the
reference (:668).
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bflc_demo_tpu_torch.comm.identity import (PublicDirectory, _op_bytes,
                                               address_of, verify_signature,
                                               verify_signatures_batch)
from bflc_demo_tpu_torch.comm.wire import WireError, recv_msg, send_msg
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.ledger.base import (ascores_sign_payload,
                                             encode_ascores_op,
                                             encode_aupload_op,
                                             encode_register_op,
                                             encode_scores_op,
                                             encode_upload_op)
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig, bft_quorum
from bflc_demo_tpu_torch.protocol.types import CommitCertificate
from bflc_demo_tpu_torch.utils import tracing
from bflc_demo_tpu_torch.utils.codecs import (densify_entries,
                                              dequantize_entries,
                                              sparse_enabled, unpack_pytree)

Endpoint = Tuple[str, int]


class PrefixCompacted(Exception):
    """A backlog position below the writer's GC base was asked for: the
    op bytes are gone.  Carries the snapshot offer, which the assembler
    installs on the lagging validator (`bft_snapshot`)."""

    def __init__(self, offer, base: int):
        super().__init__(f"log prefix compacted below {base}")
        self.offer = offer              # snapshot meta dict or None
        self.base = base


_CERT_MAGIC = b"BFLCCERT1"
_EMPTY_HEAD = b"\0" * 32        # head digest of the empty chain

# the op codec's opcodes (ledger/base); 4 and 12 are the commits the
# re-derivation plane judges
_OP_COMMIT, _OP_ACOMMIT = 4, 12
_OP_REGISTER, _OP_UPLOAD, _OP_SCORES = 1, 2, 3
_OP_AUPLOAD, _OP_ASCORES = 10, 11


def cert_payload_digest(index: int, prev_head: bytes, op_digest: bytes,
                        new_head: bytes, attempt: int = 0) -> bytes:
    """The byte layout a validator signs, shared by every signing and
    verification site.  The attempt is part of it, so one certificate's
    signatures were all minted at one attempt."""
    return (_CERT_MAGIC + struct.pack("<q", index)
            + (prev_head or _EMPTY_HEAD) + op_digest + new_head
            + struct.pack("<q", attempt))


def cert_payload(index: int, prev_head: bytes, op: bytes,
                 new_head: bytes, attempt: int = 0) -> bytes:
    """Position + chain prefix + op digest + resulting head (+ attempt):
    binding the prefix makes a signature meaningless on any other
    history."""
    return cert_payload_digest(index, prev_head,
                               hashlib.sha256(op).digest(), new_head,
                               attempt)


def next_head(prev_head: bytes, op: bytes) -> bytes:
    """The chain rule: head' = SHA-256(head || op), the empty chain
    contributing no prefix bytes."""
    d = hashlib.sha256()
    if prev_head and prev_head != _EMPTY_HEAD:
        d.update(prev_head)
    d.update(op)
    return d.digest()


def verify_certificate(cert: CommitCertificate, *, index: int,
                       prev_head: bytes, op: bytes, quorum: int,
                       validator_keys: Dict[int, bytes]) -> bool:
    """Full verification for a party that holds the chain: the
    certificate binds exactly (index, our prefix head, this op, the
    implied next head) and carries >= quorum valid signatures by
    distinct provisioned validators."""
    new_head = next_head(prev_head, op)
    if (cert.index != index
            or (cert.prev_head or _EMPTY_HEAD) != (prev_head or _EMPTY_HEAD)
            or cert.op_hash != hashlib.sha256(op).digest()
            or cert.new_head != new_head):
        return False
    return count_valid_sigs(cert, validator_keys) >= quorum


def count_valid_sigs(cert: CommitCertificate,
                     validator_keys: Dict[int, bytes]) -> int:
    """Signatures by distinct provisioned validators that verify over
    the certificate's own payload: one batch check, and on a miss the
    per-signature loop, so the count is always attributable."""
    payload = cert_payload_digest(cert.index, cert.prev_head,
                                  cert.op_hash, cert.new_head,
                                  cert.attempt)
    items = [(pub, payload, sig) for vidx, sig in cert.sigs.items()
             if (pub := validator_keys.get(vidx)) is not None]
    if items and verify_signatures_batch(items):
        return len(items)
    return sum(1 for pub, msg, sig in items
               if verify_signature(pub, msg, sig))


def verify_certificate_sigs(cert_wire, quorum: int,
                            validator_keys: Dict[int, bytes],
                            op_hash: Optional[bytes] = None) -> bool:
    """The client's acceptance check (it holds no chain): a quorum of
    authentic signatures over the certificate's own binding, and with
    `op_hash` (`expected_op_hash` of the request) a binding of that very
    op, so an old certificate cannot be replayed on a forged ack.  Never
    raises on malformed input."""
    try:
        cert = (cert_wire if isinstance(cert_wire, CommitCertificate)
                else CommitCertificate.from_wire(cert_wire))
    except (ValueError, TypeError):
        return False
    if op_hash is not None and cert.op_hash != op_hash:
        return False
    return count_valid_sigs(cert, validator_keys) >= quorum


# ------------------------------------------------ canonical op encoding
def expected_op_hash(method: str, fields: dict) -> Optional[bytes]:
    """sha256 of the op the writer must append for this request (the
    ledger's own encoders, so the append and the binding cannot drift);
    None when the method is no client mutation or the fields are
    malformed."""
    try:
        if method == "register":
            op = encode_register_op(fields["addr"])
        elif method == "upload":
            op = encode_upload_op(fields["addr"],
                                  bytes.fromhex(fields["hash"]),
                                  int(fields["n"]), float(fields["cost"]),
                                  int(fields["epoch"]))
        elif method == "scores":
            op = encode_scores_op(fields["addr"], int(fields["epoch"]),
                                  [float(s) for s in fields["scores"]])
        elif method == "aupload":
            op = encode_aupload_op(fields["addr"],
                                   bytes.fromhex(fields["hash"]),
                                   int(fields["n"]), float(fields["cost"]),
                                   int(fields["base_epoch"]))
        elif method == "ascores":
            op = encode_ascores_op(
                fields["addr"],
                [(int(a), float(s)) for a, s in fields["pairs"]])
        else:
            return None
        return hashlib.sha256(op).digest()
    except (KeyError, TypeError, ValueError):
        return None


# --------------------------------------------------------------- op auth
def check_op_auth(op: bytes, auth: Optional[dict],
                  directory: PublicDirectory) -> str:
    """'' when `op` is admissible on origin authentication, else the
    reason.  A client op (register/upload/scores/aupload/ascores) must
    carry the client's
    Ed25519 tag in `auth`, checked against the validator's own directory
    mirror: the writer cannot produce a committee member's signature.
    Tags sign the client's f64 values while ops store f32, so `auth`
    carries the f64 originals and the op bytes must be their exact f32
    image; an aupload tag binds the BASE epoch, an ascores tag the f64
    pairs at epoch 0.  Coordinator ops (commit/close/force/reseat/
    promote/acommit) carry no tag: re-execution (`validate_op`) is their
    check."""
    if not op or op[0] not in (_OP_REGISTER, _OP_UPLOAD, _OP_SCORES,
                               _OP_AUPLOAD, _OP_ASCORES):
        return ""
    if not isinstance(auth, dict):
        return "client op without auth evidence"
    body = op[1:]

    def _tofu_repair(sender: str) -> None:
        """Heal a directory hole from the evidence's pubkey: the address
        is the key's hash, and the tag must still verify under it."""
        if directory.knows(sender):
            return
        try:
            pub = bytes.fromhex(auth.get("pubkey", ""))
        except (TypeError, ValueError):
            return
        if pub and address_of(pub) == sender:
            directory.enroll(pub)

    def _str_at(off):
        (n,) = struct.unpack_from("<q", body, off)
        if n < 0 or off + 8 + n > len(body):
            raise ValueError("string past end of op")
        return body[off + 8:off + 8 + n].decode(), off + 8 + n

    try:
        tag = bytes.fromhex(auth["tag"])
        if op[0] == _OP_REGISTER:
            addr, _ = _str_at(0)
            pub = bytes.fromhex(auth.get("pubkey", ""))
            if not directory.knows(addr):
                if address_of(pub) != addr:
                    return "register: address/pubkey mismatch"
                directory.enroll(pub)
            if not directory.verify(addr, _op_bytes("register", addr, 0,
                                                    b""), tag):
                return "register: bad tag"
            return ""
        if op[0] in (_OP_UPLOAD, _OP_AUPLOAD):
            # the async upload shares the layout; its trailing epoch is
            # the base epoch the tag binds (kind "aupload")
            kind = "upload" if op[0] == _OP_UPLOAD else "aupload"
            sender, off = _str_at(0)
            payload_hash = body[off:off + 32]
            ns, = struct.unpack_from("<q", body, off + 32)
            cost_f32, = struct.unpack_from("<f", body, off + 40)
            epoch, = struct.unpack_from("<q", body, off + 44)
            n, cost = int(auth["n"]), float(auth["cost"])
            if n != ns:
                return f"{kind}: n_samples mismatch"
            if struct.pack("<f", np.float32(cost)) != \
                    struct.pack("<f", cost_f32):
                return f"{kind}: cost not the f32 image of the signed value"
            payload = payload_hash + struct.pack("<qd", n, cost)
            _tofu_repair(sender)
            if not directory.verify(sender, _op_bytes(kind, sender,
                                                      epoch, payload), tag):
                return (f"{kind}: bad tag (sender {sender[:12]}, "
                        f"epoch {epoch}, "
                        f"known={directory.knows(sender)})")
            return ""
        if op[0] == _OP_ASCORES:
            sender, off = _str_at(0)
            cnt, = struct.unpack_from("<q", body, off)
            if cnt <= 0 or off + 8 + 12 * cnt > len(body):
                return "ascores: malformed op"
            pairs = [(int(a), float(s)) for a, s in auth["pairs"]]
            if len(pairs) != cnt:
                return "ascores: pair count mismatch"
            p = off + 8
            for aseq, claimed in pairs:
                got_a, got_s = struct.unpack_from("<qf", body, p)
                if got_a != aseq or struct.pack(
                        "<f", np.float32(claimed)) != \
                        struct.pack("<f", got_s):
                    return ("ascores: pairs not the f32 image of the "
                            "signed values")
                p += 12
            _tofu_repair(sender)
            if not directory.verify(
                    sender, _op_bytes("ascores", sender, 0,
                                      ascores_sign_payload(pairs)), tag):
                return (f"ascores: bad tag (sender {sender[:12]}, "
                        f"known={directory.knows(sender)})")
            return ""
        # _OP_SCORES
        sender, off = _str_at(0)
        epoch, = struct.unpack_from("<q", body, off)
        cnt, = struct.unpack_from("<q", body, off + 8)
        if cnt < 0 or off + 16 + 4 * cnt > len(body):
            return "scores: malformed op"
        row_f32 = struct.unpack_from(f"<{cnt}f", body, off + 16)
        scores = [float(s) for s in auth["scores"]]
        if len(scores) != cnt:
            return "scores: row length mismatch"
        for got, claimed in zip(row_f32, scores):
            if struct.pack("<f", np.float32(claimed)) != \
                    struct.pack("<f", got):
                return "scores: row not the f32 image of the signed values"
        payload = struct.pack(f"<{len(scores)}d", *scores)
        _tofu_repair(sender)
        if not directory.verify(sender, _op_bytes("scores", sender, epoch,
                                                  payload), tag):
            return (f"scores: bad tag (sender {sender[:12]}, "
                    f"epoch {epoch}, known={directory.knows(sender)})")
        return ""
    except (KeyError, TypeError, ValueError, struct.error,
            UnicodeDecodeError) as e:
        return f"undecodable op/auth: {type(e).__name__}: {e}"


def check_sparse_upload_op(op: bytes, auth: Optional[dict]) -> str:
    """'' when a sparse-mode upload/aupload op's payload blob decodes
    through the one densify inverse; a reason otherwise.  The validator
    half of sparse admission (the writer half is the writer's
    `_decode_delta`): the auth evidence must carry the blob, its sha256
    must be the op's payload hash, and `densify_entries(
    dequantize_entries(...))` must accept it.  Validators hold no model
    schema; they pin the content binding and the records' structure.
    Only called in sparse mode."""
    if not op or op[0] not in (_OP_UPLOAD, _OP_AUPLOAD):
        return ""
    body = op[1:]
    try:
        (slen,) = struct.unpack_from("<q", body, 0)
        if slen < 0 or 8 + slen + 32 > len(body):
            return "sparse: malformed upload body"
        payload_hash = body[8 + slen:8 + slen + 32]
    except struct.error as e:
        return f"sparse: undecodable op ({e})"
    if not isinstance(auth, dict) or "blob" not in auth:
        return ("sparse: upload op without blob evidence (density-"
                "armed quorum requires it)")
    try:
        blob = bytes.fromhex(auth["blob"])
    except (TypeError, ValueError):
        return "sparse: unparseable blob evidence"
    if hashlib.sha256(blob).digest() != payload_hash:
        return "sparse: blob evidence does not match the op's payload hash"
    try:
        densify_entries(dequantize_entries(unpack_pytree(blob)))
    except (ValueError, TypeError, struct.error) as e:
        return f"sparse: blob refused by densify ({e})"
    return ""


# ------------------------------------------------- repair (liveness) layer
_ABANDON_MAGIC = b"BFLCABDN1"


def abandon_stmt_payload(index: int, attempt: int, validator: int,
                         has_vote: bool, voted_attempt: int,
                         op_digest: bytes) -> bytes:
    """One signed abandon statement: 'at repair attempt `attempt` for
    position `index` I hold `op_digest` (voted at `voted_attempt`) or
    nothing, and refuse votes below `attempt` here'."""
    return (_ABANDON_MAGIC
            + struct.pack("<qqII", index, attempt, validator,
                          1 if has_vote else 0)
            + struct.pack("<q", voted_attempt)
            + (op_digest or b"\0" * 32))


def verify_repair_proof(proof, index: int, attempt: int, quorum: int,
                        validator_keys: Dict[int, bytes],
                        ) -> Tuple[bool, Optional[bytes], Optional[bytes]]:
    """(ok, mandated op hash, mandated op bytes) of a repair proof for
    (index, attempt): >= quorum signed statements by distinct
    provisioned validators at exactly this position and attempt.  An op
    is mandated iff it could have certified given the statements:
    reports + (n - statements) >= quorum, so a possibly-certified op is
    always protected and a dead proposer's stranded partial votes are
    not.  No mandate (None) leaves the proposer free.  Never raises on
    malformed input."""
    try:
        stmts = list(proof["stmts"])
    except (KeyError, TypeError):
        return False, None, None
    seen: Dict[int, Tuple[bytes, bytes]] = {}   # validator -> (hash, op)
    distinct = set()
    for s in stmts:
        try:
            v = int(s["validator"])
            has_vote = bool(s.get("has_vote"))
            voted_t = int(s.get("voted_t", 0))
            oh = bytes.fromhex(s["op_hash"]) if has_vote else b""
            ob = bytes.fromhex(s.get("op", "")) if has_vote else b""
            sig = bytes.fromhex(s["sig"])
        except (KeyError, TypeError, ValueError):
            continue
        pub = validator_keys.get(v)
        if pub is None or v in distinct:
            continue
        payload = abandon_stmt_payload(index, attempt, v, has_vote,
                                       voted_t, oh)
        if not verify_signature(pub, payload, sig):
            continue
        distinct.add(v)
        # the op bytes ride unsigned beside the signed digest
        if has_vote and oh and hashlib.sha256(ob).digest() == oh:
            seen[v] = (oh, ob)
    if len(distinct) < quorum:
        return False, None, None
    counts: Dict[bytes, int] = {}
    for oh, _ in seen.values():
        counts[oh] = counts.get(oh, 0) + 1
    # non-reporting validators might all have voted the op
    bar = quorum - (len(validator_keys) - len(distinct))
    mandated = [oh for oh, c in counts.items() if c >= max(bar, 1)]
    if len(mandated) != 1:
        return True, None, None
    oh = mandated[0]
    ob = next(b for h, b in seen.values() if h == oh)
    return True, oh, ob


# --------------------------------------------------------------- validator
class ValidatorNode:
    """One member of the commit quorum: replica + wallet + vote server.

    Methods over `comm/wire` frames:
    - `bft_validate {i, op, auth?, t?, cert?, repair?}`: validate op for
      position i at attempt t.  One vote per (position, attempt); ops
      arrive in order (`OUT_OF_ORDER` + our log size tells a lagging
      writer what to resend); an op already held is re-signed.  A
      different op at a bound tip moves the replica only on quorum
      evidence: a certificate for it, or a repair proof whose mandate
      admits it — then the replica rolls back, re-applies and re-signs.
    - `bft_vote_batch {i, ops, auths?, t?}`: votes for a contiguous range
      in one round trip, the same certificates as the single-op path;
      it stops at the first op it cannot sign outright and returns that
      refusal with the votes minted so far.
    - `bft_abandon {i, t}`: a signed abandon statement for the position,
      and a promise to refuse votes below attempt t.
    - `bft_snapshot {i, op, prev_head, state, cert}`: install a
      certified snapshot in place of a GC'd prefix this replica lags
      below (refused when it already holds position i).
    - `info`: log size / head / base / epoch (`at` gives an earlier head).

    A vote applies the op: the vote promises that this op is position i
    of the validator's chain, which is what makes a second op there
    unsignable (`CONFLICT`) without quorum evidence.  Disarmed, the node
    holds no tensor and imports no torch; armed (`rederive`), its
    `Rederiver` merges on `device`.
    """

    def __init__(self, cfg: ProtocolConfig, wallet, index: int, *,
                 host: str = "127.0.0.1", port: int = 0,
                 ledger_backend: str = "python",
                 require_auth: bool = True,
                 directory: Optional[PublicDirectory] = None,
                 validator_keys: Optional[Dict[int, bytes]] = None,
                 quorum: Optional[int] = None,
                 cell_registry: Optional[Dict[str, Tuple[int, int]]] = None,
                 rederive: Optional[str] = None,
                 initial_model_blob: Optional[bytes] = None,
                 device=None,
                 verbose: bool = False):
        cfg.validate()
        self.cfg = cfg
        self.wallet = wallet
        self.index = index
        self.require_auth = require_auth
        self._ledger_backend = ledger_backend
        # peer keys: with them a backlog op carrying a quorum certificate
        # is admitted without the writer-local auth evidence (rejoin)
        self.validator_keys: Dict[int, bytes] = dict(validator_keys or {})
        if self.validator_keys and quorum is None:
            quorum = bft_quorum(len(self.validator_keys))
        self.quorum = quorum or 0
        self.verbose = verbose
        self.ledger = make_ledger(cfg, backend=ledger_backend)
        self.directory = directory if directory is not None \
            else PublicDirectory()
        # hierarchical cells (`hier/`): on a ROOT quorum every upload op
        # is a cell partial whose `n` is the cell's claimed client count;
        # holding the registry (derived from configuration, like the
        # validator keys), this validator refuses (`CELL`) an op from an
        # unregistered sender or one whose count exceeds that cell's
        # registered membership, so even a colluding root writer cannot
        # certify an inflated weight
        self._cell_registry: Optional[Dict[str, Tuple[int, int]]] = (
            dict(cell_registry) if cell_registry is not None else None)
        # a density-armed quorum re-executes every upload's and
        # aupload's blob evidence through the densify inverse
        self._sparse = sparse_enabled(cfg)
        # the re-derivation plane: the argument, else BFLC_REDERIVE; the
        # legacy pin wins.  Python backend only (it reads the replica's
        # pending selection and async buffer)
        from bflc_demo_tpu_torch.rederive import (REDERIVE_MODES,
                                                  rederive_legacy,
                                                  rederive_mode)
        if rederive is None:
            mode = rederive_mode()
        else:
            mode = (rederive if rederive in REDERIVE_MODES
                    and not rederive_legacy() else "off")
        self._rederiver = None
        if mode != "off" and ledger_backend == "python":
            from bflc_demo_tpu_torch.rederive.core import Rederiver
            self._rederiver = Rederiver(
                mode, index, len(self.validator_keys) or 1, cfg,
                initial_model_blob=initial_model_blob,
                cell_registry=self._cell_registry, device=device)
        self._lock = threading.Lock()
        # index -> (attempt, op digest) of our current vote there
        self._voted: Dict[int, Tuple[int, bytes]] = {}
        # index -> lowest attempt we will still vote at (abandon promises)
        self._promised: Dict[int, int] = {}
        self._heads: List[bytes] = []           # head after each op
        # a state-synced replica: _heads[k] is the head after position
        # _head_base + k, _base_head the head at _head_base (after the
        # snapshot op it installed)
        self._head_base = 0
        self._base_head = _EMPTY_HEAD
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()

    # ------------------------------------------------------------- server
    def start(self) -> None:
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def serve_forever(self) -> None:
        self.start()
        self._stop.wait()

    def close(self) -> None:
        self._stop.set()
        if self._rederiver is not None:
            self._rederiver.close()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    return
                method = msg.get("method", "")
                if method == "info":
                    reply = self._info(msg)
                elif method == "bft_validate":
                    reply = self._validate(msg)
                elif method == "bft_vote_batch":
                    reply = self._vote_batch(msg)
                elif method == "bft_abandon":
                    reply = self._abandon(msg)
                elif method == "bft_snapshot":
                    reply = self._snapshot_install(msg)
                elif method == "telemetry":
                    reply = {"ok": False, "error": "telemetry is not "
                             "ported yet (ROADMAP A14 (telemetry))"}
                else:
                    reply = {"ok": False,
                             "error": f"unknown method {method!r}"}
                send_msg(conn, reply)
        except (WireError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _info(self, msg: dict) -> dict:
        with self._lock:
            reply = {"ok": True, "validator": self.index,
                     "log_size": self.ledger.log_size(),
                     "log_head": self.ledger.log_head().hex(),
                     "log_base": self._head_base,
                     "epoch": self.ledger.epoch}
            try:
                at = int(msg.get("at", -1))
            except (TypeError, ValueError):
                at = -1
            # heads below a state-synced base went with the prefix
            if at == 0:
                reply["head_at"] = _EMPTY_HEAD.hex()
            elif self._head_base <= at <= self._head_base + len(self._heads):
                reply["head_at"] = self._prev_head(at).hex()
            if self._rederiver is not None:
                # the port's own fields: what this validator re-derived,
                # and the kernels its process launched (B5)
                from bflc_demo_tpu_torch.ops import launch_counts
                reply["rederive"] = dict(self._rederiver.stats,
                                         mode=self._rederiver.mode)
                reply["engine"] = self._rederiver.engine.report()
                reply["launches"] = launch_counts()
            if getattr(self.ledger, "adapt_every", 0):
                # the closed loop's knobs on this replica
                ge = self.ledger.genome_epoch
                reply["genome"] = {
                    "eff_density": float(self.ledger.effective_density),
                    "eff_staleness": int(self.ledger.effective_staleness),
                    "genome_epoch": -1 if ge is None else int(ge)}
            return reply

    # --------------------------------------------------------------- vote
    def _refuse(self, status: str, detail: str = "", **extra) -> dict:
        if self.verbose:
            print(f"[validator {self.index}] refuse: {status} {detail}",
                  flush=True)
        return {"ok": False, "status": status, "detail": detail,
                "log_size": self.ledger.log_size(), **extra}

    def _prev_head(self, i: int) -> bytes:
        """Chain head before position i on this replica (the base head at
        a state-synced replica's base)."""
        if i <= 0:
            return _EMPTY_HEAD
        if i == self._head_base:
            return self._base_head
        return self._heads[i - self._head_base - 1]

    def _sign_position(self, i: int, op: bytes, attempt: int) -> dict:
        head = self._heads[i - self._head_base]
        sig = self.wallet.sign(cert_payload(i, self._prev_head(i), op, head,
                                            attempt))
        return {"ok": True, "i": i, "validator": self.index, "t": attempt,
                "head": head.hex(), "sig": sig.hex()}

    def _enroll_register_pubkey(self, op: bytes, auth) -> None:
        """Recover a register op's self-authenticating pubkey into the
        directory mirror (a certificate-admitted op's tag is not checked
        here, but later fresh ops from that client must verify)."""
        if not (op and op[0] == _OP_REGISTER and isinstance(auth, dict)):
            return
        try:
            pub = bytes.fromhex(auth.get("pubkey", ""))
            (n,) = struct.unpack_from("<q", op, 1)
            addr = op[9:9 + n].decode()
            if pub and address_of(pub) == addr \
                    and not self.directory.knows(addr):
                self.directory.enroll(pub)
        except (ValueError, UnicodeDecodeError, struct.error):
            pass

    def _peer_certificate(self, msg: dict, i: int,
                          op: bytes) -> Optional[CommitCertificate]:
        """The request's certificate iff it verifies as a quorum binding
        of exactly (i, our prefix head, op)."""
        if not self.validator_keys:
            return None
        cert_wire = msg.get("cert")
        if not isinstance(cert_wire, dict):
            return None
        try:
            cert = CommitCertificate.from_wire(cert_wire)
        except ValueError:
            return None
        if i < self._head_base:
            # below a state-synced base the heads are gone: the binding
            # cannot be checked, so the certificate proves nothing here
            return None
        if not verify_certificate(cert, index=i,
                                  prev_head=self._prev_head(i), op=op,
                                  quorum=self.quorum,
                                  validator_keys=self.validator_keys):
            return None
        return cert

    def _rollback_to(self, i: int) -> None:
        """Rebuild the replica from ops[0..i): quorum evidence proved the
        suffix from i uncertifiable."""
        from bflc_demo_tpu_torch.ledger import clone_prefix
        self.ledger = clone_prefix(self.ledger, i, self.cfg,
                                   backend=self._ledger_backend)
        del self._heads[i - self._head_base:]
        for j in [k for k in self._voted if k >= i]:
            del self._voted[j]

    def _snapshot_install(self, msg: dict) -> dict:
        """State-sync a replica that lags below the writer's GC base:
        install the certified snapshot instead of replaying ops that no
        longer exist.  The certificate must quorum-bind exactly (i,
        prev_head, op) under this validator's provisioned peer keys and
        the state must hash to the op's digest; a replica that already
        holds position i refuses (an offer never rolls it back)."""
        from bflc_demo_tpu_torch.comm.wire import blob_bytes
        from bflc_demo_tpu_torch.ledger.snapshot import (restore_snapshot,
                                                         verify_snapshot_meta)
        try:
            i = int(msg["i"])
            op = bytes.fromhex(msg["op"])
            prev = bytes.fromhex(msg["prev_head"])
            state = blob_bytes(msg["state"])
        except (KeyError, TypeError, ValueError):
            return self._refuse("BAD_REQUEST")
        tr = tracing.PROC
        t0 = time.perf_counter()
        with self._lock:
            if self.ledger.log_size() >= i + 1:
                return self._refuse(
                    "CONFLICT", f"replica at {self.ledger.log_size()} "
                                f"already holds position {i}")
            meta = {"i": i, "op": op, "prev_head": prev, "state": state,
                    "cert": msg.get("cert"), "gen": 0}
            err = verify_snapshot_meta(meta, bft_quorum=self.quorum,
                                       bft_keys=self.validator_keys or None)
            if err:
                return self._refuse("SNAPSHOT", err)
            if not self.validator_keys:
                # an unverifiable install would let any peer rewrite us
                return self._refuse(
                    "SNAPSHOT", "no provisioned peer keys to verify the "
                                "snapshot certificate against")
            base_head = next_head(prev, op)
            self.ledger = restore_snapshot(state, self.cfg, i + 1,
                                           base_head)
            self._heads = []
            self._head_base = i + 1
            self._base_head = base_head
            self._voted = {k: v for k, v in self._voted.items() if k > i}
            if tr.enabled:
                tr.charge("bft.snapshot_install_s", time.perf_counter() - t0)
                tr.charge("bft.snapshot_installs")
            if self.verbose:
                print(f"[validator {self.index}] state-synced from "
                      f"snapshot@{i} (epoch {self.ledger.epoch})",
                      flush=True)
            return {"ok": True, "log_size": self.ledger.log_size()}

    def _apply_and_sign(self, i: int, op: bytes, op_hash: bytes,
                        attempt: int) -> dict:
        st = self.ledger.validate_op(op)
        if st != LedgerStatus.OK:
            # the replica's own guards (epoch/role/cap/duplicate) refuse
            return self._refuse(st.name)
        st = self.ledger.apply_op(op)
        if st != LedgerStatus.OK:       # unreachable: validate just passed
            return self._refuse(st.name, "apply after validate")
        self._voted[i] = (attempt, op_hash)
        self._heads.append(self.ledger.log_head())
        return self._sign_position(i, op, attempt)

    def _vote_locked(self, i: int, op: bytes, auth, attempt: int,
                     sparse_err: str = "", cell_err: str = "") -> dict:
        """The evidence-free voting core (lock held): re-sign of an op we
        hold, strict ordering, abandon promises, the sparse blob, auth,
        the re-derivation, apply + sign.  Anything that needs quorum
        evidence refuses here.  `sparse_err` is `check_sparse_upload_op`'s
        verdict and `cell_err` `Rederiver.check_cell`'s, both computed
        outside the lock (each decode materializes a dense model); the
        commit's re-derivation runs here, as it reads this replica's
        pending selection or async buffer."""
        op_hash = hashlib.sha256(op).digest()
        size = self.ledger.log_size()
        promised = self._promised.get(i, 0)
        if i < size:
            voted_t, voted_hash = self._voted.get(i, (0, None))
            if voted_hash == op_hash:
                # the attempt upgrades freely (the same op cannot fork)
                # but never below an outstanding abandon promise
                t = max(attempt, voted_t)
                if t < promised:
                    return self._refuse(
                        "PROMISED", f"promised attempt {promised}",
                        promised=promised, voted_t=voted_t)
                self._voted[i] = (t, op_hash)
                return self._sign_position(i, op, t)
            return self._refuse(
                "CONFLICT", f"position {i} already holds a different op",
                voted_t=voted_t, promised=promised)
        if i > size:
            return self._refuse("OUT_OF_ORDER",
                                f"replica at {size}, asked for {i}")
        if attempt < promised:
            return self._refuse("PROMISED", f"promised attempt {promised}",
                                promised=promised, voted_t=0)
        if self._cell_registry is not None:
            from bflc_demo_tpu_torch.hier.partial import \
                check_cell_upload_op
            err = check_cell_upload_op(op, self._cell_registry)
            if err:
                return self._refuse("CELL", err)
        if self._sparse and sparse_err:
            return self._refuse("SPARSE", sparse_err)
        if self.require_auth:
            err = check_op_auth(op, auth, self.directory)
            if err:
                return self._refuse("AUTH", err)
        rl = None
        if self._rederiver is not None:
            if cell_err:
                # a root cell partial that is not the FedAvg of its
                # member-signed deltas
                return self._refuse("REDERIVE", cell_err)
            if op[0] in (_OP_COMMIT, _OP_ACOMMIT):
                err, rl = self._rederiver.check(self.ledger, op, auth)
                if err:
                    return self._refuse("REDERIVE", err)
        r = self._apply_and_sign(i, op, op_hash, attempt)
        if r.get("ok") and rl is not None:
            # the per-leaf digest vector the assembler cross-checks
            r["rl"] = rl["leaves"]
            r["rmode"] = rl["mode"]
        return r

    def _validate(self, msg: dict) -> dict:
        try:
            i = int(msg["i"])
            op = bytes.fromhex(msg["op"])
            attempt = int(msg.get("t", 0))
        except (KeyError, TypeError, ValueError):
            return self._refuse("BAD_REQUEST")
        tr = tracing.PROC
        if not tr.enabled:
            return self._validate_inner(i, op, attempt, msg)
        t0 = time.perf_counter()
        try:
            return self._validate_inner(i, op, attempt, msg)
        finally:
            tr.charge("bft.validate_s", time.perf_counter() - t0)
            tr.charge("bft.validate_n")

    def _validate_inner(self, i: int, op: bytes, attempt: int,
                        msg: dict) -> dict:
        op_hash = hashlib.sha256(op).digest()
        # the blob decode is a pure function of (op, auth): outside the
        # lock
        sparse_err = (check_sparse_upload_op(op, msg.get("auth"))
                      if self._sparse else "")
        cell_err = self._cell_rederive_err(op, msg.get("auth"))
        with self._lock:
            r = self._vote_locked(i, op, msg.get("auth"), attempt,
                                  sparse_err=sparse_err, cell_err=cell_err)
            status = r.get("status")
            if r.get("ok") or status not in ("CONFLICT", "AUTH", "SPARSE",
                                             "REDERIVE"):
                return r
            if status == "CONFLICT":
                # a different op at a bound position: only quorum evidence
                # moves us.  (1) a certificate for `op` bound to our own
                # prefix head proves our suffix from i lost
                size = self.ledger.log_size()
                voted_t, _vh = self._voted.get(i, (0, None))
                promised = self._promised.get(i, 0)
                cert = self._peer_certificate(msg, i, op)
                repair_ok = False
                if cert is None and i == size - 1 \
                        and attempt > voted_t and attempt >= promised:
                    # (2) a repair proof at this attempt whose mandate
                    # admits `op` (or mandates nothing)
                    ok, mandated, _ = verify_repair_proof(
                        msg.get("repair"), i, attempt, self.quorum,
                        self.validator_keys)
                    repair_ok = ok and (mandated is None
                                        or mandated == op_hash)
                if cert is None and not repair_ok:
                    return r
                # a repair proof authorizes the rollback, never an auth
                # bypass: a client op still needs its tag (or a
                # certificate, a quorum's re-verification of it)
                if cert is None and self.require_auth:
                    err = check_op_auth(op, msg.get("auth"),
                                        self.directory)
                    if err:
                        return self._refuse("AUTH", err)
                if cert is None and self._sparse and sparse_err:
                    # ... nor a sparse bypass: a re-proposed upload
                    # still needs its blob evidence
                    return self._refuse("SPARSE", sparse_err)
                if cert is None and cell_err:
                    # ... nor a cell re-derivation bypass
                    return self._refuse("REDERIVE", cell_err)
                self._enroll_register_pubkey(op, msg.get("auth"))
                self._rollback_to(i)
                rl = None
                if cert is None and self._rederiver is not None \
                        and op and op[0] in (_OP_COMMIT, _OP_ACOMMIT):
                    # a re-proposed commit without a certificate: the
                    # rollback restored the state before it, so it is
                    # judged as a fresh vote
                    err, rl = self._rederiver.check(self.ledger, op,
                                                    msg.get("auth"))
                    if err:
                        return self._refuse("REDERIVE", err)
                t = max(attempt, cert.attempt if cert else 0)
                r2 = self._apply_and_sign(i, op, op_hash, t)
                if r2.get("ok") and rl is not None:
                    r2["rl"] = rl["leaves"]
                    r2["rmode"] = rl["mode"]
                return r2
            # AUTH, SPARSE or REDERIVE refusal at the fresh tip: certified
            # backlog (the quorum already checked the tag, the blob and
            # the re-derivation once) admits on its certificate, so a
            # validator rejoining after a failover, whose evidence is
            # gone, stays live
            if self._peer_certificate(msg, i, op) is None:
                return r
            self._enroll_register_pubkey(op, msg.get("auth"))
            return self._apply_and_sign(i, op, op_hash, attempt)

    def _cell_rederive_err(self, op: bytes, auth) -> str:
        """The root cell partial's re-derivation verdict ('' = fine or
        not applicable), outside the validator's lock.  With the closed
        loop armed the partial re-encodes at the effective density this
        replica holds (a plain float read: the genome op moves it only at
        round boundaries); a static fleet passes None."""
        if self._rederiver is None or self._cell_registry is None \
                or not op or op[0] != _OP_UPLOAD:
            return ""
        from bflc_demo_tpu_torch.ledger.base import adapt_enabled
        eff = (float(self.ledger.effective_density)
               if adapt_enabled(self.cfg) else None)
        return self._rederiver.check_cell(op, auth, density=eff)

    _VOTE_BATCH_MAX = 256

    def _vote_batch(self, msg: dict) -> dict:
        """{ok, votes: [per-op votes], stopped: first refusal or None,
        log_size}: `votes` covers the longest signable prefix."""
        try:
            start = int(msg["i"])
            ops = [bytes.fromhex(o) for o in msg["ops"]]
            auths = msg.get("auths") or [None] * len(ops)
            attempt = int(msg.get("t", 0))
        except (KeyError, TypeError, ValueError):
            return self._refuse("BAD_REQUEST")
        if len(auths) != len(ops) or len(ops) > self._VOTE_BATCH_MAX:
            return self._refuse("BAD_REQUEST",
                                f"batch of {len(ops)} ops rejected")
        votes: List[dict] = []
        stopped = None
        tr = tracing.PROC
        t0 = time.perf_counter() if tr.enabled else 0.0
        # each op's blob decode (and cell re-derivation) outside the lock
        sparse_errs = ([check_sparse_upload_op(op, auths[k])
                        for k, op in enumerate(ops)]
                       if self._sparse else [""] * len(ops))
        cell_errs = [self._cell_rederive_err(op, auths[k])
                     for k, op in enumerate(ops)]
        with self._lock:
            for k, op in enumerate(ops):
                r = self._vote_locked(start + k, op, auths[k], attempt,
                                      sparse_err=sparse_errs[k],
                                      cell_err=cell_errs[k])
                if not r.get("ok"):
                    stopped = r
                    break
                votes.append(r)
            size = self.ledger.log_size()
        if tr.enabled:
            tr.charge("bft.validate_s", time.perf_counter() - t0)
            tr.charge("bft.validate_n", len(votes))
        return {"ok": True, "votes": votes, "stopped": stopped,
                "log_size": size}

    def _abandon(self, msg: dict) -> dict:
        """A signed abandon statement for (i, t): what we hold at i, and
        a promise to refuse votes below attempt t."""
        try:
            i = int(msg["i"])
            t = int(msg["t"])
        except (KeyError, TypeError, ValueError):
            return self._refuse("BAD_REQUEST")
        with self._lock:
            size = self.ledger.log_size()
            if i < size - 1:
                # below the tip sits certified history: never abandonable
                return self._refuse("CONFLICT",
                                    f"position {i} is certified history")
            voted_t, voted_hash = self._voted.get(i, (0, None))
            promised = self._promised.get(i, 0)
            if t < promised or (voted_hash is not None and t <= voted_t):
                return self._refuse("STALE_ATTEMPT",
                                    f"promised {promised}, voted at "
                                    f"{voted_t}",
                                    promised=promised, voted_t=voted_t)
            self._promised[i] = t
            has_vote = voted_hash is not None
            op = self.ledger.log_op(i) if has_vote else b""
            sig = self.wallet.sign(abandon_stmt_payload(
                i, t, self.index, has_vote, voted_t,
                voted_hash or b"\0" * 32))
            return {"ok": True, "i": i, "t": t, "validator": self.index,
                    "has_vote": has_vote,
                    "op_hash": (voted_hash or b"").hex(),
                    "op": op.hex(), "voted_t": voted_t,
                    "sig": sig.hex()}


class ValidatorClient:
    """Writer-side connection to one validator; reconnects lazily."""

    def __init__(self, endpoint: Endpoint, timeout_s: float = 10.0,
                 tls=None):
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self._tls = tls
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.endpoint,
                                         timeout=self.timeout_s)
            if self._tls is not None:
                s = self._tls.wrap_socket(s,
                                          server_hostname=self.endpoint[0])
            self._sock = s
        return self._sock

    def request(self, method: str, **fields) -> dict:
        send_msg(self._connect(), {"method": method, **fields})
        reply = recv_msg(self._sock)
        if reply is None:
            raise ConnectionError("validator closed the connection")
        return reply

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class CertificateAssembler:
    """Collects a quorum of validator votes for consecutive ops.

    Owned by the writer (`comm/ledger_service.LedgerServer`) and by a
    promoting standby (for its fence op).  `certify(i, op, auth,
    prev_head)` asks every validator in parallel, replays the backlog
    into a lagging replica from `backlog_fn(j) -> (op, auth, cert_wire)`,
    verifies every vote against the provisioned keys (a lying
    validator's garbage does not count) and returns the certificate once
    >= quorum distinct valid signatures agree, or None.  When votes split
    because validators hold a different op, it runs abandon rounds at
    rising attempts; a proposer whose own op loses the mandate gets None
    with `superseded_op` set to the canonical op.
    """

    def __init__(self, endpoints: List[Endpoint],
                 validator_keys: Dict[int, bytes], quorum: int, *,
                 timeout_s: float = 10.0, tls=None, backlog_fn=None,
                 max_repair_rounds: int = 3):
        self.endpoints = list(endpoints)
        self.keys = dict(validator_keys)
        self.quorum = quorum
        self.timeout_s = timeout_s
        self.backlog_fn = backlog_fn
        self.max_repair_rounds = max_repair_rounds
        # set instead of a certificate when a repair round proved a
        # foreign op the only safely bindable one at the position
        self.superseded_op: Optional[bytes] = None
        # one record a `bft_snapshot` offer {validator, i, seconds, ok}
        self.snapshot_offers: List[dict] = []
        # the rederive plane's digest cross-checks by result
        self.crosscheck: Dict[str, int] = {"ok": 0, "disagree": 0}
        self._clients = [ValidatorClient(ep, timeout_s=timeout_s, tls=tls)
                         for ep in endpoints]

    def close(self) -> None:
        for c in self._clients:
            c.close()

    def _backlog(self, j: int):
        """(op, auth, cert) of backlog position j."""
        entry = self.backlog_fn(j)
        return entry[0], entry[1], (entry[2] if len(entry) > 2 else None)

    def _parallel(self, fn, *args) -> None:
        """fn(client, index, *args) on every validator at once, each
        bounded by the timeout."""
        threads = [threading.Thread(target=fn, args=(c, ci) + args,
                                    daemon=True)
                   for ci, c in enumerate(self._clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout_s + 5.0)

    def _vote_one(self, client: ValidatorClient, i: int, op: bytes,
                  auth: Optional[dict], attempt: int,
                  repair: Optional[dict]) -> Optional[dict]:
        """One validator's reply for (i, op, attempt), replaying the
        backlog when it reports OUT_OF_ORDER; None on transport
        failure."""
        for retry in (0, 1):            # one reconnect per certify call
            try:
                r = client.request("bft_validate", i=i, op=op.hex(),
                                   auth=auth, t=attempt, repair=repair)
                resyncs = 0
                while (not r.get("ok")
                       and r.get("status") == "OUT_OF_ORDER"
                       and self.backlog_fn is not None):
                    behind = int(r.get("log_size", -1))
                    if not 0 <= behind < i:
                        break
                    for j in range(behind, i):
                        try:
                            bop, bauth, bcert = self._backlog(j)
                        except PrefixCompacted as e:
                            # below the GC base: install the snapshot,
                            # then re-ask from the replica's new position
                            if not self._offer_snapshot(client, e):
                                return None
                            break
                        rj = client.request("bft_validate", i=j,
                                            op=bop.hex(), auth=bauth,
                                            cert=bcert)
                        if not rj.get("ok"):
                            # a diverged suffix below j: certificate
                            # resync heals it, then the replay restarts
                            resyncs += 1
                            if resyncs > 2 or \
                                    not self._resync_diverged(client, j):
                                return None
                            break
                    r = client.request("bft_validate", i=i, op=op.hex(),
                                       auth=auth, t=attempt, repair=repair)
                return r
            except (ConnectionError, WireError, OSError):
                client.close()
                if retry:
                    return None
        return None

    def _catch_up(self, client: ValidatorClient, behind: int,
                  upto: int) -> bool:
        """Replay certified backlog [behind, upto) into a lagging replica;
        True when it provably reached `upto`."""
        if self.backlog_fn is None or not 0 <= behind < upto:
            return False
        resyncs = 0
        j = behind
        while j < upto:
            try:
                bop, bauth, bcert = self._backlog(j)
            except PrefixCompacted as e:
                # below the GC base: install the snapshot and go on from
                # the position after it
                if not self._offer_snapshot(client, e) or e.base <= j:
                    return False
                j = e.base
                continue
            try:
                rj = client.request("bft_validate", i=j, op=bop.hex(),
                                    auth=bauth, cert=bcert)
            except (ConnectionError, WireError, OSError):
                client.close()
                return False
            if rj.get("ok"):
                j += 1
                continue
            resyncs += 1
            if resyncs > 2 or not self._resync_diverged(client, j):
                return False
            try:
                inf = client.request("info")
                j = max(0, min(int(inf.get("log_size", j)), j))
            except (ConnectionError, WireError, OSError,
                    TypeError, ValueError):
                client.close()
                return False
        return True

    def _vote_batch_one(self, client: ValidatorClient, start: int,
                        entries) -> Optional[List[dict]]:
        """One validator's votes for the contiguous `entries` at
        [start, ...) in one `bft_vote_batch` round trip, with a backlog
        replay and one re-ask on OUT_OF_ORDER; None on transport failure
        or a peer without the batch method."""
        ops_hex = [op.hex() for op, _ in entries]
        auths = [a for _, a in entries]
        for retry in (0, 1):
            try:
                r = client.request("bft_vote_batch", i=start, ops=ops_hex,
                                   auths=auths)
                if not r.get("ok"):
                    return None
                stopped = r.get("stopped")
                if not r.get("votes") and isinstance(stopped, dict) \
                        and stopped.get("status") == "OUT_OF_ORDER":
                    try:
                        behind = int(stopped.get("log_size", -1))
                    except (TypeError, ValueError):
                        behind = -1
                    if self._catch_up(client, behind, start):
                        r = client.request("bft_vote_batch", i=start,
                                           ops=ops_hex, auths=auths)
                        if not r.get("ok"):
                            return None
                return r.get("votes") or []
            except (ConnectionError, WireError, OSError):
                client.close()
                if retry:
                    return None
        return None

    def certify_range(self, start: int, entries, prev_head: bytes,
                      ) -> List[Optional[CommitCertificate]]:
        """Certify the contiguous ops `entries` = [(op, auth), ...] at
        positions [start, ...) in one vote round trip per validator.
        Votes are verified before they count (in bulk, with a per-sig
        fallback) and the certificates equal the single-op path's.
        Returns a list aligned with `entries`; the first None (and all
        after it) marks where the fast path stopped, which the caller
        routes through `certify`."""
        n = len(entries)
        prevs: List[bytes] = []
        heads: List[bytes] = []
        h = prev_head or _EMPTY_HEAD
        for op, _ in entries:
            prevs.append(h)
            h = next_head(h, op)
            heads.append(h)
        raw: List[List[Tuple[int, int, bytes]]] = [[] for _ in range(n)]
        # position -> {validator: per-leaf digest vector}, cross-checked
        # once the certificates are minted
        rl_by_pos: List[Dict[int, dict]] = [{} for _ in range(n)]
        lock = threading.Lock()

        def ask(client, _ci):
            vs = self._vote_batch_one(client, start, entries)
            for v in vs or ():
                try:
                    k = int(v["i"]) - start
                    vidx = int(v["validator"])
                    vt = int(v.get("t", 0))
                    sig = bytes.fromhex(v["sig"])
                except (KeyError, TypeError, ValueError):
                    continue
                if 0 <= k < n and vidx in self.keys:
                    with lock:
                        raw[k].append((vidx, vt, sig))
                        if isinstance(v.get("rl"), dict):
                            rl_by_pos[k][vidx] = v["rl"]

        self._parallel(ask)
        items, flat = [], []
        for k, lst in enumerate(raw):
            for vidx, vt, sig in lst:
                payload = cert_payload(start + k, prevs[k],
                                       entries[k][0], heads[k], vt)
                items.append((self.keys[vidx], payload, sig))
                flat.append((k, vidx, vt, sig))
        all_ok = verify_signatures_batch(items) if items else True
        votes: List[Dict[int, Dict[int, bytes]]] = [{} for _ in range(n)]
        for (k, vidx, vt, sig), (pub, payload, _s) in zip(flat, items):
            if all_ok or verify_signature(pub, payload, sig):
                votes[k].setdefault(vt, {})[vidx] = sig
        certs: List[Optional[CommitCertificate]] = []
        for k in range(n):
            got = None
            for vt, sigs in sorted(votes[k].items()):
                if len(sigs) >= self.quorum:
                    got = CommitCertificate(
                        index=start + k, prev_head=prevs[k],
                        op_hash=hashlib.sha256(entries[k][0]).digest(),
                        new_head=heads[k], attempt=vt, sigs=dict(sigs))
                    break
            if got is not None and all_ok \
                    and len(got.sigs) == self.quorum:
                # an exactly-quorum certificate accepted on the
                # (cofactored) batch check alone: re-check each signature
                # under the stricter per-item rule before minting it
                payload = cert_payload(start + k, prevs[k],
                                       entries[k][0], heads[k],
                                       got.attempt)
                if sum(1 for vidx, sig in got.sigs.items()
                       if verify_signature(self.keys[vidx], payload,
                                           sig)) < self.quorum:
                    got = None
            certs.append(got)
            if got is None:
                break
        certs += [None] * (n - len(certs))
        for k, rls in enumerate(rl_by_pos):
            if len(rls) >= 2:
                self._crosscheck(rls)
        return certs

    def _crosscheck(self, rls: Dict[int, dict]) -> None:
        """Cross-check the per-leaf digest vectors that rode a commit
        op's votes.  Honest vectors never disagree, so a disagreement
        records a lying or faulty validator (safety rests on the shard
        coverage, not on this check)."""
        from bflc_demo_tpu_torch.rederive.core import crosscheck_rl
        self.crosscheck["disagree" if crosscheck_rl(rls) else "ok"] += 1

    def _gather_votes(self, i: int, op: bytes, auth: Optional[dict],
                      prev_head: bytes, attempt: int,
                      repair: Optional[dict]):
        """-> (signatures by attempt, refusals, diverged clients): a
        client whose ok vote does not verify over our payload votes on a
        stale fork (its head differs) and needs a certificate resync."""
        new_head = next_head(prev_head, op)
        votes: Dict[int, Dict[int, bytes]] = {}
        refusals: List[dict] = []
        diverged: List[ValidatorClient] = []
        rls: Dict[int, dict] = {}
        lock = threading.Lock()

        def ask(client, _ci):
            r = self._vote_one(client, i, op, auth, attempt, repair)
            if r is None:
                return
            if not r.get("ok"):
                with lock:
                    refusals.append(r)
                    if tracing.PROC.enabled:
                        # each refusal by status (a SPARSE one: a blob
                        # the validators' densify refused)
                        tracing.PROC.charge(
                            f"bft.refused.{r.get('status')}")
                return
            try:
                vidx = int(r["validator"])
                vt = int(r.get("t", attempt))
                sig = bytes.fromhex(r["sig"])
            except (KeyError, TypeError, ValueError):
                return
            pub = self.keys.get(vidx)
            if pub is None:
                return
            # verify before counting: garbage, or a vote minted on a
            # diverged replica, must not join the quorum
            payload = cert_payload(i, prev_head, op, new_head, vt)
            with lock:
                if verify_signature(pub, payload, sig):
                    votes.setdefault(vt, {})[vidx] = sig
                    if isinstance(r.get("rl"), dict):
                        rls[vidx] = r["rl"]
                else:
                    diverged.append(client)

        self._parallel(ask)
        if len(rls) >= 2:
            self._crosscheck(rls)
        return votes, refusals, diverged

    def _resync_diverged(self, client: ValidatorClient, i: int) -> bool:
        """Heal a replica that kept extending a stale fork: find the
        first position where its head leaves our chain and present our
        certificate there (the validator rolls back and rejoins)."""
        if self.backlog_fn is None:
            return False
        try:
            inf = client.request("info")
            size = min(int(inf.get("log_size", 0)), i)
        except (ConnectionError, WireError, OSError, TypeError,
                ValueError):
            client.close()
            return False
        # our heads over the certified backlog; on a compacted writer the
        # fold starts at the snapshot's base (a replica at or below the
        # snapshot heals only by installing it)
        base, base_head = 0, _EMPTY_HEAD
        try:
            ops = [self._backlog(j) for j in range(size)]
        except PrefixCompacted as e:
            if e.offer is None or size <= int(e.offer["i"]) + 1:
                return self._offer_snapshot(client, e)
            from bflc_demo_tpu_torch.ledger.snapshot import (
                snapshot_base_head)
            base = int(e.offer["i"]) + 1
            base_head = snapshot_base_head(e.offer)
            try:
                ops = [self._backlog(j) for j in range(base, size)]
            except PrefixCompacted:
                return False            # GC moved on: the retry syncs
        heads = []
        h = base_head
        for entry in ops:
            heads.append(next_head(h, entry[0]))
            h = heads[-1]
        d = size                        # first divergent index
        for j in range(size, base, -1):
            try:
                r = client.request("info", at=j)
            except (ConnectionError, WireError, OSError):
                client.close()
                return False
            if r.get("head_at") and \
                    bytes.fromhex(r["head_at"]) == heads[j - base - 1]:
                break
            d = j - 1
        if d >= size:
            return False                # no divergence below i after all
        op, auth, cert = ops[d - base]
        if cert is None:
            return False
        try:
            r = client.request("bft_validate", i=d, op=op.hex(),
                               auth=auth, cert=cert)
            return bool(r.get("ok"))
        except (ConnectionError, WireError, OSError):
            client.close()
            return False

    def _offer_snapshot(self, client: ValidatorClient,
                        exc: PrefixCompacted) -> bool:
        """Hand a lagging replica the certified snapshot (`bft_snapshot`);
        True when it installed.  The validator checks everything itself,
        so a corrupt offer costs a refusal, never a poisoned replica."""
        offer = exc.offer
        if offer is None:
            return False
        op, prev = offer["op"], offer["prev_head"]
        t0 = time.perf_counter()
        try:
            r = client.request(
                "bft_snapshot", i=int(offer["i"]),
                op=op if isinstance(op, str) else op.hex(),
                prev_head=prev if isinstance(prev, str) else prev.hex(),
                state=bytes(offer["state"]), cert=offer.get("cert"))
        except (ConnectionError, WireError, OSError):
            client.close()
            return False
        self.snapshot_offers.append({
            "validator": list(client.endpoint), "i": int(offer["i"]),
            "seconds": time.perf_counter() - t0, "ok": bool(r.get("ok"))})
        return bool(r.get("ok"))

    def _abandon_round(self, i: int, attempt: int):
        """Signed abandon statements at (i, attempt) from every
        validator; one re-ask at a higher attempt when stale promises
        surface.  -> (statements, attempt used)."""
        for _ in range(2):
            stmts: List[dict] = []
            stale = [attempt]
            lock = threading.Lock()

            def ask(client, _ci):
                try:
                    r = client.request("bft_abandon", i=i, t=attempt)
                except (ConnectionError, WireError, OSError):
                    client.close()
                    return
                with lock:
                    if r.get("ok"):
                        stmts.append(r)
                    elif r.get("status") == "STALE_ATTEMPT":
                        try:
                            stale[0] = max(stale[0],
                                           int(r.get("promised", 0)),
                                           int(r.get("voted_t", 0)))
                        except (TypeError, ValueError):
                            pass

            self._parallel(ask)
            if len(stmts) >= self.quorum or stale[0] <= attempt:
                return stmts, attempt
            attempt = stale[0] + 1
        return stmts, attempt

    def certify(self, i: int, op: bytes, auth: Optional[dict],
                prev_head: bytes) -> Optional[CommitCertificate]:
        self.superseded_op = None
        op_hash = hashlib.sha256(op).digest()
        new_head = next_head(prev_head, op)
        attempt, repair = 0, None
        for _ in range(self.max_repair_rounds + 1):
            votes, refusals, diverged = self._gather_votes(
                i, op, auth, prev_head, attempt, repair)
            if diverged:
                # heal stale-fork replicas before taking the quorum exit:
                # a diverged validator silently erodes the f margin
                healed = [self._resync_diverged(c, i) for c in diverged]
                if any(healed):
                    continue
            for vt, sigs in sorted(votes.items()):
                if len(sigs) >= self.quorum:
                    return CommitCertificate(
                        index=i, prev_head=prev_head or _EMPTY_HEAD,
                        op_hash=op_hash, new_head=new_head,
                        attempt=vt, sigs=dict(sigs))
            blockers = [r for r in refusals
                        if r.get("status") in ("CONFLICT", "PROMISED",
                                               "STALE_ATTEMPT")]
            if not blockers or self.quorum <= 0:
                # transport or availability failure, not divergence: a
                # repair round cannot help; the caller retries later
                return None
            hint = 0
            for r in blockers:
                try:
                    hint = max(hint, int(r.get("promised", 0) or 0),
                               int(r.get("voted_t", 0) or 0))
                except (TypeError, ValueError):
                    pass
            for vt in votes:
                hint = max(hint, vt)
            stmts, next_t = self._abandon_round(i, max(attempt, hint) + 1)
            proof = {"stmts": stmts}
            ok, mandated, mop = verify_repair_proof(
                proof, i, next_t, self.quorum, self.keys)
            if not ok:
                return None             # no statement quorum reachable
            if mandated is not None and mandated != op_hash:
                # a foreign op is the only safely bindable one: our
                # suffix lost the race — step aside
                self.superseded_op = mop
                return None
            attempt, repair = next_t, proof
        return None


def provision_validators(n: int, master_seed: bytes):
    """Deterministic validator identities from a deployment's master
    seed: (wallets, {index: public key}), the reference's derivation."""
    from bflc_demo_tpu_torch.comm.identity import Wallet
    wallets = [Wallet.from_seed(master_seed + b"|bft-validator|"
                                + struct.pack("<q", v)) for v in range(n)]
    return wallets, {v: w.public_bytes for v, w in enumerate(wallets)}
