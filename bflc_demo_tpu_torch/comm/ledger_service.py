"""The networked coordinator: the ledger behind a real socket boundary.

Port of the synchronous `LedgerServer` of
`bflc_demo_tpu/comm/ledger_service.py` (:288-2563), with `chain_head_at`
(:167), the promotion evidence (:189-260), `_aggregate_flat` (:262),
`CoordinatorClient` (:2564) and `replicate` (:2592).  The writer owns
the ledger, verifies every client's Ed25519 tag against its public
directory (trust on first use unless a directory is given), meters
storage ops with per-epoch gas, stores the payload blobs, merges the
round through the certified merge engine when the committee's scores
complete the round, streams the op log to replicas and standbys, and
runs the failure detector whose recovery ops (close_round ->
reseat_committee -> force_aggregate) carry a round past dead clients.
Its frames, methods, replies, op bytes and chain are the reference's,
so a reference client can drive it and a reference replica or standby
can follow it, and back.

Failover and durability (`comm/failover.Standby` builds this server at
promotion over its replayed ledger, mirrored blobs and bound socket:
`resume_ledger`, `resume_blobs`, `sock`):
- every reply carries the writer generation `gen` and, on a promoted
  writer, its signed `promotion_evidence` as `gen_ev`;
- a request whose `fence` is above this writer's generation demotes it
  (one `STALE_WRITER` reply, then `fenced` is set and the server
  closes) only when its `fence_ev` verifies: signed by a provisioned
  standby (`standby_keys`) and bound to this writer's own chain prefix.
  A bare integer is served as usual;
- `wal_path` journals the whole chain (`ledger.attach_wal`);
- with `quorum` Q > 0 a storage mutation is acknowledged only once Q
  subscribers acked every op through it, else the reply is
  `REPLICATION_TIMEOUT` after `quorum_timeout_s`.  With standby keys
  provisioned only subscribers that passed the challenge handshake
  (`_SUB_MAGIC || challenge || <Iq index, start>`, signed) count, and
  a subscriber's acks are clamped to the ops it was sent;
- the op stream piggybacks an upload op's payload blob and a commit
  op's new model blob on the frame, so a follower's mirror-before-apply
  needs no fetch; an authenticated standby's read endpoint (`read_ep`)
  joins the read set that `model` replies advertise.  Unlike the
  reference, which rides only the newest model, the writer keeps the
  models of its last PAST_MODELS commits for that (C14): a follower
  behind later commits otherwise fetched the newest model after every
  op, found it the wrong one and fell further behind.

BFT commit certificates (`comm/bft.py`): with `bft_validators`
endpoints (and their `bft_keys`) an op binds only once `bft_quorum`
validators re-executed and co-signed it.  A mutation's ack carries the
certificate of the op its request implies (`DUPLICATE`-class replies the
original op's), an op no quorum signs answers `CERT_TIMEOUT`, the op
stream publishes only certified ops with their certificates, `info`
reports `certified_size`, and validators get each client op's auth
evidence (tag, pubkey, f64 values).  Certification drains the whole
uncertified backlog in one `certify_range` round trip per validator, at
most 128 ops a window, and falls back to the single-op `certify` (with
its repair rounds) where the batch stops; a writer whose op loses the
repair mandate to a foreign proposer fences itself.  A promoted standby
passes its mirrored certificates as `resume_certs`.
`BFLC_CONTROL_PLANE_LEGACY=1`, the reference's baseline switch, pins the
window to one op a round trip and streams no piggybacked blob.

The merge runs through `meshagg` on the server's `device` (`cuda`
unless the caller asks for the CPU) at the genome's block count
(`ledger/base.reduce_blocks`, REDUCTION SPEC v2): the reference's leg
policy picks the mesh leg — kernel B5 on the card, one launch a block,
after its one-time self-check — for rounds of at least
`BFLC_MESH_AGG_MIN` admitted deltas, staged as flattened rows at
admission (a promoted writer re-derives the rows of the blobs it
mirrored).  On the card a failure there raises; it never falls back to
the host leg.  With `BFLC_PROC_TRACE=1` the merge charges
`aggregate_s` (and the engine call alone `aggregate.engine_s`) to
`utils/tracing.PROC` (certification `bft.certify_s`, split into
`bft.certify_batch_s` and `bft.certify_single_s`, with the ops each
certified, `bft.certify_batched_ops` / `bft.certify_single_ops`), and
`info` returns the tracer's summary as `perf` (and, asked with `at`, the
chain head after that many ops as `head_at`).  The `kernels` method
(the port's own) answers the process's kernel launch counts, the
engine's report and `merge_log`, one record a commit (its epoch, the
writer's clock and the host's monotonic clock, the merge's seconds, leg
and blocks), with the writer's generation, index and start on the
monotonic clock (a failover's gap is read from them), the chain's
size, certified prefix and highest subscriber ack, and the chain this
writer held (`chain`: the opcode at every position from its start and
each opcode-12 op's claims, recorded before a GC can drop them) with the
async buffer it started with.

TLS (`comm/tls.py`): with `tls` (a server context) every connection is
wrapped in its own thread, the handshake bounded to 10 s, so a plaintext
or stalled peer is closed and never blocks the accept loop.  Validators
are dialled in plaintext, as in the reference.

Certified snapshots (`ledger/snapshot.py`): with `snapshot_interval` K
the writer appends a snapshot op (opcode 9) after every commit whose new
epoch is a multiple of K; once it is certified (at once without BFT) the
monitor loop writes the artifact under `snapshot_dir` (the newest
`snapshot_keep` kept) outside the lock, then garbage-collects the log,
the WAL (to `BFLCWAL2`), the op auth evidence and the certificates below
it, never past the slowest live subscriber's send watermark.  `info`
reports `log_base`, the `snapshot` method serves the newest finalized
offer, a subscriber asking from below the base gets a `state_sync` frame
and a lagging validator installs the snapshot through `bft_snapshot`.  A
promoted standby passes the snapshot it mirrored as `resume_snapshot`.
`BFLC_SNAPSHOT_LEGACY=1` keeps every snapshot op off the chain.

Asynchronous buffered aggregation (FedBuff, reference :519-528,
:1499-1515, :1692-1900): when `ledger/base.async_enabled(cfg)` the
writer refuses sync `upload`/`scores` and serves `aupload` (a delta
tagged with the base epoch it trained from), `aupdates` (the buffer, the
committee's scoring surface) and `ascores` ((admission seq, score)
pairs, whose replay check scans the staleness window,
`_seen_in_window`).  The K-th admission drains the oldest K entries
inside its own request, with the lock held: the merge runs on the
engine at the FedBuff weights n / sqrt(1 + s) (B5 on the card at the
genome's block count), the opcode-12 op carries the drain's seating
every `async_reseat_every`-th drain, and a snapshot follows as after a
sync commit.  The replay guard prunes at `epoch - max_staleness`, a
stalled buffer drains what it holds, `info` reports
`async_buffer_depth` and `eff_staleness`, and the op stream piggybacks
opcode 10's blob and opcode 12's model.  The snapshot GC keeps the
by-hash certificates of the window it drops until the next GC, so an
ack whose GC overtook its certify loop still carries its op's
certificate (C11; the reference prunes them at once).

Upload codecs (reference :529-538, :1959-1990, :2010-2020): admission
(`_decode_delta`) dequantizes only when `cfg.delta_dtype` is not f32
and densifies only in sparse mode (`codecs.sparse_enabled`), so an
f16 blob in an f32 fleet, or a `#topk` record in a dense one, dies as a
schema error as in the reference; the decoded dense image is staged for
the merge, so B5's rows and every pinned hash are those of a dense
delta.  A row re-derived from its blob (`_staged_row`) and the host leg
of the merge and the drain decode through `densify_entries(
dequantize_entries(...))`.  In sparse mode the upload's and the
aupload's blob ride their auth evidence (validators re-execute the
decode, `comm/bft.check_sparse_upload_op`) and stay there, as in the
reference, until the snapshot GC drops the op auth below its base.
With `BFLC_PROC_TRACE=1` the writer charges `admit.decode_s` per
admitted blob.

Hierarchical cells (reference :509-518, :1420-1431, :2010-2064): with
`cell_registry` the server is a root whose clients are cell aggregators
(`hier/`); `_decode_cell_partial` admits a cell partial with every
refusal reason of the reference's, and the merge (the staged rows and
the host leg's `_decoded`) runs over the partials with their #cellmeta
entry stripped, on B5 on the card.

The validator re-derivation plane (reference :548-561, :1286-1330,
:1471-1483; `rederive/`): armed (`BFLC_REDERIVE` shard/full), every
commit's auth evidence carries the claimed model blob (`mblob`), the
read set (`rs`) and this writer's endpoint (`co`), and the round's
consumed blobs (the admitted deltas and the previous model) stay
servable one round (`_rederive_blobs`, behind `_blob_lookup`); the
previous commit's `mblob` and the round's cell evidence are dropped
then.  The evidence goes on the commit op's own position: the
reference attaches it to the last op, which on a genome round is the
genome op, so its validators skip that round's commit.  At a hier root
a cell upload's member-signed listing (`cell_ev`) rides its evidence,
and stays there until the op is certified: the reference drops it at
the round's commit, which can come while the last cell's upload is
still being certified, and its validators then skip that partial.

The closed compression loop (reference :539-547, :1569-1576,
:2179-2240): with `ledger/base.adapt_enabled(cfg)` the writer proposes a
genome-update op (opcode 13) right after every due commit, from
`control/loop.model_telemetry` over the old and new model on the host
(numpy, f64 then one f32 round), and `state` and `info` replies carry
`eff_density` and `eff_staleness` (`info` also `genome_epoch`).

Not ported, each raising or refusing with its ROADMAP item when asked
for: telemetry, health and causal traces (A14).
`BFLC_DATA_PLANE_LEGACY=1` drops the model piggyback and the read set,
as in the reference.
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bflc_demo_tpu_torch.comm.dataplane import data_plane_legacy, handle_read
from bflc_demo_tpu_torch.comm.identity import (PublicDirectory, ReplayGuard,
                                               _op_bytes, address_of,
                                               verify_signature)
from bflc_demo_tpu_torch.comm.wire import (WireError, blob_bytes, recv_msg,
                                           send_msg)
from bflc_demo_tpu_torch.device import DeviceLike
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.ledger.base import (OP_ACOMMIT, OP_AUPLOAD,
                                             OP_COMMIT, OP_REGISTER,
                                             OP_UPLOAD, adapt_enabled,
                                             ascores_sign_payload,
                                             async_enabled, decode_op,
                                             parse_acommit, reduce_blocks)
from bflc_demo_tpu_torch.meshagg.engine import (ENGINE, MeshAggEngine,
                                                engine_for, flatten_delta)
from bflc_demo_tpu_torch.ops import launch_counts
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.protocol.constants import bft_quorum as _bft_quorum
from bflc_demo_tpu_torch.rederive import rederive_armed
from bflc_demo_tpu_torch.utils import tracing
from bflc_demo_tpu_torch.utils.serialization import (densify_entries,
                                                     dequantize_entries,
                                                     pack_entries,
                                                     sparse_enabled,
                                                     unpack_pytree)

# the replaced models a writer keeps for the op stream's piggyback (C14):
# a follower lagging this many commits still gets each commit's model
PAST_MODELS = 4

# admission-control gas (the reference's per-sender per-epoch budget)
GAS_REGISTER = 1_000
GAS_UPLOAD_BASE = 1_000
GAS_SCORES = 500

# wire methods of unported paths: refused by name, never "unknown"
_UNPORTED_METHODS = {"telemetry": "A14 (telemetry)"}

# the TLS handshake's bound, in the connection's own thread
_HANDSHAKE_TIMEOUT_S = 10.0


def shutdown_read(conn: socket.socket) -> None:
    """Shut the read side of `conn` so its serving thread sees EOF while
    replies in flight still go out.  On a TLS socket this goes to the raw
    socket: `SSLSocket.shutdown` drops the TLS session first, and every
    later reply would leave in plaintext."""
    try:
        socket.socket.shutdown(conn, socket.SHUT_RD)
    except OSError:
        pass


def refuse_unported(options: Dict[str, object],
                    table: Dict[str, str]) -> None:
    """Raise naming the ROADMAP item of every option that was asked for
    (truthy) and is not ported; unknown names are a TypeError."""
    unknown = sorted(set(options) - set(table))
    if unknown:
        raise TypeError(f"unexpected options {unknown}")
    asked = {k: table[k] for k, v in options.items() if v}
    if asked:
        raise NotImplementedError("not ported yet: " + ", ".join(
            f"{k} (ROADMAP {item})" for k, item in sorted(asked.items())))


def chain_head_at(ledger, upto: int) -> bytes:
    """Digest of the op hash chain after ops[0..upto-1] (b"" at 0)."""
    head_at = getattr(ledger, "head_at", None)
    if head_at is not None:
        return head_at(upto)
    h = b""
    for i in range(upto):
        d = hashlib.sha256()
        if h:
            d.update(h)
        d.update(ledger.log_op(i))
        h = d.digest()
    return h


_PROMO_MAGIC = b"BFLCPROM1"


def _promotion_evidence_bytes(gen: int, ix: int, prev_head: bytes,
                              standby_index: int) -> bytes:
    return (_PROMO_MAGIC + struct.pack("<qqI", gen, ix, standby_index)
            + prev_head)


def make_promotion_evidence(ledger, wallet, standby_index: int) -> dict:
    """Signed, chain-bound proof of the promotion this standby just
    fenced.  Call after `promote_writer` appended its op (at log_size-1):
    binds (generation, op position, the chain head just before the
    promote op, the standby's index) under the standby's Ed25519 key.
    Ed25519 is deterministic, so this dict equals the reference's for
    the same wallet and chain."""
    ix = ledger.log_size() - 1
    prev = chain_head_at(ledger, ix)
    gen = ledger.generation
    sig = wallet.sign(_promotion_evidence_bytes(gen, ix, prev,
                                                standby_index))
    return {"gen": gen, "ix": ix, "prev": prev.hex(),
            "sb": standby_index, "sig": sig.hex()}


def verify_promotion_signature(ev, standby_keys) -> bool:
    """True iff the evidence parses and is signed by the provisioned
    standby it names — what a client can check without the chain."""
    try:
        gen, ix, sb = int(ev["gen"]), int(ev["ix"]), int(ev["sb"])
        prev = bytes.fromhex(ev["prev"])
        sig = bytes.fromhex(ev["sig"])
    except (KeyError, TypeError, ValueError):
        return False
    pub = (standby_keys or {}).get(sb)
    if pub is None:
        return False
    return verify_signature(pub, _promotion_evidence_bytes(gen, ix, prev,
                                                           sb), sig)


def verify_promotion_evidence(ev, ledger, standby_keys) -> bool:
    """True iff `ev` proves a promotion past `ledger`'s generation on a
    chain sharing this ledger's prefix, signed by a provisioned standby:
    the signature, a generation above ours, and the chain binding (the
    claimed head equals ours at the claimed position)."""
    if not verify_promotion_signature(ev, standby_keys):
        return False
    gen, ix = int(ev["gen"]), int(ev["ix"])
    if gen <= ledger.generation or not 0 <= ix <= ledger.log_size():
        return False
    try:
        return chain_head_at(ledger, ix) == bytes.fromhex(ev["prev"])
    except ValueError:
        # the claimed position lies below our GC base: the binding cannot
        # be proven, and unverifiable evidence never demotes a writer
        return False


def _aggregate_flat(global_flat: Dict[str, np.ndarray],
                    delta_flats: List[Dict[str, np.ndarray]],
                    weights: List[float], selected: List[int],
                    lr: float, blocks: int = 1,
                    engine: Optional[MeshAggEngine] = None
                    ) -> Dict[str, np.ndarray]:
    """Server-side FedAvg on flat entries: global -= lr * the weighted
    mean of the selected deltas, through the certified merge engine
    (REDUCTION SPEC v2; both legs give the same bytes)."""
    return (engine or ENGINE).aggregate_flat(
        global_flat, delta_flats, weights, selected, lr, blocks=blocks)


class LedgerServer:
    """Coordinator process body: socket server + aggregator + stall
    monitor.  `serve_forever()` blocks (a dedicated process);
    `start()` serves from background threads (tests)."""

    def __init__(self, cfg: ProtocolConfig, initial_model_blob: bytes,
                 host: str = "127.0.0.1", port: int = 0, *,
                 directory: Optional[PublicDirectory] = None,
                 ledger_backend: str = "auto",
                 wal_path: str = "",
                 require_auth: bool = True,
                 stall_timeout_s: float = 10.0,
                 resume_ledger=None,
                 resume_blobs: Optional[Dict[bytes, bytes]] = None,
                 sock: Optional[socket.socket] = None,
                 standby_keys: Optional[Dict[int, bytes]] = None,
                 promotion_evidence: Optional[dict] = None,
                 gas_budget_per_epoch: Optional[int] = None,
                 quorum: int = 0,
                 quorum_timeout_s: float = 5.0,
                 bft_validators: Optional[List[Tuple[str, int]]] = None,
                 bft_keys: Optional[Dict[int, bytes]] = None,
                 bft_quorum: Optional[int] = None,
                 bft_timeout_s: float = 10.0,
                 resume_certs: Optional[Dict[int, dict]] = None,
                 tls=None,
                 snapshot_interval: int = 0,
                 snapshot_dir: str = "",
                 snapshot_keep: int = 2,
                 resume_snapshot: Optional[dict] = None,
                 cell_registry: Optional[Dict[str, Tuple[int, int]]] = None,
                 device: DeviceLike = None,
                 verbose: bool = False):
        """resume_ledger/resume_blobs/sock/resume_certs/resume_snapshot:
        the promotion surface — a server over a standby's replayed (and
        possibly compacted) ledger, its mirrored blobs, certificates and
        snapshot, the current model blob as `initial_model_blob`, and the
        socket it bound at start, whose backlog holds the failed-over
        clients."""
        from bflc_demo_tpu_torch.ledger.snapshot import snapshot_legacy
        cfg.validate()
        self.cfg = cfg
        self.verbose = verbose
        # FedBuff on the certified op stream: one protocol per chain, so
        # sync upload/scores are refused while it is on
        self._async = async_enabled(cfg)
        # hierarchical cells (`hier/`): with a registry (aggregator
        # address -> (cell index, registered membership)) this server is
        # a ROOT — every upload is a cell partial carrying the #cellmeta
        # evidence entry, admitted by `_decode_cell_partial` and merged
        # with that entry stripped
        self._cell_registry: Optional[Dict[str, Tuple[int, int]]] = (
            dict(cell_registry) if cell_registry is not None else None)
        # sparse upload deltas (delta_density < 1): admission decodes
        # through the one densify inverse and stages the dense image, and
        # the upload ops' evidence carries the blob for the validators
        self._sparse = sparse_enabled(cfg)
        # the closed compression loop: a certified genome-update op
        # after every adapt_every-th commit
        self._adapt = adapt_enabled(cfg)
        # the re-derivation plane: commit evidence and one round of
        # blob retention for the validators' fetches
        self._rederive = rederive_armed()
        self._rederive_blobs: Dict[bytes, bytes] = {}
        self._rederive_commit_pos: Optional[int] = None
        self._rederive_cell_auth: List[int] = []
        # ssl.SSLContext (comm/tls.server_context) or None for plaintext
        self._tls = tls
        # certified snapshots: 0 or BFLC_SNAPSHOT_LEGACY keeps every
        # snapshot op off the chain
        self._snap_interval = (0 if snapshot_legacy()
                               else max(int(snapshot_interval), 0))
        self._snap_dir = snapshot_dir
        self._snap_keep = max(int(snapshot_keep), 1)
        # the newest snapshot meta {i, epoch, gen, op, prev_head, cert,
        # state, model, final} and the last finalized one, which stays
        # servable while the next is being certified
        self._latest_snapshot: Optional[dict] = (
            dict(resume_snapshot) if resume_snapshot else None)
        self._served_snapshot: Optional[dict] = None
        # one record a snapshot op: position, epoch, the artifact's bytes
        # and write seconds, the ops its GC dropped
        self.snapshot_log: List[dict] = []
        self.require_auth = require_auth
        self.stall_timeout_s = stall_timeout_s
        self._open_enrollment = directory is None
        self.directory = directory if directory is not None \
            else PublicDirectory()
        # one lock serializes ledger + blob + model state (the consensus
        # point); subscribers and `wait` callers sleep on the condition
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        if self._snap_interval and resume_ledger is None:
            # compaction needs the python ledger (the native one has no
            # state-injection or GC ABI; it still applies snapshot ops,
            # so native replicas and validators stay chain-compatible)
            if ledger_backend == "native":
                raise ValueError(
                    "snapshot_interval > 0 needs the python ledger "
                    "backend (the native ledger cannot compact its log)")
            ledger_backend = "python"
        self.ledger = (resume_ledger if resume_ledger is not None
                       else make_ledger(cfg, backend=ledger_backend))
        if wal_path and not self.ledger.attach_wal(wal_path):
            raise RuntimeError(f"cannot attach WAL at {wal_path}")
        # the merge engine on the server's device (B5 on the card)
        self.engine = engine_for(device)
        self._blobs: Dict[bytes, bytes] = dict(resume_blobs or {})
        # payload hash -> the admitted delta's flattened row, staged at
        # admission for the mesh leg (re-derived from the blob if absent)
        self._staged: Dict[bytes, np.ndarray] = {}
        self._model_blob = initial_model_blob
        self._model_hash = hashlib.sha256(initial_model_blob).digest()
        # the models the last commits replaced, by hash (C14): the op
        # stream piggybacks each commit's own model to a follower that
        # lags behind later commits, as it does the newest
        self._past_models: Dict[bytes, bytes] = {}
        self._model_schema = {k: (a.shape, a.dtype) for k, a in
                              unpack_pytree(initial_model_blob).items()}
        self._gas_budget = (50 * (GAS_UPLOAD_BASE + len(initial_model_blob))
                            if gas_budget_per_epoch is None
                            else gas_budget_per_epoch)
        self._gas: Dict[str, Tuple[int, int]] = {}
        # quorum-ack: per subscriber, the highest op it acked, the highest
        # it was sent, whether its acks count, and its read endpoint
        self._quorum = quorum
        self._quorum_timeout_s = quorum_timeout_s
        self._sub_acked: Dict[object, int] = {}
        self._sub_sent: Dict[object, int] = {}
        self._sub_eligible: Dict[object, bool] = {}
        self._sub_read_ep: Dict[object, Tuple[str, int]] = {}
        self._last_seen: Dict[str, float] = {}
        self._replay = ReplayGuard()
        self._last_progress = time.monotonic()
        self._rounds_completed = 0
        # one record a commit: epoch, seconds since start, the merge's
        # seconds and leg — the writer's own clock of a round
        self._t0 = time.monotonic()
        self._t0_base = self.ledger.log_base    # a compacted resume: > 0
        self.merge_log: List[dict] = []
        # one record a genome-update op this writer proposed
        self.genome_log: List[dict] = []
        # the chain this writer held, scanned before any GC can drop it:
        # the opcode at every position from its start and every
        # opcode-12 op's claims
        self._chain = {"from": self.ledger.log_base, "opcodes": [],
                       "acommits": []}
        self._t0_abuf = ([e.aseq for e in self.ledger.async_buffer_view()]
                         if self._async else [])
        self._scan_chain()
        self._stop = threading.Event()
        # accepted connections, shut down by close(): a closed writer is a
        # dead one to every peer, as a killed process is
        self._conns: set = set()
        # set when verified promotion evidence shows a newer writer
        self.fenced = threading.Event()
        # index -> Ed25519 public bytes of the provisioned standbys: the
        # only identities whose evidence can demote this writer
        self._standby_keys: Dict[int, bytes] = dict(standby_keys or {})
        self._promotion_evidence = promotion_evidence
        # the reference's control-plane baseline switch: one op a
        # certification round trip and no op-stream blob piggyback
        self._legacy = bool(os.environ.get("BFLC_CONTROL_PLANE_LEGACY"))
        self._cert_batch = 1 if self._legacy else 128
        # BFT commit certificates: chain position -> wire certificate,
        # and by op hash (an ack carries the certificate of the op its
        # request implies); certification is strictly sequential under
        # _cert_lock; _op_auth is the client evidence validators check
        self._bft = None
        self._certs: Dict[int, dict] = dict(resume_certs or {})
        self._certs_by_ophash: Dict[str, dict] = {
            c["op_hash"]: c for c in self._certs.values()
            if isinstance(c, dict) and "op_hash" in c}
        self._cert_lock = threading.Lock()
        self._op_auth: Dict[int, dict] = {}
        self._certified_size = 0
        self._cert_head = b"\0" * 32
        if bft_validators:
            from bflc_demo_tpu_torch.comm.bft import CertificateAssembler
            q = bft_quorum if bft_quorum is not None \
                else _bft_quorum(len(bft_validators))
            if not 0 < q <= len(bft_validators):
                raise ValueError(f"bft_quorum {q} out of range for "
                                 f"{len(bft_validators)} validators")
            self._bft = CertificateAssembler(
                bft_validators, bft_keys or {}, q,
                timeout_s=bft_timeout_s, backlog_fn=self._bft_backlog)
            # a promoted chain arrives fully certified: the standby
            # refused uncertified appends and certified its fence op.
            # Positions count from 0 whatever was GC'd: below the base
            # the certificates went with the prefix
            self._certified_size = self.ledger.log_size()
            if self._certified_size:
                self._cert_head = self.ledger.log_head()
            missing = [j for j in range(self.ledger.log_base,
                                        self._certified_size)
                       if j not in self._certs]
            if missing:
                raise ValueError(
                    f"BFT resume: {self._certified_size} chain ops but "
                    f"no certificate for {len(missing)} of them")
        self._threads: List[threading.Thread] = []
        if sock is not None:
            self._sock = sock
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()

    # ------------------------------------------------------------------ run
    def start(self) -> None:
        """Accept + monitor threads in the background."""
        for target in (self._accept_loop, self._monitor_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.1)
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        if self._bft is not None:
            self._bft.close()
        with self._cv:
            self._cv.notify_all()
            conns = list(self._conns)
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in conns:
            shutdown_read(conn)             # replies in flight still go

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._cv:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    # ----------------------------------------------------------- connection
    def _handshake(self, raw: socket.socket) -> Optional[socket.socket]:
        """The TLS server handshake, bounded; None (the peer closed) for a
        plaintext or broken peer."""
        import ssl
        tr = tracing.PROC
        t0 = time.perf_counter()
        try:
            raw.settimeout(_HANDSHAKE_TIMEOUT_S)
            conn = self._tls.wrap_socket(raw, server_side=True)
            conn.settimeout(None)
        except (ssl.SSLError, OSError):
            with self._cv:
                self._conns.discard(raw)
            try:
                raw.close()
            except OSError:
                pass
            tr.charge("tls.refused")
            return None
        if tr.enabled:
            tr.charge("tls.handshake_s", time.perf_counter() - t0)
            tr.charge("tls.handshakes")
        with self._cv:
            self._conns.discard(raw)
            if self._stop.is_set():
                shutdown_read(conn)
            self._conns.add(conn)
        return conn

    def _serve_conn(self, conn: socket.socket) -> None:
        if self._tls is not None:
            conn = self._handshake(conn)
            if conn is None:
                return
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                if msg is None or self._stop.is_set():
                    # a closed writer serves nothing that reached its
                    # socket after close(): shutting the read side does
                    # not drop bytes already queued when this thread
                    # wakes (C20)
                    return
                method = msg.get("method", "")
                if method == "subscribe":
                    self._subscribe(conn, msg)
                    return
                if self._fenced_by(conn, msg):
                    return
                try:
                    reply = self._dispatch(method, msg)
                    post_size = reply.pop("_post_size", None)
                    if self._bft is not None and post_size is not None:
                        # the ack carries only co-signed state: certify
                        # the ops this request appended (and before)
                        reply = self._certified_reply(method, msg, reply,
                                                      post_size)
                        if reply.get("status") == "CERT_TIMEOUT":
                            post_size = None
                    if self._quorum and post_size is not None and \
                            not self._await_quorum(post_size):
                        # the op is in the local chain but not provably on
                        # quorum replicas: a signed retry is safe once the
                        # followers catch up (DUPLICATE = progress)
                        reply = {"ok": False,
                                 "status": "REPLICATION_TIMEOUT",
                                 "error": "op not yet on quorum replicas"}
                except Exception as e:      # noqa: BLE001 — any dispatch
                    # failure (an aggregation error inside a scores call
                    # included) answers an error frame, so the caller is
                    # never left blocked on a dead connection thread
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                reply.setdefault("gen", self.ledger.generation)
                if self._promotion_evidence is not None:
                    reply.setdefault("gen_ev", self._promotion_evidence)
                send_msg(conn, reply)
        except (WireError, OSError):
            pass
        finally:
            with self._cv:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _certified_reply(self, method: str, msg: dict, reply: dict,
                         post_size: int) -> dict:
        """`reply` with the certificate of the op the request implies
        (its own fields rebuild the op: a DUPLICATE-class retry gets the
        original op's), or CERT_TIMEOUT when no quorum co-signed."""
        from bflc_demo_tpu_torch.comm.bft import expected_op_hash
        cert = self._ensure_certified(post_size)
        if cert is None:
            return {"ok": False, "status": "CERT_TIMEOUT",
                    "error": "no validator quorum co-signed the op"}
        oh = expected_op_hash(method, msg)
        if oh is not None:
            cert = self._certs_by_ophash.get(oh.hex())
        reply["cert"] = cert
        return reply

    # ------------------------------------------------- commit certificates
    def _bft_backlog(self, j: int):
        """(op, auth evidence, certificate) of chain position j: what a
        lagging or rejoining validator replays.  The evidence lives in
        this process only (after a promotion it is gone for earlier ops,
        and the certificate admits them); a register op's pubkey is
        recovered from the directory so the rejoined validator's mirror
        stays complete.  Below the GC base the ops are gone: it raises
        `PrefixCompacted` with the snapshot offer, which the assembler
        installs on the validator (`bft_snapshot`)."""
        with self._lock:
            base = self.ledger.log_base
            if j < base:
                from bflc_demo_tpu_torch.comm.bft import PrefixCompacted
                raise PrefixCompacted(
                    self._snapshot_offer(require_model=False), base)
            op = self.ledger.log_op(j)
            auth = self._op_auth.get(j)
            if auth is None and op and op[0] == OP_REGISTER:
                try:
                    (n,) = struct.unpack_from("<q", op, 1)
                    pub = self.directory.export_raw().get(
                        op[9:9 + n].decode())
                    if pub is not None:
                        auth = {"pubkey": pub.hex()}
                except (struct.error, UnicodeDecodeError):
                    pass
            return op, auth, self._certs.get(j)

    def _ensure_certified(self, upto: int,
                          timeout_s: Optional[float] = None
                          ) -> Optional[dict]:
        """Certify ops [certified_size, upto); the wire certificate of op
        upto-1, or None when no quorum signs within the timeout.

        Strictly sequential under _cert_lock (each certificate chains on
        the previous head); votes are gathered without the ledger lock.
        Each pass drains the whole uncertified backlog, at most
        `_cert_batch` ops, in one `certify_range` round trip per
        validator; a position the batch cannot certify goes through the
        single-op `certify` and its repair rounds."""
        if self._bft is None:
            return None
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self._bft.timeout_s)
        tr = tracing.PROC
        with self._cert_lock:
            while self._certified_size < upto:
                if self._stop.is_set():
                    return None
                i = self._certified_size
                prev = self._cert_head
                with self._lock:
                    hi = min(max(upto, self.ledger.log_size()),
                             i + self._cert_batch)
                    entries = [(self.ledger.log_op(j), self._op_auth.get(j))
                               for j in range(i, hi)]
                if len(entries) > 1:
                    t0 = time.perf_counter()
                    certs = self._bft.certify_range(i, entries, prev)
                    installed = 0
                    for k, cert in enumerate(certs):
                        if cert is None:
                            break
                        self._install_certificate(i + k, entries[k][0],
                                                  cert.to_wire())
                        installed += 1
                    if tr.enabled:
                        dt = time.perf_counter() - t0
                        tr.charge("bft.certify_s", dt)
                        tr.charge("bft.certify_batch_s", dt)
                        if installed:
                            tr.charge("bft.certify_batched_ops", installed)
                    if installed:
                        with self._cv:
                            self._cv.notify_all()
                        continue
                op, auth = entries[0]
                t0 = time.perf_counter()
                cert = self._bft.certify(i, op, auth, prev)
                if tr.enabled:
                    dt = time.perf_counter() - t0
                    tr.charge("bft.certify_s", dt)
                    tr.charge("bft.certify_single_s", dt)
                if cert is None:
                    if self._bft.superseded_op is not None:
                        # the quorum mandated a foreign op at our position:
                        # another proposer writes the canonical chain and
                        # our suffix cannot certify — fence ourselves
                        self._say("certification superseded by a foreign "
                                  "proposer: self-demoting")
                        self.fenced.set()
                        self.close()
                        return None
                    if time.monotonic() > deadline:
                        return None
                    # a transient quorum failure: retry within the budget,
                    # never hot-spinning on refused connects
                    time.sleep(0.2)
                    continue
                self._install_certificate(i, op, cert.to_wire())
                if tr.enabled:
                    tr.charge("bft.certify_single_ops")
                with self._cv:
                    self._cv.notify_all()   # wake the op-stream pushers
            return self._certs.get(upto - 1)

    def _install_certificate(self, i: int, op: bytes, wire: dict) -> None:
        """Record op i's certificate and advance the watermark (the
        caller holds _cert_lock)."""
        from bflc_demo_tpu_torch.comm.bft import next_head
        self._certs[i] = wire
        self._certs_by_ophash[wire["op_hash"]] = wire
        self._cert_head = next_head(self._cert_head, op)
        self._certified_size = i + 1

    def _fenced_by(self, conn: socket.socket, msg: dict) -> bool:
        """Demote on a fence above our generation that carries verified
        promotion evidence: answer STALE_WRITER once, then close."""
        try:
            fence = int(msg.get("fence", -1))
        except (TypeError, ValueError):
            return False
        ev = msg.get("fence_ev")
        if fence <= self.ledger.generation or not isinstance(ev, dict):
            return False
        with self._lock:
            verified = verify_promotion_evidence(ev, self.ledger,
                                                 self._standby_keys)
        if not verified:
            return False
        try:
            send_msg(conn, {"ok": False, "status": "STALE_WRITER",
                            "gen": self.ledger.generation,
                            "observed_fence": fence})
        finally:
            self.fenced.set()
            self.close()
        return True

    def _subscribe(self, conn: socket.socket, msg: dict) -> None:
        start = int(msg.get("from", 0))
        eligible = "sb" in msg and self._subscriber_handshake(conn, msg,
                                                              start)
        read_ep = None
        if eligible and isinstance(msg.get("read_ep"), (list, tuple)):
            # only an authenticated standby enters the read set
            try:
                read_ep = (str(msg["read_ep"][0]), int(msg["read_ep"][1]))
            except (TypeError, ValueError, IndexError):
                read_ep = None
        self._stream_ops(conn, start, eligible, read_ep)

    def _stream_ops(self, conn: socket.socket, start: int,
                    quorum_eligible: bool,
                    read_ep: Optional[Tuple[str, int]] = None) -> None:
        """Push canonical op bytes from `start` on until the peer leaves,
        an upload's payload blob or a commit's model blob riding its op's
        frame (not under the legacy switch); with BFT only certified ops,
        each with its certificate.  A reader thread drains the
        subscriber's `{"ack": i}` frames (unconditionally, so an acking
        follower never wedges on a full send buffer) and wakes the
        quorum waiters."""
        sub_id = object()
        with self._cv:
            # clamp the claimed start to the real log: a subscriber cannot
            # ack (and fake durability for) ops it was never sent
            start = max(0, min(start, self.ledger.log_size()))
            base = self.ledger.log_base
            if start >= base:
                # registered under the lock of the base check, so the
                # snapshot GC's subscriber clamp sees this stream at once
                self._sub_acked[sub_id] = -1
                self._sub_sent[sub_id] = start - 1
                self._sub_eligible[sub_id] = quorum_eligible
                if read_ep is not None:
                    self._sub_read_ep[sub_id] = read_ep
        if start < base:
            # the resume point was GC'd behind a certified snapshot: the
            # subscriber must install the snapshot and resume at its tail
            try:
                send_msg(conn, {"state_sync": 1, "base": base})
            except (WireError, OSError):
                pass
            return
        threading.Thread(target=self._ack_reader, args=(conn, sub_id),
                         daemon=True).start()
        try:
            next_i = start
            while not self._stop.is_set():
                with self._cv:
                    size = self.ledger.log_size()
                    if self._bft is not None:
                        # a standby never replicates (or acks) state no
                        # validator quorum co-signed
                        size = min(size, self._certified_size)
                    ops = [self.ledger.log_op(i)
                           for i in range(next_i, min(size, next_i + 256))]
                    if not ops:
                        self._cv.wait(timeout=0.5)
                        continue
                    # the sent watermark moves before the lock-free send,
                    # or an ack racing it would be clamped down and lost
                    self._sub_sent[sub_id] = next_i + len(ops) - 1
                for i, op in enumerate(ops):
                    frame = {"i": next_i + i, "op": op.hex()}
                    if self._bft is not None:
                        frame["cert"] = self._certs.get(next_i + i)
                    blob = (None if self._legacy
                            else self._op_payload_blob(op))
                    if blob is not None:
                        frame["blob"] = blob
                    send_msg(conn, frame)
                next_i += len(ops)
        except (WireError, OSError):
            pass
        finally:
            with self._cv:
                for table in (self._sub_acked, self._sub_sent,
                              self._sub_eligible, self._sub_read_ep):
                    table.pop(sub_id, None)
                self._cv.notify_all()

    def _op_payload_blob(self, op: bytes) -> Optional[bytes]:
        """The blob a streamed op references, while this writer holds it:
        an upload's payload, or a commit's new model (unless the data
        plane's fast path is pinned off), the newest or one of the
        PAST_MODELS before it (C14)."""
        if not op or op[0] not in (OP_UPLOAD, OP_AUPLOAD, OP_COMMIT,
                                   OP_ACOMMIT):
            return None
        fields = decode_op(op)
        with self._lock:
            if op[0] in (OP_COMMIT, OP_ACOMMIT):
                if data_plane_legacy():
                    return None
                mh = fields.get("model_hash")
                if mh == self._model_hash.hex():
                    return self._model_blob
                try:
                    return self._past_models.get(bytes.fromhex(mh or ""))
                except ValueError:
                    return None
            try:
                return self._blobs.get(bytes.fromhex(
                    fields.get("payload_hash", "")))
            except ValueError:
                return None

    def _ack_reader(self, conn: socket.socket, sub_id: object) -> None:
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    return
                try:
                    i = int(msg.get("ack", -1))
                except (TypeError, ValueError):
                    continue
                with self._cv:
                    if sub_id not in self._sub_acked:
                        return
                    i = min(i, self._sub_sent.get(sub_id, -1))
                    if i > self._sub_acked[sub_id]:
                        self._sub_acked[sub_id] = i
                        self._cv.notify_all()
        except (WireError, OSError):
            return

    def _await_quorum(self, post_size: int) -> bool:
        """Block until `quorum` eligible subscribers acked through op
        post_size - 1 (the requester's own op), or the timeout.  With no
        standby keys provisioned every subscriber counts."""
        tr = tracing.PROC
        t0 = time.monotonic()
        target = post_size - 1
        deadline = t0 + self._quorum_timeout_s
        held = False
        with self._cv:
            while not self._stop.is_set():
                n = sum(1 for s, a in self._sub_acked.items()
                        if a >= target and
                        (self._sub_eligible.get(s, False)
                         or not self._standby_keys))
                if n >= self._quorum:
                    held = True
                    break
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(rem)
        if tr.enabled:
            tr.charge("quorum.wait_s", time.monotonic() - t0)
            tr.charge("quorum.waits")
        return held

    _SUB_MAGIC = b"BFLCSUB1"

    def _subscriber_handshake(self, conn: socket.socket, msg: dict,
                              start: int) -> bool:
        """Challenge-response proof of a provisioned standby identity: the
        subscriber signs (magic || fresh challenge || <Iq index, start>).
        On any failure the peer still streams, without quorum
        eligibility."""
        try:
            sb = int(msg.get("sb", -1))
        except (TypeError, ValueError):
            return False
        pub = self._standby_keys.get(sb)
        challenge = os.urandom(16)
        try:
            send_msg(conn, {"challenge": challenge.hex()})
            conn.settimeout(10.0)
            reply = recv_msg(conn)
            conn.settimeout(None)
        except (WireError, OSError):
            return False
        if pub is None or not isinstance(reply, dict):
            return False
        try:
            sig = bytes.fromhex(reply.get("tag", ""))
        except (TypeError, ValueError):
            return False
        return verify_signature(pub, self._SUB_MAGIC + challenge
                                + struct.pack("<Iq", sb, start), sig)

    def _read_set(self) -> List[Tuple[str, int]]:
        """The read endpoints authenticated standbys advertised."""
        if data_plane_legacy():
            return []
        with self._cv:
            return sorted(set(self._sub_read_ep.values()))

    # ------------------------------------------------------------- dispatch
    def _touch(self, addr: str) -> None:
        self._last_seen[addr] = time.monotonic()

    def _verify(self, kind: str, addr: str, epoch: int, payload: bytes,
                tag_hex: str) -> LedgerStatus:
        """OK = a fresh valid tag; DUPLICATE = valid but consumed (an
        honest retry or a replay: the op is in either way); BAD_ARG = a
        signature failure."""
        if not self.require_auth:
            return LedgerStatus.OK
        tag = bytes.fromhex(tag_hex)
        if not self.directory.verify(
                addr, _op_bytes(kind, addr, epoch, payload), tag):
            return LedgerStatus.BAD_ARG
        if self._replay.seen(epoch, tag):
            return LedgerStatus.DUPLICATE
        return LedgerStatus.OK

    def _consume_tag(self, epoch: int, tag_hex: str) -> None:
        if self.require_auth:
            # async mode prunes at the staleness floor: a tag bucket must
            # outlive every base epoch the staleness cap still admits, or
            # a pruned-then-replayed aupload would re-enter the buffer
            floor = self.ledger.epoch - (self.cfg.max_staleness
                                         if self._async else 0)
            self._replay.consume(floor, epoch, bytes.fromhex(tag_hex))

    def _seen_in_window(self, tag: bytes) -> bool:
        """Replay check across the staleness window: an ascores tag
        signs no epoch, so its bucket is the ledger epoch at admission
        and a replay can hide in any live bucket."""
        ep = self.ledger.epoch
        return any(self._replay.seen(e, tag)
                   for e in range(max(ep - self.cfg.max_staleness, 0),
                                  ep + 1))

    def _charge_gas(self, addr: str, cost: int) -> bool:
        """Debit `cost` from addr's budget for the current epoch; False =
        out of gas.  Called with the lock held and only after the
        request's signature verified, so gas binds to a proven identity;
        the table is bounded against address-rotation spam."""
        if not self._gas_budget:
            return True
        ep = self.ledger.epoch
        last_ep, used = self._gas.get(addr, (ep, 0))
        if last_ep != ep:
            used = 0
        if used + cost > self._gas_budget:
            if addr in self._gas:
                self._gas[addr] = (ep, used)
            return False
        if addr not in self._gas and len(self._gas) >= 8192:
            self._gas = {a: (e, u) for a, (e, u) in self._gas.items()
                         if e == ep}
            while len(self._gas) >= 8192:
                self._gas.pop(next(iter(self._gas)))
        self._gas[addr] = (ep, used + cost)
        return True

    _OUT_OF_GAS = {"ok": False, "status": "OUT_OF_GAS",
                   "error": "per-epoch storage budget exhausted"}

    @staticmethod
    def _auth_error(v: LedgerStatus) -> dict:
        return {"ok": False, "status": v.name,
                "error": ("bad signature" if v == LedgerStatus.BAD_ARG
                          else "replayed tag")}

    _MUTATING = ("register", "upload", "scores", "aupload", "ascores")

    def _dispatch(self, method: str, m: dict) -> dict:
        with self._lock:
            read = handle_read(
                method, m, blob_lookup=self._blob_lookup,
                model_state=lambda: (self.ledger.epoch, self._model_hash,
                                     self._model_blob),
                read_set=self._read_set)
            if read is not None:
                return read
            handler = getattr(self, "_m_" + method, None)
            if handler is not None:
                reply = handler(m)
                if method in self._MUTATING and (
                        reply.get("ok") or reply.get("status") in
                        ("DUPLICATE", "ALREADY_REGISTERED")):
                    # this op's chain position, taken under the lock: the
                    # quorum wait targets the requester's own op, and an
                    # "already in" retry waits too
                    reply["_post_size"] = self.ledger.log_size()
                return reply
            if method in _UNPORTED_METHODS:
                return {"ok": False, "status": "BAD_ARG",
                        "error": f"{method!r} is not ported yet (ROADMAP "
                                 f"{_UNPORTED_METHODS[method]})"}
            return {"ok": False, "error": f"unknown method {method!r}"}

    def _m_register(self, m: dict) -> dict:
        addr = m["addr"]
        if self.require_auth:
            pub = bytes.fromhex(m.get("pubkey", ""))
            if self._open_enrollment:
                # trust on first use: the address must BE the key
                if address_of(pub) != addr:
                    return {"ok": False, "status": "BAD_ARG",
                            "error": "address/pubkey mismatch"}
                if not self.directory.knows(addr):
                    self.directory.enroll(pub)
            elif not self.directory.knows(addr):
                return {"ok": False, "status": "BAD_ARG",
                        "error": "unknown identity"}
            v = self._verify("register", addr, 0, b"", m.get("tag", ""))
            if v != LedgerStatus.OK:
                return self._auth_error(v)
        if not self._charge_gas(addr, GAS_REGISTER):
            return dict(self._OUT_OF_GAS)
        st = self.ledger.register_node(addr)
        if st == LedgerStatus.OK:
            self._consume_tag(0, m.get("tag", ""))
            # the validators re-verify the client's tag against their
            # own directory mirror, or a writer could fabricate the op
            self._op_auth[self.ledger.log_size() - 1] = {
                "tag": m.get("tag", ""), "pubkey": m.get("pubkey", "")}
        self._touch(addr)
        self._note_progress(st)
        return {"ok": st == LedgerStatus.OK, "status": st.name,
                "epoch": self.ledger.epoch}

    def _m_state(self, m: dict) -> dict:
        addr = m["addr"]
        self._touch(addr)
        role, epoch = self.ledger.query_state(addr)
        reply = {"ok": True, "role": role, "epoch": epoch,
                 "round_closed": self.ledger.round_closed}
        reply.update(self._state_knobs())
        return reply

    def _m_upload(self, m: dict) -> dict:
        if self._async:
            # a client whose BFLC_ASYNC_LEGACY disagrees with the fleet's
            # must not interleave sync rounds into an async chain
            return {"ok": False, "status": "BAD_ARG",
                    "error": "async mode is on: use aupload"}
        addr = m["addr"]
        blob = blob_bytes(m["blob"])
        digest = hashlib.sha256(blob).digest()
        if digest.hex() != m["hash"]:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "blob/hash mismatch"}
        payload = digest + struct.pack("<qd", int(m["n"]), float(m["cost"]))
        v = self._verify("upload", addr, int(m["epoch"]), payload,
                         m.get("tag", ""))
        if v != LedgerStatus.OK:
            if v == LedgerStatus.DUPLICATE:
                self._resupply_blob(digest, blob)
            return self._auth_error(v)
        # post-auth: base + payload bytes, so one identity cannot stream
        # unbounded blob traffic within an epoch's allowance
        if not self._charge_gas(addr, GAS_UPLOAD_BASE + len(blob)):
            return dict(self._OUT_OF_GAS)
        # structural admission check (post-auth, so unsigned spam buys no
        # decodes): a delta unlike the model dies here, not in the merge;
        # a root also holds the cell contract
        err, flat = (self._decode_cell_partial(addr, blob, int(m["n"]))
                     if self._cell_registry is not None
                     else self._decode_delta(blob))
        if err:
            return {"ok": False, "status": "BAD_ARG", "error": err}
        st = self.ledger.upload_local_update(
            addr, digest, int(m["n"]), float(m["cost"]), int(m["epoch"]))
        if st == LedgerStatus.OK:
            self._stage_delta(digest, flat)
            self._blobs[digest] = blob
            self._consume_tag(int(m["epoch"]), m.get("tag", ""))
            # the f64 originals ride along (the op stores f32, the tag
            # signs f64), and the sender's pubkey heals a validator's
            # directory hole
            auth = self._upload_auth(m, addr, blob)
            if self._cell_registry is not None and self._rederive \
                    and isinstance(m.get("cell_ev"), dict):
                # a hier root with the plane armed: the cell's
                # member-signed listing and its partial ride the
                # evidence (`Rederiver.check_cell`); the round's commit
                # drops them again once the op certified
                auth["cell"] = m["cell_ev"]
                auth.setdefault("blob", blob.hex())
                self._rederive_cell_auth.append(self.ledger.log_size() - 1)
            self._op_auth[self.ledger.log_size() - 1] = auth
        elif st == LedgerStatus.DUPLICATE:
            self._resupply_blob(digest, blob)
        self._touch(addr)
        self._note_progress(st)
        return {"ok": st == LedgerStatus.OK, "status": st.name}

    def _m_updates(self, m: dict) -> dict:
        return {"ok": True, "updates": [
            {"sender": u.sender, "hash": u.payload_hash.hex(),
             "n": u.n_samples, "cost": u.avg_cost}
            for u in self.ledger.query_all_updates()]}

    def _m_scores(self, m: dict) -> dict:
        if self._async:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "async mode is on: use ascores"}
        addr = m["addr"]
        scores = [float(s) for s in m["scores"]]
        payload = struct.pack(f"<{len(scores)}d", *scores)
        v = self._verify("scores", addr, int(m["epoch"]), payload,
                         m.get("tag", ""))
        if v != LedgerStatus.OK:
            return self._auth_error(v)
        if not self._charge_gas(addr, GAS_SCORES):
            return dict(self._OUT_OF_GAS)
        st = self.ledger.upload_scores(addr, int(m["epoch"]), scores)
        if st == LedgerStatus.OK:
            self._consume_tag(int(m["epoch"]), m.get("tag", ""))
            self._op_auth[self.ledger.log_size() - 1] = {
                "tag": m.get("tag", ""), "scores": scores,
                "pubkey": self._sender_pubkey_hex(addr)}
        self._touch(addr)
        self._note_progress(st)
        if st == LedgerStatus.OK and self.ledger.aggregate_ready():
            self._aggregate_and_commit()
        return {"ok": st == LedgerStatus.OK, "status": st.name}

    # ----------------------------------------- async buffered aggregation
    def _m_aupload(self, m: dict) -> dict:
        """Admit a staleness-tagged delta (no epoch gate: the op carries
        the base epoch, admission stamps the staleness); the K-th
        admission drains the buffer inside this request, so the new
        epoch rides its ack.  The sync upload's auth/gas/schema order."""
        if not self._async:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "async mode is off (--async-buffer 0 or "
                             "BFLC_ASYNC_LEGACY=1)"}
        addr = m["addr"]
        base_epoch = int(m["base_epoch"])
        blob = blob_bytes(m["blob"])
        digest = hashlib.sha256(blob).digest()
        if digest.hex() != m["hash"]:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "blob/hash mismatch"}
        payload = digest + struct.pack("<qd", int(m["n"]), float(m["cost"]))
        v = self._verify("aupload", addr, base_epoch, payload,
                         m.get("tag", ""))
        if v != LedgerStatus.OK:
            if v == LedgerStatus.DUPLICATE:
                self._resupply_async_blob(digest, blob)
            return self._auth_error(v)
        if not self._charge_gas(addr, GAS_UPLOAD_BASE + len(blob)):
            return dict(self._OUT_OF_GAS)
        err, flat = self._decode_delta(blob)
        if err:
            return {"ok": False, "status": "BAD_ARG", "error": err}
        st = self.ledger.async_upload(addr, digest, int(m["n"]),
                                      float(m["cost"]), base_epoch)
        if st == LedgerStatus.OK:
            self._blobs[digest] = blob
            self._stage_delta(digest, flat)
            self._consume_tag(base_epoch, m.get("tag", ""))
            self._op_auth[self.ledger.log_size() - 1] = \
                self._upload_auth(m, addr, blob)
        elif st == LedgerStatus.DUPLICATE:
            self._resupply_async_blob(digest, blob)
        self._touch(addr)
        self._note_progress(st)
        reply = {"ok": st == LedgerStatus.OK, "status": st.name,
                 "epoch": self.ledger.epoch}
        if st == LedgerStatus.OK and \
                self.ledger.async_buffer_depth >= self.cfg.async_buffer:
            # the K-th admission: the drain's position in the op order
            # is deterministic, and its epoch rides this ack
            self._async_aggregate_and_commit()
            reply["epoch"] = self.ledger.epoch
        return reply

    def _m_aupdates(self, m: dict) -> dict:
        """The committee's scoring surface: every buffered entry with
        its admission id and staleness."""
        if not self._async:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "async mode is off"}
        return {"ok": True, "epoch": self.ledger.epoch, "updates": [
            {"aseq": e.aseq, "sender": e.sender,
             "hash": e.payload_hash.hex(), "n": e.n_samples,
             "cost": e.avg_cost, "staleness": e.staleness}
            for e in self.ledger.async_buffer_view()]}

    def _m_ascores(self, m: dict) -> dict:
        """(aseq, score) pairs over buffered entries; the admission id
        binds, and pairs of drained entries are skipped by the ledger."""
        if not self._async:
            return {"ok": False, "status": "BAD_ARG",
                    "error": "async mode is off"}
        addr = m["addr"]
        try:
            pairs = [(int(a), float(s)) for a, s in m["pairs"]]
        except (TypeError, ValueError):
            return {"ok": False, "status": "BAD_ARG",
                    "error": "malformed pairs"}
        if self.require_auth:
            tag = bytes.fromhex(m.get("tag", ""))
            if not self.directory.verify(
                    addr, _op_bytes("ascores", addr, 0,
                                    ascores_sign_payload(pairs)), tag):
                return self._auth_error(LedgerStatus.BAD_ARG)
            if self._seen_in_window(tag):
                return self._auth_error(LedgerStatus.DUPLICATE)
        if not self._charge_gas(addr, GAS_SCORES):
            return dict(self._OUT_OF_GAS)
        st = self.ledger.async_scores(addr, pairs)
        if st == LedgerStatus.OK:
            self._consume_tag(self.ledger.epoch, m.get("tag", ""))
            self._op_auth[self.ledger.log_size() - 1] = {
                "tag": m.get("tag", ""),
                "pairs": [[a, s] for a, s in pairs],
                "pubkey": self._sender_pubkey_hex(addr)}
        self._touch(addr)
        self._note_progress(st)
        return {"ok": st == LedgerStatus.OK, "status": st.name,
                "epoch": self.ledger.epoch}

    def _m_committee(self, m: dict) -> dict:
        return {"ok": True, "committee": self.ledger.committee()}

    def _m_directory(self, m: dict) -> dict:
        return {"ok": True, "keys": {
            a: p.hex() for a, p in self.directory.export_raw().items()}}

    def _m_info(self, m: dict) -> dict:
        led = self.ledger
        reply = {"ok": True, "epoch": led.epoch,
                 "num_registered": led.num_registered,
                 "update_count": led.update_count,
                 "score_count": led.score_count,
                 "round_closed": led.round_closed,
                 "last_global_loss": led.last_global_loss,
                 "rounds_completed": self._rounds_completed,
                 "log_size": led.log_size(),
                 "log_head": led.log_head().hex(),
                 "gen": led.generation, "writer_index": led.writer_index,
                 "log_base": led.log_base,
                 "certified_size": (self._certified_size
                                    if self._bft is not None else None),
                 "committee": led.committee()}
        if self._async:
            reply["async_buffer_depth"] = led.async_buffer_depth
            reply["eff_staleness"] = int(led.effective_staleness)
        if self._adapt:
            reply["eff_density"] = float(led.effective_density)
            reply["eff_staleness"] = int(led.effective_staleness)
            ge = led.genome_epoch
            reply["genome_epoch"] = -1 if ge is None else int(ge)
        if "at" in m:
            # the chain head after ops[0..at), where this writer holds it
            # (the port's own field: a late replica's check)
            at = int(m["at"])
            reply["head_at"] = (chain_head_at(led, at).hex()
                                if led.log_base <= at <= led.log_size()
                                else None)
        snap = self._snapshot_offer()
        if snap is not None:
            reply["snapshot_epoch"] = snap["epoch"]
            reply["snapshot_i"] = snap["i"]
        if tracing.PROC.enabled:
            reply["perf"] = tracing.PROC.summary()
        return reply

    def _m_kernels(self, m: dict) -> dict:
        """This process's kernel launch counts, the merge engine's report
        (leg, self-check, launches the self-check made), every commit's
        merge record and the Ed25519 backend; the chain's size, base,
        certified prefix and the highest op a subscriber acked (a drill
        reads when its standby holds the whole certified chain); every
        snapshot op's record and every snapshot offered to a lagging
        validator, with the seconds its install took; the chain this
        writer held (`_scan_chain`) and the async buffer it started with;
        the genome ops it proposed, the rederive digest cross-checks
        of its certificates and its ledger's backend."""
        from bflc_demo_tpu_torch.comm.identity import ED25519_BACKEND
        self._scan_chain()
        return {"ok": True, "launches": launch_counts(),
                "genomes": self.genome_log,
                "crosscheck": (dict(self._bft.crosscheck)
                               if self._bft is not None else None),
                "engine": self.engine.report(), "merges": self.merge_log,
                "ed25519_backend": ED25519_BACKEND,
                "ledger_backend": self.ledger.backend,
                "gen": self.ledger.generation,
                "writer_index": self.ledger.writer_index,
                "started_mono": self._t0,
                "started_log_base": self._t0_base,
                "log_size": self.ledger.log_size(),
                "log_base": self.ledger.log_base,
                "certified_size": (self._certified_size
                                   if self._bft is not None else None),
                "stream_acked": max(self._sub_acked.values(), default=-1),
                "snapshots": self.snapshot_log,
                "snapshot_offers": (self._bft.snapshot_offers
                                    if self._bft is not None else []),
                "chain": self._chain, "started_async_buffer": self._t0_abuf}

    def _m_log_range(self, m: dict) -> dict:
        start, end = int(m["start"]), int(m["end"])
        end = min(end, self.ledger.log_size())
        if start < self.ledger.log_base:
            # the prefix was GC'd behind a certified snapshot: the caller
            # state-syncs (`snapshot`) instead of replaying it
            return {"ok": False, "error": "PREFIX_GC",
                    "base": self.ledger.log_base}
        if not 0 <= start <= end:
            return {"ok": False, "error": "bad range"}
        return {"ok": True, "ops": [self.ledger.log_op(i).hex()
                                    for i in range(start, end)]}

    def _m_snapshot(self, m: dict) -> dict:
        """The newest finalized snapshot offer: op, certificate, chain
        position, canonical state and model blob, each verifiable by the
        joiner.  With `meta` only the bindings and the read set go out,
        and the joiner pulls the bytes from a read fan-out replica."""
        from bflc_demo_tpu_torch.ledger.snapshot import offer_to_wire
        snap = self._snapshot_offer()
        if snap is None:
            return {"ok": False, "error": "no certified snapshot yet"}
        reply = offer_to_wire(snap)
        rs = self._read_set()
        if rs:
            reply["read_set"] = [list(ep) for ep in rs]
        if m.get("meta"):
            reply.pop("state")
            reply.pop("model")
        return reply

    def _m_wait(self, m: dict) -> dict:
        """Block until the log grows past the caller's view (or the
        timeout, at most 60 s) — the event-driven poll."""
        known = int(m["log_size"])
        deadline = time.monotonic() + min(float(m.get("timeout_s", 5.0)),
                                          60.0)
        while self.ledger.log_size() == known and not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._cv.wait(timeout=remaining)
        return {"ok": True, "log_size": self.ledger.log_size()}

    # ------------------------------------------------------------ admission
    def _sender_pubkey_hex(self, addr: str) -> str:
        """The sender's enrolled key (hex, '' when unknown): the
        self-authenticating evidence a validator's directory heals on."""
        pub = self.directory.export_raw().get(addr)
        return pub.hex() if pub is not None else ""

    def _resupply_async_blob(self, digest: bytes, blob: bytes) -> None:
        """Keep a hash-verified payload of a buffered entry this writer
        lacks (a promoted standby that inherited the entry, not its
        blob)."""
        if self._async and digest not in self._blobs and any(
                e.payload_hash == digest
                for e in self.ledger.async_buffer_view()):
            self._blobs[digest] = blob

    def _resupply_blob(self, digest: bytes, blob: bytes) -> None:
        """Keep a hash-verified payload the ledger records but this writer
        lacks (an honest retry whose first reply was lost)."""
        if digest not in self._blobs and any(
                u.payload_hash == digest
                for u in self.ledger.query_all_updates()):
            self._blobs[digest] = blob

    def _upload_auth(self, m: dict, addr: str, blob: bytes) -> dict:
        """An upload's or aupload's auth evidence; in sparse mode its
        (small) blob rides along so validators re-execute the densify
        admission before co-signing."""
        auth = {"tag": m.get("tag", ""), "n": int(m["n"]),
                "cost": float(m["cost"]),
                "pubkey": self._sender_pubkey_hex(addr)}
        if self._sparse:
            auth["blob"] = blob.hex()
        return auth

    def _decode_delta(self, blob: bytes):
        """(reason, decoded entries or None): '' iff the delta's entries
        mirror the current model's keys, shapes and dtypes.  The check
        runs over the dequantized image only when the genome quantizes
        (an f16 blob in an f32 fleet is refused at the door), and over
        the densified one only in sparse mode (a `#topk` entry in a
        dense fleet fails the key check); a malformed record raises in
        the decode and dies as a schema error."""
        tr = tracing.PROC
        t0 = time.perf_counter() if tr.enabled else 0.0
        try:
            delta = unpack_pytree(blob)
            if self.cfg.delta_dtype != "f32":
                delta = dequantize_entries(delta)
            if self._sparse:
                delta = densify_entries(delta)
        except (ValueError, TypeError, struct.error) as e:
            return f"undecodable delta blob: {e}", None
        if tr.enabled:
            tr.charge("admit.decode_s", time.perf_counter() - t0)
            tr.charge("admit.decode_n")
        err = self._schema_error(delta)
        return err, (None if err else delta)

    def _decode_cell_partial(self, addr: str, blob: bytes, claimed_n: int):
        """(reason, stripped partial entries or None): '' iff a cell
        partial honors the cell contract (reference :2025-2064) — the
        sender is a registered aggregator, the blob carries a well-formed
        #cellmeta entry whose cell index is the sender's registered cell
        and whose client count equals the op's `n` weight and stays
        within the registered membership, and the partial's tensors
        mirror the model schema.  In sparse mode the partial rode the
        bridge re-sparsified (`hier/partial.partial_blob`): it densifies
        before the #cellmeta split."""
        from bflc_demo_tpu_torch.hier.partial import split_cellmeta
        ent = self._cell_registry.get(addr)
        if ent is None:
            return (f"sender {addr[:12]} is not a registered cell "
                    f"aggregator"), None
        reg_index, cap = ent
        try:
            flat = unpack_pytree(blob)
            if self._sparse:
                flat = densify_entries(flat)
            partial, meta = split_cellmeta(flat)
        except (ValueError, TypeError, struct.error) as e:
            return f"undecodable cell partial: {e}", None
        if meta is None:
            return "cell partial without a #cellmeta evidence entry", \
                None
        cell_index, n_clients, _evidence = meta
        if cell_index != reg_index:
            return (f"#cellmeta cell index {cell_index} != registered "
                    f"cell {reg_index} for sender {addr[:12]}"), None
        if n_clients != claimed_n:
            return (f"#cellmeta client count {n_clients} != op weight "
                    f"{claimed_n}"), None
        if not 0 < n_clients <= cap:
            return (f"claimed client count {n_clients} exceeds "
                    f"registered membership {cap}"), None
        err = self._schema_error(partial)
        return err, (None if err else partial)

    def _decoded(self, digest: bytes) -> Dict[str, np.ndarray]:
        """An admitted blob's dense image through the one decode chain
        (the identity on a dense float32 blob); at a root the cell
        partial without its #cellmeta entry, which rode the certified
        hash but is not a model tensor."""
        flat = dequantize_entries(unpack_pytree(self._blobs[digest]))
        if self._sparse:
            flat = densify_entries(flat)
        if self._cell_registry is not None:
            from bflc_demo_tpu_torch.hier.partial import split_cellmeta
            flat = split_cellmeta(flat)[0]
        return flat

    def _schema_error(self, delta: Dict[str, np.ndarray]) -> str:
        schema = self._model_schema
        if delta.keys() != schema.keys():
            missing = sorted(schema.keys() - delta.keys())[:3]
            extra = sorted(delta.keys() - schema.keys())[:3]
            return (f"delta structure mismatch (missing={missing}, "
                    f"extra={extra})")
        for key, arr in delta.items():
            want_shape, want_dtype = schema[key]
            if arr.shape != want_shape:
                return f"delta leaf {key}: shape {arr.shape} != {want_shape}"
            if arr.dtype != want_dtype:
                return f"delta leaf {key}: dtype {arr.dtype} != {want_dtype}"
        return ""

    def _stage_delta(self, digest: bytes,
                     flat: Optional[Dict[str, np.ndarray]]) -> None:
        """Stage an admitted delta's flattened row for the mesh leg —
        only where that leg could ever take the round."""
        if flat is not None and self.engine.staging_worthwhile(
                max(self.cfg.needed_update_count, self.cfg.async_buffer)):
            self._staged[digest] = flatten_delta(flat, sorted(flat.keys()))

    def _staged_row(self, digest: bytes) -> np.ndarray:
        row = self._staged.pop(digest, None)
        if row is not None:
            return row
        flat = self._decoded(digest)
        return flatten_delta(flat, sorted(flat.keys()))

    def _note_progress(self, st: LedgerStatus) -> None:
        if st == LedgerStatus.OK:
            self._last_progress = time.monotonic()
            self._cv.notify_all()

    # ---------------------------------------------------- coordinator logic
    def _aggregate_and_commit(self) -> None:
        """The on-coordinator merge: FedAvg the ledger-selected deltas
        into the model, commit its content hash, publish the blob.
        Called with the lock held."""
        t0 = time.perf_counter()
        pending = self.ledger.pending()
        updates = self.ledger.query_all_updates()
        epoch = self.ledger.epoch
        hashes = [u.payload_hash for u in updates]
        blob, new_flat, blocks, engine_s = self._merge(
            hashes, [u.n_samples for u in updates], list(pending.selected))
        digest = hashlib.sha256(blob).digest()
        st = self.ledger.commit_model(digest, epoch)
        if st != LedgerStatus.OK:
            raise RuntimeError(f"commit rejected: {st.name}")
        self._after_commit(epoch, hashes, blob, new_flat)
        self._publish(epoch, hashes, blob, digest, new_flat, blocks, t0,
                      engine_s=engine_s)
        if self.verbose:
            print(f"[coordinator] epoch {epoch} aggregated "
                  f"({self.engine.last_leg} leg): "
                  f"loss={self.ledger.last_global_loss:.5f}", flush=True)

    def _async_aggregate_and_commit(self) -> None:
        """Drain the oldest k buffered entries at the FedBuff weights
        n / sqrt(1 + s) and commit (opcode 12, with the seating when a
        reseat is due: the ledger derives and embeds it).  Called with
        the lock held, from the K-th aupload or the stall recovery."""
        k = min(self.ledger.async_buffer_depth, self.cfg.async_buffer)
        if k <= 0:
            return
        t0 = time.perf_counter()
        entries, selected, weights, _ = self.ledger.async_selection(k)
        epoch = self.ledger.epoch
        hashes = [e.payload_hash for e in entries]
        blob, new_flat, blocks, engine_s = self._merge(hashes, weights,
                                                       list(selected))
        digest = hashlib.sha256(blob).digest()
        st = self.ledger.async_commit(digest, epoch, k)
        if st != LedgerStatus.OK:
            raise RuntimeError(f"async commit rejected: {st.name}")
        self._after_commit(epoch, hashes, blob, new_flat)
        self._publish(epoch, hashes, blob, digest, new_flat, blocks, t0,
                      engine_s=engine_s, drained=k,
                      staleness=[e.staleness for e in entries])
        if self.verbose:
            print(f"[coordinator] epoch {epoch} async-aggregated "
                  f"({k} deltas, stalest "
                  f"{max((e.staleness for e in entries), default=0)}, "
                  f"{self.engine.last_leg} leg): "
                  f"loss={self.ledger.last_global_loss:.5f}", flush=True)

    def _merge(self, hashes: List[bytes], weights, selected: List[int]):
        """(model blob, flat model, blocks, the engine call's seconds) of
        the certified merge of the deltas `hashes` at `weights` over
        `selected`, at the genome's block geometry (REDUCTION SPEC v2: on
        the card one B5 launch a block; the commit op claims the same
        count)."""
        tr = tracing.PROC
        global_flat = unpack_pytree(self._model_blob)
        blocks = reduce_blocks(self.cfg)
        t1 = time.perf_counter()
        if self.engine.choose_leg(len(hashes)) == "mesh":
            rows = [self._staged_row(h) for h in hashes]
            new_flat = self.engine.aggregate_rows(
                global_flat, rows, weights, selected,
                self.cfg.learning_rate, blocks=blocks)
        else:
            delta_flats = [self._decoded(h) for h in hashes]
            new_flat = _aggregate_flat(global_flat, delta_flats, weights,
                                       selected, self.cfg.learning_rate,
                                       blocks=blocks, engine=self.engine)
        engine_s = time.perf_counter() - t1
        if tr.enabled:
            tr.charge("aggregate.engine_s", engine_s)
        return pack_entries(new_flat), new_flat, blocks, engine_s

    def _after_commit(self, epoch: int, hashes: List[bytes], blob: bytes,
                      new_flat) -> None:
        """Right after a commit op (lock held, the old model still
        installed): the genome op when one is due, then the commit's
        rederive evidence on the commit's own position."""
        pos = self.ledger.log_size() - 1
        self._propose_genome_if_due(new_flat, epoch)
        if self._rederive:
            self._stash_rederive(
                pos, blob, {h: self._blobs[h] for h in hashes
                            if h in self._blobs})

    def _blob_lookup(self, digest: bytes) -> Optional[bytes]:
        """The read path's blob lookup: the working set, then the
        rederive plane's one-round retention (a validator fetching the
        committed round's inputs after the commit dropped them)."""
        blob = self._blobs.get(digest)
        if blob is None and self._rederive_blobs:
            blob = self._rederive_blobs.get(digest)
        return blob

    def _stash_rederive(self, pos: int, new_blob: bytes,
                        round_blobs: Dict[bytes, bytes]) -> None:
        """Arm the commit op at `pos` for the validators (lock held,
        before the model swap): its evidence, and one round of the
        round's blobs with the previous model under its own hash.  The
        previous commit's `mblob` and the round's cell evidence are
        dropped here once their ops are certified: each is load-bearing
        only until then, and a replay of certified backlog admits on
        the certificate."""
        def certified(p: int) -> bool:
            return self._bft is None or p < self._certified_size

        prev = self._rederive_commit_pos
        if prev is not None and prev in self._op_auth and certified(prev):
            self._op_auth[prev].pop("mblob", None)
        # a cell upload whose certificate is still being gathered keeps
        # its evidence to the next commit (the reference drops it here,
        # and its validators then skip that partial)
        keep = []
        for p in self._rederive_cell_auth:
            a = self._op_auth.get(p)
            if a is None:
                continue
            if not certified(p):
                keep.append(p)
                continue
            a.pop("cell", None)
            if not self._sparse:
                a.pop("blob", None)
        self._rederive_cell_auth = keep
        round_blobs[self._model_hash] = self._model_blob
        self._rederive_blobs = round_blobs
        self._rederive_commit_pos = pos
        self._op_auth[pos] = {
            "mblob": new_blob.hex(),
            "rs": [list(ep) for ep in self._read_set()],
            "co": [self.host, self.port]}

    def _state_knobs(self) -> dict:
        """The effective knobs a `state` reply carries when the loop is
        armed (certified chain state): every honest encoder uses them
        this epoch.  A cell aggregator overrides it to pass the root's
        knobs to its members."""
        if not self._adapt:
            return {}
        return {"eff_density": float(self.ledger.effective_density),
                "eff_staleness": int(self.ledger.effective_staleness)}

    def _propose_genome_if_due(self, new_flat, commit_epoch: int) -> None:
        """The closed loop's knob transition at the round boundary (lock
        held, right after a commit, so no request sees the new epoch
        before the transition lands).  The telemetry is host numpy over
        the old model (still installed) and the new one; the ledger runs
        the checks every replica will.  A refusal is reported, never a
        wedge."""
        if not self._adapt or not self.ledger.genome_due():
            return
        from bflc_demo_tpu_torch.control.loop import model_telemetry
        old_flat = unpack_pytree(self._model_blob)
        norm, drift = model_telemetry(
            old_flat, {k: np.asarray(v) for k, v in new_flat.items()})
        old_d = float(self.ledger.effective_density)
        old_s = int(self.ledger.effective_staleness)
        disag = float(self.ledger.last_disagreement)
        st = self.ledger.propose_genome(float(norm), float(drift))
        if st != LedgerStatus.OK:
            self._say(f"genome update refused: {st.name}")
            return
        self.genome_log.append({
            "epoch": self.ledger.epoch, "commit_epoch": commit_epoch,
            "old_density": old_d,
            "new_density": float(self.ledger.effective_density),
            "old_staleness": old_s,
            "new_staleness": int(self.ledger.effective_staleness),
            "update_norm": float(norm), "drift": float(drift),
            "disagreement": disag})
        self._say(f"epoch {self.ledger.epoch} genome update: density "
                  f"{old_d:g} -> {self.ledger.effective_density:g}, "
                  f"staleness {old_s} -> "
                  f"{self.ledger.effective_staleness} (norm={norm:g} "
                  f"drift={drift:g} disag={disag:g})")

    def _publish(self, epoch: int, hashes: List[bytes], blob: bytes,
                 digest: bytes, new_flat, blocks: int, t0: float,
                 **record) -> None:
        """After a commit: drop the merged deltas, install the new model,
        emit a snapshot when one is due, wake the waiters and record the
        merge.  Called with the lock held."""
        for h in hashes:
            self._blobs.pop(h, None)
            self._staged.pop(h, None)
        self._past_models[self._model_hash] = self._model_blob
        while len(self._past_models) > PAST_MODELS:
            self._past_models.pop(next(iter(self._past_models)))
        self._model_blob = blob
        self._model_hash = digest
        self._model_schema = {k: (a.shape, a.dtype)
                              for k, a in new_flat.items()}
        self._rounds_completed += 1
        self._last_progress = time.monotonic()
        if self._snap_interval and \
                self.ledger.epoch % self._snap_interval == 0:
            self._emit_snapshot()
        self._cv.notify_all()
        merge_s = time.perf_counter() - t0
        self.merge_log.append({"epoch": epoch, "leg": self.engine.last_leg,
                               "blocks": blocks,
                               "log_base": self.ledger.log_base,
                               "t": self._last_progress - self._t0,
                               "mono": self._last_progress,
                               "merge_s": merge_s, **record})
        self._scan_chain()
        tr = tracing.PROC
        if tr.enabled:
            tr.charge("aggregate_s", merge_s)
            tr.charge("aggregate_n")

    def _scan_chain(self) -> None:
        """Record the ops appended since the last scan (lock held; run at
        the start and after every commit, whose snapshot op bounds the
        next GC).  A position a GC took first records None."""
        rec = self._chain
        start = rec["from"] + len(rec["opcodes"])
        rec["opcodes"] += [None] * max(self.ledger.log_base - start, 0)
        for i in range(max(start, self.ledger.log_base),
                       self.ledger.log_size()):
            op = self.ledger.log_op(i)
            rec["opcodes"].append(op[0])
            parsed = parse_acommit(op)
            if parsed is not None:
                _, ep, k, seats, blocks = parsed
                rec["acommits"].append({"i": i, "epoch": ep, "k": k,
                                        "seats": seats, "blocks": blocks})

    # --------------------------------------------------- certified snapshots
    def _emit_snapshot(self) -> None:
        """Append a snapshot op over the current (post-commit) state and
        stage its meta (lock held, from the commit path).  It is
        certified like any op; the artifact and the GC wait for that in
        the monitor loop."""
        from bflc_demo_tpu_torch.ledger.snapshot import make_snapshot_op
        state = self.ledger.encode_state()
        pos = self.ledger.log_size()
        prev = self.ledger.log_head() if pos else b"\0" * 32
        op = make_snapshot_op(self.ledger)
        st = self.ledger.apply_op(op)
        if st != LedgerStatus.OK:
            # self-application re-derives the digest just computed: only
            # a concurrent-mutation bug trips this; never wedge the commit
            self._say(f"snapshot op rejected: {st.name}")
            return
        self._latest_snapshot = {
            "i": pos, "epoch": self.ledger.epoch,
            "gen": self.ledger.generation, "op": op, "prev_head": prev,
            "cert": None, "state": state, "model": self._model_blob,
            "final": False}
        self.snapshot_log.append({"i": pos, "epoch": self.ledger.epoch,
                                  "state_bytes": len(state),
                                  "model_bytes": len(self._model_blob)})

    def _maybe_finalize_snapshot(self) -> None:
        """Once the snapshot op is certified: write the artifact (outside
        the lock) and GC the log, the WAL and the per-op sideband behind
        it, never past the slowest live subscriber's send watermark (a
        dead one holds nothing back: its rejoin is the state-sync)."""
        meta = self._latest_snapshot
        if meta is None or meta.get("final"):
            return
        i = int(meta["i"])
        if self._bft is not None:
            cert = self._certs.get(i)
            if cert is None:
                return                  # not certified yet
            meta["cert"] = cert
        self._served_snapshot = meta
        rec = next((r for r in reversed(self.snapshot_log)
                    if r["i"] == i), {})
        if not meta.get("artifact_written"):
            if self._snap_dir:
                from bflc_demo_tpu_torch.ledger.snapshot import (
                    prune_snapshots, write_snapshot_file)
                t0 = time.perf_counter()
                try:
                    path = write_snapshot_file(self._snap_dir, meta)
                    prune_snapshots(self._snap_dir, self._snap_keep)
                except OSError as e:
                    # a full disk must not kill the writer: retried next tick
                    self._say(f"snapshot artifact write failed: {e}")
                    return
                rec["write_s"] = time.perf_counter() - t0
                rec["artifact_bytes"] = os.path.getsize(path)
                tracing.PROC.charge("snapshot.write_s", rec["write_s"])
            meta["artifact_written"] = True
        with self._lock:
            base = self.ledger.log_base
            if base >= i + 1:
                meta["final"] = True    # nothing more to reclaim
                return
            floor = min([i + 1] + [sent + 1
                                   for sent in self._sub_sent.values()])
            if floor < i + 1:
                return                  # a live stream is behind: retry
            prior_base = self.ledger.log_base
            dropped = self.ledger.gc_prefix(i + 1, meta["state"])
            meta["final"] = True
            # the sideband below the base goes with the prefix; the
            # snapshot op's own certificate stays (the offer's evidence)
            self._op_auth = {k: v for k, v in self._op_auth.items()
                             if k >= i}
            self._certs = {k: v for k, v in self._certs.items() if k >= i}
            # an ack's certificate is looked up by op hash after the
            # certify loop, which this GC can overtake: the window just
            # dropped stays answerable until the next GC (C11)
            self._certs_by_ophash = {h: w for h, w in
                                     self._certs_by_ophash.items()
                                     if int(w.get("i", -1)) >= prior_base}
        rec["gc_dropped"] = dropped
        tracing.PROC.charge("snapshot.gc_ops", dropped)
        if dropped:
            self._say(f"GC: dropped {dropped} log ops behind snapshot@{i}")

    def _snapshot_offer(self, require_model: bool = True
                        ) -> Optional[dict]:
        """The newest finalized (certified, under BFT) snapshot meta, or
        None.  `require_model=False` serves a meta without the model too:
        a validator installs ledger state only."""
        for meta in (self._latest_snapshot, self._served_snapshot):
            if meta is None or \
                    (require_model and meta.get("model") is None):
                continue
            if self._bft is not None and meta.get("cert") is None:
                continue                # mid-certification: the older one
            return meta
        return None

    def _monitor_loop(self) -> None:
        """Failure detector: when a round stalls (dead client processes),
        drive the recovery ops; liveness comes from request recency."""
        while not self._stop.is_set():
            time.sleep(min(self.stall_timeout_s / 4, 1.0))
            if self._bft is not None and \
                    self._certified_size < self.ledger.log_size():
                # certify ops appended outside a request (recovery ops, a
                # request thread that died mid-certify) within a
                # tick-sized budget, so an unreachable quorum cannot
                # starve the stall recovery below
                self._ensure_certified(
                    self.ledger.log_size(),
                    timeout_s=min(self.stall_timeout_s / 4, 1.0))
            if self._snap_interval or self._latest_snapshot is not None:
                try:
                    self._maybe_finalize_snapshot()
                except Exception as e:      # noqa: BLE001 — must never
                    # kill the failure detector
                    self._say(f"snapshot finalize failed: "
                              f"{type(e).__name__}: {e}")
            with self._lock:
                if self.ledger.epoch < 0:
                    continue
                if time.monotonic() - self._last_progress \
                        <= self.stall_timeout_s:
                    continue
                try:
                    self._recover()
                except Exception as e:      # noqa: BLE001 — the detector
                    # must outlive whatever recovery throws
                    if self.verbose:
                        print(f"[coordinator] recovery failed: "
                              f"{type(e).__name__}: {e}", flush=True)
                self._last_progress = time.monotonic()

    def _recover(self) -> None:
        led = self.ledger
        if self._async:
            # the buffer sat below K (the fleet's tail as clients exit):
            # drain what it holds, so buffered work is never stranded
            if led.async_buffer_depth > 0:
                self._say(f"recovery: async partial aggregate of "
                          f"{led.async_buffer_depth} buffered deltas"
                          f"@{led.epoch}")
                self._async_aggregate_and_commit()
            return
        if led.aggregate_ready():
            self._aggregate_and_commit()
            return
        if 0 < led.update_count < self.cfg.needed_update_count \
                and not led.round_closed:
            if led.close_round() == LedgerStatus.OK:
                self._say(f"recovery: close_round@{led.epoch}")
                self._cv.notify_all()
                return
        # scoring stuck with the committee presumed dead: seat recently
        # seen clients, non-uploaders first (nobody scores their own)
        if led.update_count > 0 and led.score_count < self.cfg.comm_count:
            uploaders = {u.sender for u in led.query_all_updates()}
            fresh_cut = time.monotonic() - self.stall_timeout_s
            live = [a for a, t in sorted(self._last_seen.items(),
                                         key=lambda kv: -kv[1])
                    if t >= fresh_cut]
            committee = set(led.committee())
            if not any(a in committee for a in live):
                pool = [a for a in live if a not in uploaders] or live
                seats = pool[: self.cfg.comm_count]
                if seats and \
                        led.reseat_committee(seats) == LedgerStatus.OK:
                    self._say(f"recovery: reseat@{led.epoch}")
                    self._cv.notify_all()
                    return
        if led.score_count > 0 and \
                led.force_aggregate() == LedgerStatus.OK:
            self._say(f"recovery: force_aggregate@{led.epoch}")
            if led.aggregate_ready():
                self._aggregate_and_commit()

    def _say(self, line: str) -> None:
        if self.verbose:
            print(f"[coordinator] {line}", flush=True)


# --------------------------------------------------------------- client side
class CoordinatorClient:
    """Client-side proxy: one socket, blocking request/reply.  Signing
    and the tensor codec live in the caller."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 tls=None):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout_s)
        if tls is not None:                 # comm/tls.client_context
            try:
                self.sock = tls.wrap_socket(self.sock, server_hostname=host)
            except BaseException:
                self.sock.close()
                raise
            tracing.PROC.charge("tls.handshakes")

    def request(self, method: str, **fields) -> dict:
        send_msg(self.sock, {"method": method, **fields})
        reply = recv_msg(self.sock)
        if reply is None:
            raise ConnectionError("coordinator closed the connection")
        return reply

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def replicate(host: str, port: int, cfg: ProtocolConfig,
              ledger_backend: str = "auto", until_ops: int = 0,
              timeout_s: float = 60.0, tls=None):
    """Live replica: subscribe to the writer's op stream, replay every op
    into a fresh ledger, and check the chained head against the writer's
    at the end.  Returns the replica ledger once it holds `until_ops` ops;
    raises on divergence or timeout.  Against a writer whose prefix was
    GC'd behind a certified snapshot the replica state-syncs first: it
    installs the hash-checked snapshot and replays only the tail (again
    when the GC passes its resume point between probe and subscribe)."""
    def _install_from(probe):
        from bflc_demo_tpu_torch.ledger.snapshot import (
            restore_snapshot, snapshot_base_head, verify_snapshot_meta)
        offer = probe.request("snapshot")
        if not offer.get("ok"):
            raise RuntimeError(f"writer GC'd its prefix but serves no "
                               f"snapshot: {offer.get('error')}")
        meta = {"i": offer["i"], "op": offer["op"],
                "prev_head": offer["prev_head"],
                "state": blob_bytes(offer["state"]),
                "model": blob_bytes(offer["model"]),
                "cert": offer.get("cert"), "gen": offer.get("gen", 0)}
        err = verify_snapshot_meta(meta)
        if err:
            raise RuntimeError(f"refusing offered snapshot: {err}")
        return restore_snapshot(meta["state"], cfg, int(meta["i"]) + 1,
                                snapshot_base_head(meta))

    probe = CoordinatorClient(host, port, timeout_s=timeout_s, tls=tls)
    try:
        base = int(probe.request("info").get("log_base", 0) or 0)
        replica = (_install_from(probe) if base > 0
                   else make_ledger(cfg, backend=ledger_backend))
    finally:
        probe.close()
    deadline = time.monotonic() + timeout_s
    for _ in range(3):
        resync = False
        sub = CoordinatorClient(host, port, timeout_s=timeout_s, tls=tls)
        try:
            send_msg(sub.sock, {"method": "subscribe",
                                "from": replica.log_size()})
            while replica.log_size() < until_ops:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"replica saw {replica.log_size()}/"
                                       f"{until_ops} ops in {timeout_s}s")
                msg = recv_msg(sub.sock)
                if msg is None:
                    raise ConnectionError("writer closed the op stream")
                if msg.get("state_sync"):
                    resync = True       # GC passed our resume point
                    break
                if "op" not in msg:
                    raise RuntimeError(f"unexpected stream frame: {msg}")
                st = replica.apply_op(bytes.fromhex(msg["op"]))
                if st != LedgerStatus.OK:
                    raise RuntimeError(f"replica rejected op {msg['i']}: "
                                       f"{st.name}")
        finally:
            sub.close()
        if not resync:
            break
        probe = CoordinatorClient(host, port, timeout_s=timeout_s, tls=tls)
        try:
            replica = _install_from(probe)
        finally:
            probe.close()
    else:
        raise RuntimeError("subscribe kept racing snapshot GC")
    if not replica.verify_log():
        raise RuntimeError("replica chain verification failed")
    probe = CoordinatorClient(host, port, timeout_s=timeout_s, tls=tls)
    try:
        info = probe.request("info")
        if info["log_size"] == replica.log_size() and \
                info["log_head"] != replica.log_head().hex():
            raise RuntimeError("replica/writer head digest divergence")
    finally:
        probe.close()
    return replica
