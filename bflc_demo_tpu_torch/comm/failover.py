"""Writer failover: hot standbys that promote when the writer dies.

Port of `bflc_demo_tpu/comm/failover.py`: `FailoverClient` (:129-319),
`WriterDead`, `PromotionSuperseded` and `Standby` (:320-1410).

- A `Standby` follows the writer live: it subscribes to the op stream
  (proving its provisioned identity by the challenge handshake when it
  holds a `wallet`, so its acks count toward the writer's quorum and its
  read endpoint joins the read set), applies every op to its own ledger,
  and mirrors what the ops only reference by hash — payload blobs, the
  model blob, the public-key directory — each checked against the
  replayed ledger.  An upload op binds only once its payload blob is
  here (mirror before apply: the frame's piggybacked blob, else a fetch);
  when the writer answers "unknown blob" the op applies as a historical
  record and the acks stay clamped below it until the chain's epoch
  moves past it.
- It serves its mirrored blobs and model read-only on a side port
  (`comm/dataplane.ReadFanoutServer`) until it promotes.
- Death is seen on the stream and confirmed by an `info` probe.  The
  election is lease-free over the endpoint priority list: standby k
  promotes only when the writer and every higher-priority standby refuse
  a connection; a lower one re-follows the winner.  A follower whose
  chain holds ops the winner's does not (the dead writer's last frames
  reached it whole and the winner cut, which quorum-ack allows) rolls
  back to the longest prefix the two share before it subscribes, where
  the winner's promotion evidence puts its fence at or below the
  divergence (`_drop_unfenced_suffix`, C12; the reference's standby
  stops on the divergence instead, and the promoted writer loses that
  quorum follower).  Any other divergence stops it, as the reference's.
- Promotion is fenced: the standby appends `promote_writer` (generation
  N+1) to its chain, signs the promotion evidence with its wallet, and
  becomes a `LedgerServer` over its ledger, blobs and the socket it bound
  at construction (failed-over clients wait in its backlog), with the
  deployment's `wal_path`, `quorum` and `standby_keys`.  From then on it
  is the writer: it merges every later round through `meshagg` on its
  `device` (kernel B5 on the card), with no warm-up before the first.
- `FailoverClient` rotates through the endpoints on a connection failure
  (signed mutations are idempotent: DUPLICATE = already in), raises its
  fence only on replies carrying promotion evidence for that generation
  (signature-checked when `standby_keys` are provisioned), sends the
  fence and its proof on every request, and refuses a reply from behind
  its fence.
- BFT (`comm/bft.py`): with the validators' `bft_keys` a client refuses
  a mutation's ack (OK or DUPLICATE-class) unless it carries a
  certificate with a quorum of authentic signatures binding the op its
  own request implies, and a standby refuses any streamed op without a
  certificate over its own chain prefix (`_require_certificate`: a
  Byzantine writer cannot make it replicate forged state).  On promotion
  the standby certifies its fence op with the same quorum
  (`_certify_promotion`); losing that position to a rival's fence raises
  `PromotionSuperseded` and the standby re-follows the winner, while a
  dead proposer's stranded op is adopted under a new fence.

- Certified snapshots (`ledger/snapshot.py`): a standby whose resume
  point lies below the writer's GC base (`info`'s `log_base`, or a
  `state_sync` stream frame) installs the writer's newest certified
  snapshot instead of replaying (`_state_sync`: the bytes from the read
  set first and the writer last, `_fetch_snapshot_body`; every binding
  checked by `verify_snapshot_meta` under the validators' keys, a forged
  or stale offer refused).  A streamed snapshot op is mirrored with its
  meta and the standby GCs its own replica behind it
  (`_note_snapshot_op`); its read fan-out serves that snapshot, and the
  server it becomes at promotion resumes from it.
- Async FedBuff (reference :940-960, :1016-1040): an aupload's payload
  is mirrored before its op applies like an upload's, and an acommit's
  model rides its frame like a commit's; a blob-less aupload clamps the
  acks until its entry drains (pruned by buffer membership, never by
  epoch).  The promoted writer inherits the buffer with its blobs and
  drains it; a blob it lacks comes back with the uploader's retry
  (`LedgerServer._resupply_async_blob`).
- TLS (`comm/tls.py`): `tls_client` dials the writer and the read set,
  `tls_server` serves the read fan-out and the promoted writer;
  `FailoverClient(tls=)`.  Validators are dialled in plaintext.

Every entry point that computes runs on `device`, `cuda` unless the
caller asks for the CPU; without a card `Standby` raises.  Not ported:
the obs metrics, flight recorder and trace spans (A14).  With
`BFLC_PROC_TRACE=1` a standby charges its mirror time
(`standby.mirror_s`), the blobs that rode the op stream or were fetched
(`standby.piggyback`, `standby.fetch`), each op's whole follow step
(`standby.op_s`, `standby.ops`) and each state-sync
(`standby.state_sync_s`, `standby.state_syncs`) to `utils/tracing.PROC`.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

from bflc_demo_tpu_torch.comm.dataplane import (ReadFanoutServer,
                                                data_plane_legacy)
from bflc_demo_tpu_torch.comm.identity import PublicDirectory, address_of
from bflc_demo_tpu_torch.comm.ledger_service import (
    CoordinatorClient, LedgerServer, chain_head_at, make_promotion_evidence,
    verify_promotion_evidence, verify_promotion_signature)
from bflc_demo_tpu_torch.comm.wire import (WireError, blob_bytes, recv_msg,
                                           send_msg, split_blob_parts)
from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.ledger import LedgerStatus, clone_prefix, make_ledger
from bflc_demo_tpu_torch.ledger.base import (OP_ACOMMIT, OP_AUPLOAD,
                                             OP_COMMIT, OP_PROMOTE,
                                             OP_SNAPSHOT, OP_UPLOAD,
                                             async_enabled, decode_op)
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.protocol.constants import bft_quorum as _bft_quorum
from bflc_demo_tpu_torch.protocol.types import CommitCertificate
from bflc_demo_tpu_torch.utils import tracing

Endpoint = Tuple[str, int]

# the blob-mirroring paths treat the async twins as their sync originals:
# an aupload references a payload blob, an acommit a new model blob
_PAYLOAD_OPCODES = (OP_UPLOAD, OP_AUPLOAD)
_MODEL_OPCODES = (OP_COMMIT, OP_ACOMMIT)


class WriterDead(Exception):
    """The followed writer is unreachable."""


class PromotionSuperseded(Exception):
    """This standby's fence op lost the promotion race to another
    proposer (the BFT quorum's verdict)."""


class FailoverClient:
    """CoordinatorClient over an ordered endpoint list.

    Without `standby_keys` the client accepts promotion evidence on its
    structure alone, so one hostile endpoint could poison its fence; with
    more than one endpoint that configuration warns.  With `bft_keys` a
    mutation's ack without a valid certificate for its op is treated as
    a dead endpoint, except an aupload's DUPLICATE that carries no
    certificate (a delta still buffered, C16)."""

    _BFT_ACKED = ("register", "upload", "scores", "aupload", "ascores")

    def __init__(self, endpoints: List[Endpoint], timeout_s: float = 30.0,
                 max_cycles: int = 6,
                 standby_keys: Optional[Dict[int, bytes]] = None,
                 bft_keys: Optional[Dict[int, bytes]] = None,
                 bft_quorum: Optional[int] = None,
                 tls=None):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        if len(endpoints) > 1 and not standby_keys:
            warnings.warn(
                "FailoverClient with multiple endpoints but no "
                "standby_keys: promotion evidence is accepted on "
                "structural match alone, so one hostile endpoint can "
                "poison this client's fence (one-message DoS) — provision "
                "the standby public keys", RuntimeWarning, stacklevel=2)
        self._eps = list(endpoints)
        self._tls = tls
        self._timeout_s = timeout_s
        self._max_cycles = max_cycles
        self._cur = 0
        self._client: Optional[CoordinatorClient] = None
        self._standby_keys = dict(standby_keys or {})
        self._bft_keys = dict(bft_keys or {})
        if self._bft_keys and bft_quorum is None:
            bft_quorum = _bft_quorum(len(self._bft_keys))
        self._bft_quorum = bft_quorum or 0
        # the highest writer generation seen with its proof, sent back as
        # `fence` / `fence_ev` on every request
        self.gen = 0
        self.gen_ev: Optional[dict] = None

    @property
    def current_endpoint(self) -> Endpoint:
        return self._eps[self._cur]

    def _rotate(self) -> None:
        self.close()
        self._cur = (self._cur + 1) % len(self._eps)

    def _learn_fence(self, reply: dict, fields: dict) -> None:
        """Raise the fence on a reply carrying evidence for its `gen`, or
        learn the proof of the current fence retroactively."""
        g, ev = reply.get("gen"), reply.get("gen_ev")
        if not isinstance(ev, dict):
            return
        try:
            ev_gen = int(ev.get("gen", -1))
        except (TypeError, ValueError):
            return                      # malformed evidence: ignore it
        if self._standby_keys and \
                not verify_promotion_signature(ev, self._standby_keys):
            return                      # forged or unsigned: never moves us
        if isinstance(g, int) and g > self.gen and ev_gen == g:
            self.gen, self.gen_ev = g, ev
            fields["fence"], fields["fence_ev"] = g, ev
        elif self.gen_ev is None and ev_gen == self.gen:
            self.gen_ev = ev
            fields.setdefault("fence_ev", ev)

    def request(self, method: str, **fields) -> dict:
        last: Optional[Exception] = None
        attempts = self._max_cycles * len(self._eps)
        fields.setdefault("fence", self.gen)
        if self.gen_ev is not None:
            fields.setdefault("fence_ev", self.gen_ev)
        for attempt in range(attempts):
            try:
                if self._client is None:
                    host, port = self._eps[self._cur]
                    self._client = CoordinatorClient(
                        host, port, timeout_s=self._timeout_s,
                        tls=self._tls)
                reply = self._client.request(method, **fields)
                self._learn_fence(reply, fields)
                g = reply.get("gen")
                if reply.get("status") == "STALE_WRITER" or \
                        (isinstance(g, int) and g < self.gen):
                    # the endpoint demoted itself on our fence, or it is a
                    # writer behind the fence: never accept its reply
                    last = ConnectionError(f"stale writer (gen {g})")
                    self._rotate()
                    continue
                if not self._certified_ack(method, fields, reply):
                    # no quorum bound this op: a writer that dropped,
                    # forged or forked it cannot mint the certificate
                    last = ConnectionError(
                        f"{method}: ack without a valid commit "
                        f"certificate for this op (uncertified or "
                        f"replayed-certificate state rejected)")
                    self._rotate()
                    continue
                return reply
            except (ConnectionError, WireError, OSError) as e:
                last = e
                self._rotate()
                if self._cur == 0:          # full cycle without an answer
                    time.sleep(min(0.25 * (attempt + 1), 2.0))
        raise ConnectionError(
            f"all coordinator endpoints failed after {attempts} attempts: "
            f"{type(last).__name__}: {last}")

    def _certified_ack(self, method: str, fields: dict, reply: dict) -> bool:
        """False for a mutation's ack (DUPLICATE-class replies too: they
        count as progress) without a certificate quorum-signed over the
        op its request implies.

        A DUPLICATE to an `aupload` that carries no certificate at all is
        accepted (C16's repair, a deliberate difference from the
        reference's client): the ledger keeps one buffered delta a
        sender, so a second aupload while the first is still buffered is
        refused and no op of this request reaches the chain.  It means
        "still buffered, retry at the next version", not a dead writer;
        the caller counts nothing as certified from it.  A certificate
        that is present must still verify."""
        if not (self._bft_keys and method in self._BFT_ACKED
                and (reply.get("ok") or reply.get("status") in
                     ("DUPLICATE", "ALREADY_REGISTERED"))):
            return True
        if method == "aupload" and reply.get("status") == "DUPLICATE" \
                and not reply.get("ok") and reply.get("cert") is None:
            return True
        from bflc_demo_tpu_torch.comm.bft import (expected_op_hash,
                                                  verify_certificate_sigs)
        return verify_certificate_sigs(
            reply.get("cert"), self._bft_quorum, self._bft_keys,
            op_hash=expected_op_hash(method, fields))

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


class Standby:
    """A promotable live replica (see the module docstring).

    endpoints[0] is the initial writer; this standby is endpoints[index].
    The serving socket binds in __init__: advertise `port` before
    starting.  `run()` blocks: it follows the writer until the writer
    dies, promotes (or re-follows the winner) and, once promoted, serves
    until `stop()`.  `device` is where the promoted writer merges."""

    def __init__(self, cfg: ProtocolConfig, endpoints: List[Endpoint],
                 index: int, *, host: str = "127.0.0.1", port: int = 0,
                 ledger_backend: str = "auto",
                 heartbeat_s: float = 1.0,
                 require_auth: bool = True,
                 stall_timeout_s: float = 10.0,
                 wal_path: str = "",
                 wallet=None,
                 standby_keys: Optional[Dict[int, bytes]] = None,
                 quorum: int = 0,
                 quorum_timeout_s: float = 5.0,
                 bft_validators: Optional[List[Endpoint]] = None,
                 bft_keys: Optional[Dict[int, bytes]] = None,
                 bft_quorum: Optional[int] = None,
                 bft_timeout_s: float = 10.0,
                 tls_client=None, tls_server=None,
                 snapshot_interval: int = 0,
                 snapshot_dir: str = "",
                 device: DeviceLike = None,
                 verbose: bool = False):
        from bflc_demo_tpu_torch.ledger.snapshot import snapshot_legacy
        if not 1 <= index < len(endpoints):
            raise ValueError(f"standby index {index} out of range for "
                             f"{len(endpoints)} endpoints")
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        # snapshots: handed to the server this standby becomes; the meta
        # of the newest snapshot op it mirrored or installed
        self.snapshot_interval = (0 if snapshot_legacy()
                                  else max(int(snapshot_interval), 0))
        self.snapshot_dir = snapshot_dir
        self._latest_snapshot: Optional[dict] = None
        if self.snapshot_interval and ledger_backend != "python":
            # compaction needs the python ledger (reference :362-369)
            ledger_backend = "python"
        self.tls_client = tls_client        # following the writer
        self.tls_server = tls_server        # read fan-out, then writer
        self.endpoints = list(endpoints)
        self.index = index
        self.heartbeat_s = heartbeat_s
        self.require_auth = require_auth
        self.stall_timeout_s = stall_timeout_s
        # attached at promotion: the journal then holds the whole chain
        self.wal_path = wal_path
        self.wallet = wallet
        if wallet is None:
            warnings.warn(
                f"Standby(index={index}) constructed WITHOUT a wallet: "
                f"promotions will carry no signed evidence, so a healed "
                f"pre-partition writer is never fenced and client-side "
                f"reply-gen fencing never activates — this deployment "
                f"has no split-brain protection", RuntimeWarning,
                stacklevel=2)
        # every provisioned standby's key and the deployment's quorum,
        # handed to the server this standby becomes
        self.standby_keys: Dict[int, bytes] = dict(standby_keys or {})
        self.quorum = quorum
        self.quorum_timeout_s = quorum_timeout_s
        # BFT: with the validators' keys every streamed op must carry a
        # certificate over our own prefix; the certificates are mirrored
        # and handed to the server this standby becomes
        self.bft_validators = list(bft_validators or [])
        self.bft_keys: Dict[int, bytes] = dict(bft_keys or {})
        if self.bft_keys and bft_quorum is None:
            bft_quorum = _bft_quorum(len(self.bft_keys))
        self.bft_quorum = bft_quorum or 0
        self.bft_timeout_s = bft_timeout_s
        self._certs: Dict[int, dict] = {}
        self.verbose = verbose
        self._ledger_backend = ledger_backend
        self.ledger = make_ledger(cfg, backend=ledger_backend)
        self._blobs: Dict[bytes, bytes] = {}
        # upload ops applied without their blob, by chain index: only
        # when the writer answered "unknown blob"; acks stay below them
        self._pending_payload: Dict[int, bytes] = {}
        self._blob_unknown = False
        self._model_blob: Optional[bytes] = None
        self._directory = PublicDirectory() if require_auth else None
        self._synced_registered = -1
        self._synced_update_count = -1
        # one record a state-sync {i, epoch, seconds} and a GC {i, dropped}
        self.state_syncs: List[dict] = []
        self.gc_log: List[dict] = []
        self._stop = threading.Event()
        self.promoted = threading.Event()
        self.server: Optional[LedgerServer] = None
        # bind now: failed-over clients queue in the backlog until serving
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self.read_server: Optional[ReadFanoutServer] = None
        if not data_plane_legacy():
            self.read_server = ReadFanoutServer(
                self._blobs.get, self._read_model_state, host=host,
                tls=tls_server, snapshot_state=self._read_snapshot_state)
            self.read_server.start()

    def _read_snapshot_state(self) -> Optional[dict]:
        """The mirrored snapshot the read fan-out may serve, or None: only
        one whose model blob is held (a joiner refuses anything less)."""
        meta = self._latest_snapshot
        if meta is None or meta.get("model") is None:
            return None
        return meta

    def _read_model_state(self):
        """(epoch, hash, blob) of the mirrored model, or None before the
        first mirror."""
        blob = self._model_blob
        if blob is None:
            return None
        return (self.ledger.epoch, hashlib.sha256(blob).digest(), blob)

    # ------------------------------------------------------------------ api
    def stop(self) -> None:
        self._stop.set()
        if self.server is not None:
            self.server.close()
        if self.read_server is not None:
            self.read_server.close()
        try:
            self._sock.close()
        except OSError:
            pass

    def run(self) -> None:
        """Follow -> (writer dies) -> promote or re-follow -> serve."""
        writer = 0
        while not self._stop.is_set():
            if 0 <= writer < len(self.endpoints):
                try:
                    self._follow(self.endpoints[writer])
                except WriterDead as e:
                    self._say(f"writer {self.endpoints[writer]} dead: {e}")
            if self._stop.is_set():
                return
            winner = self._elect()
            if winner == self.index:
                if self._model_blob is None:
                    # nothing mirrored yet: rebuild from any serving peer
                    writer = self._any_serving_peer()
                    time.sleep(self.heartbeat_s)
                    continue
                try:
                    self._promote_and_serve()
                    return
                except PromotionSuperseded as e:
                    # a rival's fence is bound at our position (our fence
                    # op is rolled back): follow the winner
                    self._say(f"{e}; re-following")
                    writer = self._any_serving_peer()
                    time.sleep(self.heartbeat_s)
                    continue
                except Exception:
                    # a failed promotion must not leave the bound socket
                    # accepting connects while nothing serves
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    raise
            elif winner < 0:
                time.sleep(self.heartbeat_s)   # nobody promotable yet
            else:
                writer = winner
                time.sleep(self.heartbeat_s)   # let the winner promote

    def _say(self, line: str) -> None:
        if self.verbose:
            print(f"[standby {self.index}] {line}", flush=True)

    # ------------------------------------------------------------ following
    def _follow(self, writer: Endpoint) -> None:
        """Apply the writer's op stream live and mirror the blobs, model
        and directory.  Raises WriterDead when the stream breaks and a
        probe fails."""
        host, port = writer
        try:
            ctl = CoordinatorClient(host, port, timeout_s=10.0,
                                    tls=self.tls_client)
        except (ConnectionError, WireError, OSError) as e:
            raise WriterDead(str(e))
        try:
            # never follow a writer whose generation is behind our chain
            inf = ctl.request("info")
            if int(inf.get("gen", 0)) < self.ledger.generation:
                raise WriterDead(f"stale writer: gen {inf.get('gen')} < "
                                 f"ours {self.ledger.generation}")
            # the writer GC'd past our resume point: replay is impossible,
            # install its certified snapshot and follow the tail
            if self.ledger.log_size() < int(inf.get("log_base", 0) or 0):
                self._state_sync(ctl)
            else:
                self._drop_unfenced_suffix(ctl, inf)
            sub = self._open_subscription(writer)
        except (ConnectionError, WireError, OSError) as e:
            ctl.close()
            raise WriterDead(str(e))
        except BaseException:
            ctl.close()
            raise
        tr = tracing.PROC
        try:
            self._sync_state(ctl)
            last_applied = self.ledger.log_size() - 1
            while not self._stop.is_set():
                try:
                    msg = recv_msg(sub.sock)
                except (TimeoutError, socket.timeout):
                    if not self._writer_alive(writer):
                        raise WriterDead("probe failed")
                    if self._pending_payload:
                        self._retry_pending_payloads(ctl)
                        self._send_ack(sub, last_applied)
                    continue
                except (WireError, OSError) as e:
                    raise WriterDead(str(e))
                if msg is None:
                    raise WriterDead("op stream closed")
                if "op" not in msg:
                    if not msg.get("state_sync"):
                        continue        # unknown control frame: ignore
                    # the GC passed our resume point between the info
                    # probe and the subscribe: install and resubscribe
                    sub.close()
                    try:
                        self._state_sync(ctl)
                        sub = self._open_subscription(writer)
                    except (ConnectionError, WireError, OSError) as e:
                        raise WriterDead(str(e))
                    last_applied = self.ledger.log_size() - 1
                    continue
                t0 = time.perf_counter() if tr.enabled else 0.0
                op_bytes = bytes.fromhex(msg["op"])
                op_index = self.ledger.log_size()
                if self.bft_keys:
                    # an append binds here only with a certificate over
                    # our own chain prefix
                    self._require_certificate(msg, op_index, op_bytes)
                self._harvest_pushed_blob(msg, op_bytes)
                if not self._await_upload_payload(op_bytes, ctl, writer):
                    self._pending_payload[op_index] = op_bytes
                if tr.enabled:
                    tr.charge("standby.mirror_s", time.perf_counter() - t0)
                st = self.ledger.apply_op(op_bytes)
                if st != LedgerStatus.OK:
                    raise RuntimeError(
                        f"standby rejected op {msg['i']}: {st.name} — "
                        f"writer/replica divergence, refusing to continue")
                last_applied = op_index
                if op_bytes[0] == OP_SNAPSHOT:
                    # the apply re-derived its digest from our replica
                    self._note_snapshot_op(op_index, op_bytes,
                                           msg.get("cert"))
                self._drop_moot_payloads()
                try:
                    self._sync_state(ctl)
                except (ConnectionError, WireError, OSError):
                    if not self._writer_alive(writer):
                        raise WriterDead("state sync failed")
                    continue            # sideband incomplete: no ack yet
                self._send_ack(sub, last_applied)
                if tr.enabled:
                    tr.charge("standby.op_s", time.perf_counter() - t0)
                    tr.charge("standby.ops")
        finally:
            sub.close()
            ctl.close()

    def _drop_unfenced_suffix(self, ctl: CoordinatorClient,
                              inf: dict) -> None:
        """Roll the chain back to its longest prefix the writer's chain
        shares, where the ops dropped lie past a promotion fence (C12).
        Under quorum-ack the dead writer's last frames can reach this
        standby whole and the one that promoted cut, so this chain holds
        ops the fenced chain does not; the writer's stream would not
        apply on top of them.  Only such ops go: the writer's generation
        is above ours and its promotion evidence (verified against our
        chain when standby keys are provisioned) puts its
        `promote_writer` op at or below the divergence.  Any other
        divergence stops this standby, as the reference's does.  The
        heads come from `info(at=)`; a writer that answers no `head_at`
        (the reference's) is followed as it stands."""
        size = self.ledger.log_size()
        base = self.ledger.log_base
        k = min(size, int(inf.get("log_size", 0)))
        while k >= base:
            r = ctl.request("info", at=k)
            if "head_at" not in r:
                return
            if r["head_at"] is not None and \
                    bytes.fromhex(r["head_at"]) == chain_head_at(self.ledger,
                                                                 k):
                break
            k -= 1
        else:
            raise RuntimeError(
                f"standby {self.index}: the writer's chain shares no "
                f"prefix with ours above the GC base {base} — refusing "
                f"to continue")
        if k == size:
            return
        gen, ev = int(inf.get("gen", 0)), inf.get("gen_ev")
        try:
            fenced = (gen > self.ledger.generation
                      and int(ev["gen"]) == gen
                      and base <= int(ev["ix"]) <= k
                      and (verify_promotion_evidence(ev, self.ledger,
                                                     self.standby_keys)
                           if self.standby_keys else
                           chain_head_at(self.ledger, int(ev["ix"]))
                           == bytes.fromhex(ev["prev"])))
        except (KeyError, TypeError, ValueError):
            fenced = False
        if not fenced:
            raise RuntimeError(
                f"standby {self.index}: writer/replica divergence at op "
                f"{k} of our {size}, not past a promotion fence (writer "
                f"gen {gen}, ours {self.ledger.generation}) — refusing "
                f"to continue")
        self._say(f"dropping {size - k} ops past the fenced chain at {k}")
        self.ledger = clone_prefix(self.ledger, k, self.cfg,
                                   backend=self._ledger_backend)
        self._certs = {j: c for j, c in self._certs.items() if j < k}
        self._pending_payload = {j: op for j, op in
                                 self._pending_payload.items() if j < k}
        self._synced_update_count = -1

    def _open_subscription(self, writer: Endpoint) -> CoordinatorClient:
        """Subscribe at our resume point; with a wallet, prove the
        provisioned identity by the challenge handshake and advertise
        the read endpoint."""
        sub = CoordinatorClient(writer[0], writer[1],
                                timeout_s=self.heartbeat_s,
                                tls=self.tls_client)
        sub_msg = {"method": "subscribe", "from": self.ledger.log_size()}
        if self.wallet is not None:
            sub_msg["sb"] = self.index
            if self.read_server is not None:
                sub_msg["read_ep"] = list(self.read_server.endpoint)
        try:
            send_msg(sub.sock, sub_msg)
            if self.wallet is not None:
                sub.sock.settimeout(10.0)  # handshake, not heartbeat
                ch = recv_msg(sub.sock)
                sub.sock.settimeout(self.heartbeat_s)
                if not isinstance(ch, dict) or "challenge" not in ch:
                    raise WriterDead("subscriber handshake: no challenge")
                sig = self.wallet.sign(
                    LedgerServer._SUB_MAGIC + bytes.fromhex(ch["challenge"])
                    + struct.pack("<Iq", self.index, sub_msg["from"]))
                send_msg(sub.sock, {"tag": sig.hex()})
        except BaseException:
            sub.close()
            raise
        return sub

    # ------------------------------------------------- certified snapshots
    def _state_sync(self, ctl: CoordinatorClient) -> None:
        """Install the writer's newest certified snapshot in place of a GC'd
        prefix this replica can no longer replay.  `verify_snapshot_meta`
        checks every binding (state digest, model hash, the certificate
        under our validator keys, no generation regression); a refused
        offer raises RuntimeError and installs nothing, a transport
        failure raises WriterDead."""
        from bflc_demo_tpu_torch.ledger.snapshot import (
            restore_snapshot, snapshot_base_head, verify_snapshot_meta)
        t0 = time.perf_counter()
        try:
            offer = ctl.request("snapshot", meta=1)
        except (ConnectionError, WireError, OSError) as e:
            raise WriterDead(str(e))
        if not offer.get("ok"):
            raise WriterDead(f"writer GC'd past our resume point but "
                             f"serves no snapshot: {offer.get('error')}")
        try:
            meta = {"i": int(offer["i"]), "epoch": int(offer["epoch"]),
                    "gen": int(offer.get("gen", 0)), "op": offer["op"],
                    "prev_head": offer["prev_head"],
                    "cert": offer.get("cert")}
        except (KeyError, TypeError, ValueError) as e:
            raise RuntimeError(
                f"standby {self.index}: malformed snapshot offer: {e}")
        meta["state"], meta["model"] = self._fetch_snapshot_body(ctl, offer)
        err = verify_snapshot_meta(meta, bft_quorum=self.bft_quorum,
                                   bft_keys=self.bft_keys or None,
                                   min_generation=self.ledger.generation)
        if err:
            raise RuntimeError(f"standby {self.index}: refusing offered "
                               f"snapshot: {err}")
        self.ledger = restore_snapshot(meta["state"], self.cfg,
                                       int(meta["i"]) + 1,
                                       snapshot_base_head(meta))
        self._ledger_backend = "python"     # restored replicas compact
        self._model_blob = bytes(meta["model"])
        self._certs = ({int(meta["i"]): meta["cert"]}
                       if meta.get("cert") else {})
        self._pending_payload.clear()
        self._blob_unknown = False
        self._synced_registered = -1        # a full sideband resync
        self._synced_update_count = -1
        self._latest_snapshot = {**meta, "final": True}
        dt = time.perf_counter() - t0
        self.state_syncs.append({"i": int(meta["i"]),
                                 "epoch": int(meta["epoch"]),
                                 "seconds": dt})
        tracing.PROC.charge("standby.state_sync_s", dt)
        tracing.PROC.charge("standby.state_syncs")
        self._say(f"state-synced from certified snapshot@{meta['i']} "
                  f"(epoch {meta['epoch']}, {dt * 1e3:.0f} ms)")

    def _fetch_snapshot_body(self, ctl: CoordinatorClient,
                             offer: dict) -> Tuple[bytes, bytes]:
        """(state, model) of the writer's offer: the advertised read set
        first (each reply checked against the offer's digests, so a stale
        or lying replica costs a round trip), the writer last."""
        from bflc_demo_tpu_torch.ledger.snapshot import (decode_state,
                                                         parse_snapshot_op)
        op = offer.get("op", "")
        try:
            parsed = parse_snapshot_op(bytes.fromhex(op)
                                       if isinstance(op, str) else bytes(op))
        except ValueError:
            parsed = None
        want_digest = parsed[1] if parsed else None
        for ep in offer.get("read_set") or []:
            try:
                c = CoordinatorClient(str(ep[0]), int(ep[1]), timeout_s=10.0,
                                      tls=self.tls_client)
            except (ConnectionError, OSError, TypeError, ValueError,
                    IndexError):
                continue
            try:
                r = c.request("snapshot", want_i=int(offer["i"]))
            except (ConnectionError, WireError, OSError):
                continue
            finally:
                c.close()
            if not r.get("ok"):
                continue
            try:
                state = blob_bytes(r.get("state", b""))
                model = blob_bytes(r.get("model", b""))
                mh = bytes(decode_state(state)["model_hash"])
            except ValueError:
                continue
            if want_digest is not None \
                    and hashlib.sha256(state).digest() == want_digest \
                    and hashlib.sha256(model).digest() == mh:
                return state, model
        try:
            r = ctl.request("snapshot")
        except (ConnectionError, WireError, OSError) as e:
            raise WriterDead(str(e))
        if not r.get("ok"):
            raise WriterDead(f"snapshot body fetch failed: {r.get('error')}")
        return blob_bytes(r["state"]), blob_bytes(r["model"])

    def _note_snapshot_op(self, i: int, op: bytes, cert_wire) -> None:
        """Mirror a streamed (and just applied, so re-derived) snapshot
        op's meta, write its artifact under `snapshot_dir`, and GC this
        replica and its certificates behind it (the snapshot op's own
        certificate stays: it is the offer's evidence)."""
        from bflc_demo_tpu_torch.ledger.snapshot import (
            parse_snapshot_op, prune_snapshots, write_snapshot_file)
        parsed = parse_snapshot_op(op)
        if parsed is None:
            return
        state = self.ledger.encode_state()
        model = self._model_blob
        want_mh, _ = self.ledger.query_global_model()
        if model is None or hashlib.sha256(model).digest() != want_mh:
            model = None                # a stale mirror is never served
        meta = {"i": i, "epoch": parsed[0], "gen": self.ledger.generation,
                "op": op, "prev_head": self.ledger.head_at(i) or b"\0" * 32,
                "cert": cert_wire, "state": state, "model": model,
                "final": True}
        self._latest_snapshot = meta
        if self.snapshot_dir and model is not None:
            try:
                write_snapshot_file(self.snapshot_dir, meta)
                prune_snapshots(self.snapshot_dir, 2)
            except OSError:
                pass                    # a full disk must not stop following
        dropped = self.ledger.gc_prefix(i + 1, state)
        if dropped:
            self._certs = {k: v for k, v in self._certs.items() if k >= i}
            self.gc_log.append({"i": i, "dropped": dropped})
            self._say(f"GC: dropped {dropped} mirrored ops behind "
                      f"snapshot@{i}")

    def _await_upload_payload(self, op_bytes: bytes, ctl: CoordinatorClient,
                              writer: Endpoint) -> bool:
        """Block until the op's payload blob is mirrored (True), the
        writer reports it unknown (False: apply with a clamped ack), or
        the writer dies (WriterDead: the op must not apply)."""
        if not op_bytes or op_bytes[0] not in _PAYLOAD_OPCODES:
            return True
        while not self._stop.is_set():
            self._blob_unknown = False
            if self._mirror_upload_payload(op_bytes, ctl):
                return True
            if self._blob_unknown:
                return False
            if not self._writer_alive(writer):
                raise WriterDead("writer died before the payload of a "
                                 "streamed upload could be mirrored")
            time.sleep(min(self.heartbeat_s, 0.25))
        raise WriterDead("standby stopping")

    def _drop_moot_payloads(self) -> None:
        """Lift the ack clamp for blob-less records the chain has moved
        past: a sync upload once its round is settled, an aupload once
        its entry drained from the buffer (its base epoch says nothing:
        buffered entries outlive epochs)."""
        buffered = None
        for i in list(self._pending_payload):
            op = self._pending_payload[i]
            if op[:1] == bytes([OP_AUPLOAD]):
                if buffered is None:
                    buffered = {e.payload_hash
                                for e in self.ledger.async_buffer_view()}
                if self._op_hash(op, "payload_hash") not in buffered:
                    del self._pending_payload[i]
                continue
            ep = decode_op(op).get("epoch")
            if ep is None or ep < self.ledger.epoch:
                del self._pending_payload[i]

    def _retry_pending_payloads(self, ctl: CoordinatorClient) -> None:
        self._drop_moot_payloads()
        for i in sorted(self._pending_payload):
            if self._mirror_upload_payload(self._pending_payload[i], ctl):
                del self._pending_payload[i]
            else:
                break

    def _send_ack(self, sub: CoordinatorClient, last_applied: int) -> None:
        """Ack the highest op held durably: the latest applied, clamped
        below any upload whose blob is still missing."""
        ack = last_applied
        if self._pending_payload:
            ack = min(ack, min(self._pending_payload) - 1)
        if ack < 0:
            return
        try:
            send_msg(sub.sock, {"ack": int(ack)})
        except (WireError, OSError):
            pass

    def _require_certificate(self, msg: dict, op_index: int,
                             op_bytes: bytes) -> None:
        """Verify and mirror the streamed op's certificate; RuntimeError
        (a refusal, not a failover) when it is absent or invalid."""
        from bflc_demo_tpu_torch.comm.bft import verify_certificate
        cert_wire = msg.get("cert")
        cert = None
        if isinstance(cert_wire, dict):
            try:
                cert = CommitCertificate.from_wire(cert_wire)
            except ValueError:
                cert = None
        prev = (self.ledger.log_head() if self.ledger.log_size()
                else b"\0" * 32)
        if cert is None or not verify_certificate(
                cert, index=op_index, prev_head=prev, op=op_bytes,
                quorum=self.bft_quorum, validator_keys=self.bft_keys):
            raise RuntimeError(
                f"standby {self.index}: op {msg.get('i')} arrived without "
                f"a valid commit certificate — Byzantine or misconfigured "
                f"writer, refusing to replicate uncertified state")
        self._certs[op_index] = cert_wire

    @staticmethod
    def _op_hash(op_bytes: bytes, field: str) -> Optional[bytes]:
        try:
            return bytes.fromhex(decode_op(op_bytes)[field])
        except (KeyError, ValueError):
            return None

    def _harvest_pushed_blob(self, msg: dict, op_bytes: bytes) -> None:
        """Keep a frame's piggybacked blob iff it hashes to the digest its
        op records: an (a)upload's payload or an (a)commit's new model."""
        if msg.get("blob") is None or not op_bytes or \
                op_bytes[0] not in _PAYLOAD_OPCODES + _MODEL_OPCODES:
            return
        try:
            blob = blob_bytes(msg["blob"])
        except ValueError:
            return
        if op_bytes[0] in _MODEL_OPCODES:
            if hashlib.sha256(blob).digest() == \
                    self._op_hash(op_bytes, "model_hash"):
                self._model_blob = blob
            return
        ph = self._op_hash(op_bytes, "payload_hash")
        if ph not in self._blobs and hashlib.sha256(blob).digest() == ph:
            self._blobs[ph] = blob
            tracing.PROC.charge("standby.piggyback")

    def _mirror_upload_payload(self, op_bytes: bytes,
                               ctl: CoordinatorClient) -> bool:
        """Fetch an (a)upload op's payload by hash.  True = nothing to do
        or mirrored; False = still missing.  A writer answering with bytes
        of another hash is refused outright."""
        if not op_bytes or op_bytes[0] not in _PAYLOAD_OPCODES:
            return True
        ph = self._op_hash(op_bytes, "payload_hash")
        if ph is None or ph in self._blobs:
            return True
        try:
            r = ctl.request("blob", hash=ph.hex())
        except (ConnectionError, WireError, OSError):
            return False
        tracing.PROC.charge("standby.fetch")
        if r.get("ok"):
            try:
                blob = blob_bytes(r.get("blob", ""))
            except ValueError:
                blob = b""
            if hashlib.sha256(blob).digest() == ph:
                self._blobs[ph] = blob
                return True
            raise RuntimeError(
                f"standby {self.index}: writer served a corrupt payload "
                f"blob for {ph.hex()[:12]} — Byzantine or corrupt writer, "
                f"refusing to replicate")
        # an authoritative negative: the round already merged it away
        self._blob_unknown = True
        return False

    def _sync_state(self, ctl: CoordinatorClient) -> None:
        """Mirror the hash-referenced state, each fetch gated on the
        replayed ledger's own counters and checked against it."""
        if self.ledger.update_count != self._synced_update_count:
            missing = [u.payload_hash
                       for u in self.ledger.query_all_updates()
                       if u.payload_hash not in self._blobs]
            if len(missing) > 1:
                r = ctl.request("blobs", hashes=[h.hex() for h in missing])
                if r.get("ok"):
                    for h, part in split_blob_parts(r).items():
                        self._blobs[bytes.fromhex(h)] = part
            all_stored = True
            for u in self.ledger.query_all_updates():
                if u.payload_hash not in self._blobs:
                    r = ctl.request("blob", hash=u.payload_hash.hex())
                    if r.get("ok"):
                        blob = blob_bytes(r["blob"])
                        if hashlib.sha256(blob).digest() == u.payload_hash:
                            self._blobs[u.payload_hash] = blob
                    if u.payload_hash not in self._blobs:
                        all_stored = False
            if all_stored:
                self._synced_update_count = self.ledger.update_count
        want_hash, _ = self.ledger.query_global_model()
        have = (hashlib.sha256(self._model_blob).digest()
                if self._model_blob is not None else b"")
        if want_hash != have and want_hash != b"\0" * 32:
            r = ctl.request("model")
            if r.get("ok"):
                blob = blob_bytes(r["blob"])
                if hashlib.sha256(blob).digest() == want_hash:
                    self._model_blob = blob
        elif self._model_blob is None:
            # genesis: the chain commits no model hash before round 0, but
            # the writer holds the initial model — mirror it now
            r = ctl.request("model")
            if r.get("ok"):
                self._model_blob = blob_bytes(r["blob"])
        if self._directory is not None and \
                self.ledger.num_registered != self._synced_registered:
            r = ctl.request("directory")
            if r.get("ok"):
                for addr, pub_hex in r["keys"].items():
                    pub = bytes.fromhex(pub_hex)
                    if address_of(pub) == addr and \
                            not self._directory.knows(addr):
                        self._directory.enroll(pub)
                self._synced_registered = self.ledger.num_registered

    def _writer_info(self, ep: Endpoint) -> Optional[dict]:
        """The endpoint's `info` reply, or None when unreachable."""
        try:
            probe = CoordinatorClient(ep[0], ep[1], timeout_s=2.0,
                                      tls=self.tls_client)
            try:
                inf = probe.request("info")
                return inf if inf.get("ok") else None
            finally:
                probe.close()
        except (ConnectionError, WireError, OSError):
            return None

    def _writer_alive(self, ep: Endpoint) -> bool:
        return self._writer_info(ep) is not None

    def _any_serving_peer(self) -> int:
        """Index of any endpoint serving at a generation not behind ours,
        priority ignored, or -1."""
        for j, ep in enumerate(self.endpoints):
            if j == self.index:
                continue
            inf = self._writer_info(ep)
            if inf is not None and \
                    int(inf.get("gen", 0)) >= self.ledger.generation:
                return j
        return -1

    # ------------------------------------------------------------- election
    def _elect(self) -> int:
        """The live endpoint of highest priority (lowest index): a writer
        counts if it serves at our fence, a peer standby if its port
        accepts a connection.  self.index = promote; -1 = nobody."""
        for j, ep in enumerate(self.endpoints):
            if j == self.index:
                return self.index
            if j == 0:
                inf = self._writer_info(ep)
                if inf is not None and \
                        int(inf.get("gen", 0)) >= self.ledger.generation:
                    return 0
                continue
            try:
                socket.create_connection(ep, timeout=1.0).close()
                return j
            except OSError:
                continue
        return -1

    # ------------------------------------------------------------ promotion
    def _rollback_last_op(self) -> None:
        """Drop the chain's final op (a failed fence) by replaying the
        prefix into a fresh ledger."""
        upto = self.ledger.log_size() - 1
        self.ledger = clone_prefix(self.ledger, upto, self.cfg,
                                   backend=self._ledger_backend)
        self._certs.pop(upto, None)

    def _certify_promotion(self) -> None:
        """Certify the just-appended fence op with the validator quorum;
        a promotion that cannot certify must not serve.  Validators sign
        one op a position, so two standbys racing to promote cannot both
        win: the loser's repair round mandates the winner's fence and
        this raises PromotionSuperseded (fence rolled back).  A mandated
        op that is no fence belongs to a dead proposer (the old writer's
        stranded last op): it is adopted — certified at this position,
        spliced under the fence — and the standby re-fences at the next
        position.  An unreachable quorum is retried until it heals or
        the standby stops."""
        from bflc_demo_tpu_torch.comm.bft import (CertificateAssembler,
                                                  PrefixCompacted)

        def backlog(j: int):
            # a validator that lagged the dead writer resyncs from the
            # mirrored certificates (the auth evidence died with it);
            # below our GC base it installs the mirrored snapshot
            if j < self.ledger.log_base:
                raise PrefixCompacted(self._latest_snapshot,
                                      self.ledger.log_base)
            return self.ledger.log_op(j), None, self._certs.get(j)

        assembler = CertificateAssembler(
            self.bft_validators, self.bft_keys, self.bft_quorum,
            timeout_s=self.bft_timeout_s, backlog_fn=backlog)
        try:
            while not self._stop.is_set():
                ix = self.ledger.log_size() - 1
                op = self.ledger.log_op(ix)
                prev = chain_head_at(self.ledger, ix) or b"\0" * 32
                cert = assembler.certify(ix, op, None, prev)
                if cert is not None:
                    self._certs[ix] = cert.to_wire()
                    return
                mop = assembler.superseded_op
                if mop is not None:
                    if mop[:1] == bytes([OP_PROMOTE]):
                        # a live rival's fence won the position
                        self._rollback_last_op()
                        raise PromotionSuperseded(
                            f"standby {self.index}: a foreign fence op "
                            f"is bound at position {ix}")
                    mcert = assembler.certify(ix, mop, None, prev)
                    if mcert is not None:
                        self._rollback_last_op()    # drop our fence
                        st = self.ledger.apply_op(mop)
                        if st != LedgerStatus.OK:
                            raise RuntimeError(
                                f"standby {self.index}: mandated op at "
                                f"{ix} does not apply: {st.name}")
                        self._certs[ix] = mcert.to_wire()
                        st = self.ledger.promote_writer(
                            self.ledger.generation + 1, self.index)
                        if st != LedgerStatus.OK:
                            raise RuntimeError(
                                f"re-fence rejected: {st.name}")
                        self._say(f"adopted the dead writer's stranded op "
                                  f"at {ix}; re-fencing at {ix + 1}")
                        continue
                self._say("promotion fence op gathered no validator "
                          "quorum yet; retrying")
                time.sleep(max(self.heartbeat_s, 0.5))
        finally:
            assembler.close()
        raise RuntimeError(f"standby {self.index}: stopped before the "
                           f"promotion fence op certified")

    def _promote_and_serve(self) -> None:
        if self._model_blob is None:
            raise RuntimeError("cannot promote: no model blob mirrored yet")
        if self.read_server is not None:
            # the promoted server serves everything on the real port
            self.read_server.close()
            self.read_server = None
        st = self.ledger.promote_writer(self.ledger.generation + 1,
                                        self.index)
        if st != LedgerStatus.OK:
            raise RuntimeError(f"promotion fence rejected: {st.name}")
        if self.bft_keys:
            self._certify_promotion()
        evidence = None
        if self.wallet is not None:
            evidence = make_promotion_evidence(self.ledger, self.wallet,
                                               self.index)
            if self.bft_keys:
                # the evidence cites the highest certified op: the
                # promote op itself
                evidence["cert_ix"] = self.ledger.log_size() - 1
        missing = [h.hex()[:12] for h in
                   [u.payload_hash for u in self.ledger.query_all_updates()]
                   + ([e.payload_hash
                       for e in self.ledger.async_buffer_view()]
                      if async_enabled(self.cfg) else [])
                   if h not in self._blobs]
        if missing:
            self._say(f"promoting with {len(missing)} unmirrored update "
                      f"blobs {missing} — relying on uploader retries / "
                      f"stall recovery")
        self.server = LedgerServer(
            self.cfg, self._model_blob,
            directory=self._directory,
            require_auth=self.require_auth,
            stall_timeout_s=self.stall_timeout_s,
            resume_ledger=self.ledger,
            resume_blobs=self._blobs,
            sock=self._sock,
            wal_path=self.wal_path,
            standby_keys=self.standby_keys,
            promotion_evidence=evidence,
            quorum=self.quorum,
            quorum_timeout_s=self.quorum_timeout_s,
            bft_validators=self.bft_validators or None,
            bft_keys=self.bft_keys or None,
            bft_quorum=self.bft_quorum or None,
            bft_timeout_s=self.bft_timeout_s,
            resume_certs=dict(self._certs) if self.bft_keys else None,
            tls=self.tls_server,
            snapshot_interval=self.snapshot_interval,
            snapshot_dir=self.snapshot_dir,
            resume_snapshot=self._latest_snapshot,
            device=self.device,
            verbose=self.verbose)
        # a client the mirrored directory missed re-presents its
        # (self-authenticating) key on register
        self.server._open_enrollment = True
        self.promoted.set()
        self._say(f"promoted: serving on {self.host}:{self.port} at epoch "
                  f"{self.ledger.epoch}")
        self.server.serve_forever()
