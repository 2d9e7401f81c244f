"""The read path of the data plane: shared read serving, the replicas'
read fan-out and the client's cache.

Port of `bflc_demo_tpu/comm/dataplane.py`:

- `handle_read` (:132) is the one serving dispatch of the `blob`,
  `blobs` and `model` wire methods — the writer and the standbys' read
  servers answer every read through it (`model` with `meta` is the cheap
  epoch + hash probe, `want` names the exact model asked for, and the
  writer's reply carries the advertised `read_set`) — and, on a replica,
  of `snapshot` (:197-208): the snapshot it mirrored, so a joiner's
  state-sync bytes come off the writer (`want_i` names the checkpoint
  the joiner verified against the writer; another one declines);
- `ReadFanoutServer` (:219-319) is a standby's read-only socket over the
  state it already mirrored (every payload blob before its op's ack, the
  model blob checked against the replayed ledger); it refuses every
  mutation;
- `BlobCache` (:87) is a content-addressed LRU bounded by bytes: a key
  is its value's SHA-256, so a hit can never serve wrong bytes;
- `ReadRouter` (:320-537) is the client half: the model's meta from the
  writer (the authoritative hash), then the bytes from the cache, the
  advertised read set round-robin, or the writer, every byte checked
  against the hash the writer asserted — a stale or lying replica falls
  back to the writer, a dead one is dropped.

`BFLC_DATA_PLANE_LEGACY=1` pins the fast path off (no cache, no read
set, no meta probe), as in the reference.  `ReadFanoutServer` and
`ReadRouter` take `tls` (a server and a client context, `comm/tls.py`).
Not ported: the obs metrics and spans (A14).
"""

from __future__ import annotations

import collections
import hashlib
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bflc_demo_tpu_torch.comm.wire import (WireError, blob_bytes, recv_msg,
                                           send_msg, split_blob_parts)

Endpoint = Tuple[str, int]


def data_plane_legacy() -> bool:
    """True when the fast path is pinned off."""
    return bool(os.environ.get("BFLC_DATA_PLANE_LEGACY"))


class BlobCache:
    """Content-addressed LRU keyed by hex sha256, bounded by bytes."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._store: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        self._bytes = 0

    def get(self, hex_hash: str) -> Optional[bytes]:
        with self._lock:
            blob = self._store.get(hex_hash)
            if blob is not None:
                self._store.move_to_end(hex_hash)
        return blob

    def put(self, hex_hash: str, blob: bytes) -> None:
        if len(blob) > self.max_bytes:
            return                      # one oversized blob must not
        with self._lock:                # flush the whole working set
            old = self._store.pop(hex_hash, None)
            if old is not None:
                self._bytes -= len(old)
            self._store[hex_hash] = blob
            self._bytes += len(blob)
            while self._bytes > self.max_bytes:
                _, evicted = self._store.popitem(last=False)
                self._bytes -= len(evicted)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


def handle_read(method: str, m: dict, *,
                blob_lookup: Callable[[bytes], Optional[bytes]],
                model_state: Callable[[], Optional[Tuple[int, bytes,
                                                         bytes]]],
                read_set: object = (),
                snapshot_state: Optional[Callable[[], Optional[dict]]]
                = None) -> Optional[dict]:
    """Serve one `blob`/`blobs`/`model` read (and `snapshot` where
    `snapshot_state` gives the mirrored meta); None for any other method.
    `read_set` is a sequence of endpoints or a callable giving one,
    evaluated only for `model`."""
    if method == "blob":
        blob = blob_lookup(bytes.fromhex(m["hash"]))
        if blob is None:
            return {"ok": False, "error": "unknown blob"}
        return {"ok": True, "blob": blob}
    if method == "blobs":
        # held blobs back to back in the binary tail with a [hash, length]
        # manifest; unknown hashes are absent (callers fall back per hash)
        parts: List[List] = []
        tail: List[bytes] = []
        for h in list(m.get("hashes", []))[:256]:
            try:
                b = blob_lookup(bytes.fromhex(h))
            except (TypeError, ValueError):
                b = None
            if b is not None:
                parts.append([h, len(b)])
                tail.append(b)
        return {"ok": True, "parts": parts, "blob": b"".join(tail)}
    if method == "model":
        st = model_state()
        if st is None:
            return {"ok": False, "error": "no model blob held"}
        epoch, model_hash, model_blob = st
        want = m.get("want")
        if want and want != model_hash.hex():
            return {"ok": False, "status": "STALE",
                    "epoch": epoch, "hash": model_hash.hex()}
        reply: dict = {"ok": True, "epoch": epoch, "hash": model_hash.hex()}
        rs = read_set() if callable(read_set) else read_set
        if rs:
            reply["read_set"] = [list(ep) for ep in rs]
        if not m.get("meta"):
            reply["blob"] = model_blob
        return reply
    if method == "snapshot" and snapshot_state is not None:
        # the joiner checks the writer-asserted binding and the hashes
        # before installing: a stale or lying replica costs a round trip
        from bflc_demo_tpu_torch.ledger.snapshot import offer_to_wire
        snap = snapshot_state()
        if snap is None:
            return {"ok": False, "error": "no snapshot mirrored"}
        want = m.get("want_i")
        if want is not None and int(want) != int(snap["i"]):
            return {"ok": False, "status": "STALE", "i": int(snap["i"])}
        return offer_to_wire(snap)
    return None


class ReadFanoutServer:
    """A replica's read-only serving socket: `blob`/`blobs`/`model` over
    already-mirrored, hash-verifiable state.  It holds no ledger
    authority, so a stale or lying replica can at worst serve bytes that
    fail the client's hash check.  A standby starts it at construction
    and closes it at promotion."""

    def __init__(self,
                 blob_lookup: Callable[[bytes], Optional[bytes]],
                 model_state: Callable[[], Optional[Tuple[int, bytes,
                                                          bytes]]],
                 host: str = "127.0.0.1", port: int = 0, tls=None,
                 snapshot_state: Optional[Callable[[], Optional[dict]]]
                 = None):
        self._blob_lookup = blob_lookup
        self._model_state = model_state
        self._snapshot_state = snapshot_state
        self._tls = tls                 # ssl.SSLContext or None
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()

    @property
    def endpoint(self) -> Endpoint:
        return (self.host, self.port)

    def start(self) -> None:
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def close(self) -> None:
        self._stop.set()
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
        if self._tls is not None:
            import ssl
            try:
                conn.settimeout(10.0)   # bound the handshake
                conn = self._tls.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (ssl.SSLError, OSError):
                try:
                    conn.close()
                except OSError:
                    pass
                return
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    return
                method = msg.get("method", "")
                try:
                    reply = handle_read(
                        method, msg, blob_lookup=self._blob_lookup,
                        model_state=self._model_state,
                        snapshot_state=self._snapshot_state)
                    if reply is None:
                        reply = {"ok": False,
                                 "error": f"read replica: unknown method "
                                          f"{method!r}"}
                except Exception as e:      # noqa: BLE001 — an error
                    # frame, never a silently dropped connection
                    reply = {"ok": False,
                             "error": f"{type(e).__name__}: {e}"}
                send_msg(conn, reply)
        except (WireError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class ReadRouter:
    """Client-side read path: cache -> advertised read set -> writer.
    `control` is the authoritative request surface (`CoordinatorClient`
    or `FailoverClient`): it answers the `model` meta probe (keeping the
    read set fresh) and is the always-correct fallback for the bytes."""

    def __init__(self, control, cache: Optional[BlobCache] = None,
                 timeout_s: float = 30.0, tls=None):
        self.control = control
        self._tls = tls                 # for dialling TLS read replicas
        self.cache = cache if cache is not None else BlobCache()
        self.legacy = data_plane_legacy()
        self._timeout_s = timeout_s
        self._read_set: List[Endpoint] = []
        self._conns: Dict[Endpoint, object] = {}
        self._rr = os.getpid()          # de-phase the fleet's round-robin
        # where the bytes came from: (kind, source) -> count
        self.reads: Dict[Tuple[str, str], int] = {}

    def _count(self, kind: str, source: str) -> None:
        self.reads[(kind, source)] = self.reads.get((kind, source), 0) + 1

    # -- read-set upkeep ---------------------------------------------------
    def note_read_set(self, reply: dict) -> None:
        rs = reply.get("read_set")
        if not isinstance(rs, list):
            return
        eps: List[Endpoint] = []
        for ep in rs:
            try:
                eps.append((str(ep[0]), int(ep[1])))
            except (TypeError, ValueError, IndexError):
                continue
        if eps != self._read_set:
            for ep in set(self._conns) - set(eps):
                self._drop_conn(ep)
            self._read_set = eps

    def _drop_conn(self, ep: Endpoint) -> None:
        c = self._conns.pop(ep, None)
        if c is not None:
            c.close()

    def _replica_request(self, method: str, **fields) -> Optional[dict]:
        """One read against the read set, round-robin with failover; None
        when no replica answered usefully.  The rotation base is fixed
        for the sweep and moves only past a replica that served."""
        from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
        n = len(self._read_set)
        base = self._rr
        for k in range(n):
            ep = self._read_set[(base + k) % n]
            try:
                c = self._conns.get(ep)
                if c is None:
                    c = CoordinatorClient(ep[0], ep[1],
                                          timeout_s=self._timeout_s,
                                          tls=self._tls)
                    self._conns[ep] = c
                reply = c.request(method, **fields)
            except (ConnectionError, WireError, OSError):
                self._drop_conn(ep)
                continue
            if reply.get("ok"):
                self._rr = (base + k + 1) % n
                return reply
        return None

    # -- model distribution ------------------------------------------------
    def _take_writer_model(self, r: dict) -> dict:
        if r.get("ok"):
            self.note_read_set(r)
            blob = blob_bytes(r["blob"])
            if not self.legacy:
                self.cache.put(hashlib.sha256(blob).hexdigest(), blob)
            r["blob"] = blob
            r["source"] = "writer"
            self._count("model", "writer")
        return r

    def fetch_model(self) -> dict:
        """The committed global model as `{ok, epoch, hash, blob}` (raw
        bytes), `source` saying who moved them (cache, replica, writer)."""
        if self.legacy or (not self._read_set and not len(self.cache)):
            # nothing cached and no replica known: a meta probe could not
            # save a round trip (the full reply brings the read set)
            return self._take_writer_model(self.control.request("model"))
        meta = self.control.request("model", meta=1)
        if not meta.get("ok"):
            return meta
        self.note_read_set(meta)
        want_hex = meta.get("hash", "")
        if "blob" in meta:              # a server that ignores `meta`
            return self._take_writer_model(meta)
        blob = self.cache.get(want_hex)
        if blob is not None:
            self._count("model", "cache")
            return {**meta, "blob": blob, "source": "cache"}
        if self._read_set:
            # ask the replicas for exactly the model the writer asserted;
            # one short retry bridges a commit still on its way to them
            for attempt in range(2):
                r = self._replica_request("model", want=want_hex)
                if r is not None:
                    try:
                        blob = blob_bytes(r.get("blob", b""))
                    except ValueError:
                        blob = b""
                    if hashlib.sha256(blob).hexdigest() == want_hex:
                        self.cache.put(want_hex, blob)
                        self._count("model", "replica")
                        return {**meta, "blob": blob, "source": "replica"}
                    break               # a lying replica: the writer
                if attempt == 0:
                    time.sleep(0.2)
        return self._take_writer_model(self.control.request("model"))

    # -- content-addressed blob fetches ------------------------------------
    def fetch_blobs(self, hashes: Sequence[str]) -> Dict[str, bytes]:
        """{hex_hash: verified bytes} for every hash: cache -> batched
        replica fetches -> one batched writer fetch -> per-hash writer
        fetches.  LookupError when a hash cannot be fetched."""
        out: Dict[str, bytes] = {}
        need: List[str] = []
        for h in hashes:
            b = self.cache.get(h) if not self.legacy else None
            if b is not None:
                out[h] = b
                self._count("blob", "cache")
            elif h not in need:
                need.append(h)
        if need and not self.legacy and self._read_set:
            # up to two replica sweeps: one that mirrored only part of the
            # round answers with what it holds, the next covers the rest
            for _ in range(min(2, len(self._read_set))):
                r = self._replica_request("blobs", hashes=need)
                if r is None:
                    break
                for h, part in split_blob_parts(r).items():
                    if h in need:
                        out[h] = part
                        self._count("blob", "replica")
                need = [h for h in need if h not in out]
                if not need:
                    break
        if need:
            r = self.control.request("blobs", hashes=need)
            if r.get("ok"):
                for h, part in split_blob_parts(r).items():
                    if h in need:
                        out[h] = part
                        self._count("blob", "writer")
            need = [h for h in need if h not in out]
        for h in need:
            r = self.control.request("blob", hash=h)
            if r.get("ok"):
                try:
                    b = blob_bytes(r.get("blob", b""))
                except ValueError:
                    continue
                if hashlib.sha256(b).hexdigest() == h:
                    out[h] = b
                    self._count("blob", "writer")
        if not self.legacy:
            for h, b in out.items():
                self.cache.put(h, b)
        missing = [h for h in hashes if h not in out]
        if missing:
            raise LookupError(f"blobs unavailable from every source: "
                              f"{[h[:12] for h in missing]}")
        return out

    def close(self) -> None:
        for ep in list(self._conns):
            self._drop_conn(ep)
