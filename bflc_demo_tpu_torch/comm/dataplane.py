"""The read path of the data plane: shared read serving and the client's
cache.

Port of `bflc_demo_tpu/comm/dataplane.py` over the coordinator alone:

- `handle_read` (:132) is the one serving dispatch of the `blob`,
  `blobs` and `model` wire methods (the writer answers every read
  through it; `model` with `meta` is the cheap epoch + hash probe, and
  `want` names the exact model asked for);
- `BlobCache` (:87) is a content-addressed LRU bounded by bytes: a key
  is its value's SHA-256, so a hit can never serve wrong bytes;
- `ReadRouter` (:320) is the client half: the model's meta from the
  writer, then the bytes from the cache or the writer, every byte
  checked against the hash the writer asserted.

`BFLC_DATA_PLANE_LEGACY=1` pins the fast path off (no cache, no meta
probe), as in the reference.  Not ported yet: `ReadFanoutServer` (:219)
and the replica read set (the standby item, ROADMAP A9) — a writer
without standbys advertises none, so the reference's router would go to
the writer too; the snapshot read (A9, snapshots); the obs metrics and
spans (A14).
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bflc_demo_tpu_torch.comm.wire import blob_bytes, split_blob_parts


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
                                                         bytes]]]
                ) -> Optional[dict]:
    """Serve one `blob`/`blobs`/`model` read; None for any other method."""
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
        if not m.get("meta"):
            reply["blob"] = model_blob
        return reply
    return None


class ReadRouter:
    """Client-side read path: cache -> the writer.  `control` is the
    request surface (`CoordinatorClient` or `FailoverClient`)."""

    def __init__(self, control, cache: Optional[BlobCache] = None):
        self.control = control
        self.cache = cache if cache is not None else BlobCache()
        self.legacy = data_plane_legacy()

    def _take_writer_model(self, r: dict) -> dict:
        if r.get("ok"):
            blob = blob_bytes(r["blob"])
            if not self.legacy:
                self.cache.put(hashlib.sha256(blob).hexdigest(), blob)
            r["blob"] = blob
            r["source"] = "writer"
        return r

    def fetch_model(self) -> dict:
        """The committed global model as `{ok, epoch, hash, blob}` (raw
        bytes), `source` saying who moved them (cache or writer)."""
        if self.legacy or not len(self.cache):
            # nothing cached: a meta probe could not save a round trip
            return self._take_writer_model(self.control.request("model"))
        meta = self.control.request("model", meta=1)
        if not meta.get("ok"):
            return meta
        if "blob" in meta:              # a server that ignores `meta`
            return self._take_writer_model(meta)
        blob = self.cache.get(meta.get("hash", ""))
        if blob is not None:
            return {**meta, "blob": blob, "source": "cache"}
        return self._take_writer_model(self.control.request("model"))

    def fetch_blobs(self, hashes: Sequence[str]) -> Dict[str, bytes]:
        """{hex_hash: verified bytes} for every hash: cache -> one batched
        writer fetch -> per-hash writer fetches.  LookupError when a hash
        cannot be fetched."""
        out: Dict[str, bytes] = {}
        need: List[str] = []
        for h in hashes:
            b = self.cache.get(h) if not self.legacy else None
            if b is not None:
                out[h] = b
            elif h not in need:
                need.append(h)
        if need:
            r = self.control.request("blobs", hashes=need)
            if r.get("ok"):
                for h, part in split_blob_parts(r).items():
                    if h in need:
                        out[h] = part
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
        if not self.legacy:
            for h, b in out.items():
                self.cache.put(h, b)
        missing = [h for h in hashes if h not in out]
        if missing:
            raise LookupError(f"blobs unavailable from every source: "
                              f"{[h[:12] for h in missing]}")
        return out

