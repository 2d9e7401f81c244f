"""Length-prefixed message framing for the control-plane socket protocol.

Port of `bflc_demo_tpu/comm/wire.py`, byte-compatible with its frames,
so a port client can talk to a reference writer and back:

    [4-byte big-endian length][UTF-8 JSON object]

A message with top-level `bytes` values (upload payloads, model and blob
replies) rides the binary variant

    [4-byte length][\\x00BIN1][4-byte header length][JSON header][raw tail]

whose header is the message minus its bytes fields plus a
`_bin: [[field, length], ...]` manifest; a frame body of at least
`BFLC_WIRE_COMPRESS_MIN` bytes (default 4 KiB) is sent deflated as

    [4-byte length][\\x00ZIP1][4-byte raw length][zlib level 1 (body)]

when that shrinks it.  Every receive path takes all three variants.
Frames are capped at 256 MiB, and every manifest length and claimed raw
length is checked against the frame before anything is allocated.
`BFLC_CONTROL_PLANE_LEGACY=1` sends bytes as hex inside JSON and
`BFLC_DATA_PLANE_LEGACY=1` turns compression off, as in the reference.
Send and receive time and bytes are charged to `utils/tracing.PROC`.

Dropped: the fault injector (the chaos campaign, ROADMAP A14), the obs
metrics and trace-context hooks (A14), and zstd frames (sent by the
reference only under `BFLC_WIRE_ZSTD=1`; a zstd frame is a WireError
here).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import time
import zlib
from typing import Any, Dict, Optional

from bflc_demo_tpu_torch.utils import tracing

MAX_FRAME = 256 << 20

_BIN_MAGIC = b"\x00BIN1"
_ZLIB_MAGIC = b"\x00ZIP1"
_ZSTD_MAGIC = b"\x00ZST1"

_JSON_ONLY = bool(os.environ.get("BFLC_CONTROL_PLANE_LEGACY"))
_NO_COMPRESS = _JSON_ONLY or bool(os.environ.get("BFLC_DATA_PLANE_LEGACY"))
_COMPRESS_MIN = int(os.environ.get("BFLC_WIRE_COMPRESS_MIN", 4096))


class WireError(ConnectionError):
    """Framing violation or unexpected EOF mid-frame."""


def blob_bytes(value) -> bytes:
    """A blob field: raw bytes from a binary frame, or a hex string from
    a JSON frame.  ValueError on anything else."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, str):
        return bytes.fromhex(value)
    raise ValueError(f"blob field is {type(value).__name__}, "
                     f"expected bytes or hex str")


def split_blob_parts(reply: Dict[str, Any],
                     verify: bool = True) -> Dict[str, bytes]:
    """{hex_hash: bytes} of a batched `blobs` reply
    (``{parts: [[hex_hash, length], ...], blob: <tail>}``).  Every part is
    checked against its own hash; malformed or lying parts are left out,
    and callers treat absence as a miss.  `verify` False takes the parts
    by the manifest alone, for blobs keyed by another digest than
    SHA-256 (the executor's evidence, keyed by payload fingerprints)."""
    out: Dict[str, bytes] = {}
    try:
        raw = blob_bytes(reply.get("blob", b""))
        off = 0
        for entry in reply.get("parts", []):
            h, n = str(entry[0]), int(entry[1])
            if n < 0 or off + n > len(raw):
                break
            part = raw[off:off + n]
            off += n
            if not verify or hashlib.sha256(part).hexdigest() == h:
                out[h] = part
    except (TypeError, ValueError, IndexError, KeyError, AttributeError):
        pass
    return out


def _encode(msg: Dict[str, Any]) -> bytes:
    """Message dict -> frame body (the binary variant when a top-level
    value is bytes, unless the legacy switch asks for hex-in-JSON)."""
    bin_fields = [(k, v) for k, v in msg.items()
                  if isinstance(v, (bytes, bytearray, memoryview))]
    if not bin_fields:
        return json.dumps(msg, separators=(",", ":")).encode()
    if _JSON_ONLY:
        patched = {k: (bytes(v).hex()
                       if isinstance(v, (bytes, bytearray, memoryview))
                       else v) for k, v in msg.items()}
        return json.dumps(patched, separators=(",", ":")).encode()
    head = {k: v for k, v in msg.items()
            if not isinstance(v, (bytes, bytearray, memoryview))}
    head["_bin"] = [[k, len(v)] for k, v in bin_fields]
    hdata = json.dumps(head, separators=(",", ":")).encode()
    return b"".join([_BIN_MAGIC, struct.pack(">I", len(hdata)), hdata]
                    + [bytes(v) for _, v in bin_fields])


def _decode_binary(body: bytes) -> Dict[str, Any]:
    """Binary frame body -> message dict, every length checked against
    the body."""
    off = len(_BIN_MAGIC)
    if len(body) < off + 4:
        raise WireError("truncated binary frame header")
    (hlen,) = struct.unpack_from(">I", body, off)
    off += 4
    if hlen > len(body) - off:
        raise WireError(f"binary frame header length {hlen} overruns "
                        f"frame of {len(body)} bytes")
    try:
        msg = json.loads(body[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable binary frame header: {e}") from e
    if not isinstance(msg, dict):
        raise WireError("binary frame header is not a JSON object")
    off += hlen
    manifest = msg.pop("_bin", [])
    if not isinstance(manifest, list):
        raise WireError("binary frame manifest is not a list")
    for entry in manifest:
        try:
            key, n = str(entry[0]), int(entry[1])
        except (TypeError, ValueError, IndexError, KeyError) as e:
            raise WireError(f"malformed binary manifest entry: {e}") from e
        if n < 0 or n > len(body) - off:
            raise WireError(f"binary field {key!r} length {n} overruns "
                            f"frame tail of {len(body) - off} bytes")
        msg[key] = body[off:off + n]
        off += n
    if off != len(body):
        raise WireError(f"{len(body) - off} trailing bytes after the "
                        f"binary frame manifest")
    return msg


def _maybe_compress(data: bytes) -> bytes:
    """Deflate (level 1) a body past the threshold when that wins."""
    if _NO_COMPRESS or len(data) < _COMPRESS_MIN:
        return data
    framed = (_ZLIB_MAGIC + struct.pack(">I", len(data))
              + zlib.compress(data, 1))
    return data if len(framed) >= len(data) else framed


def _decompress(body: bytes) -> bytes:
    """Inflate a compressed body, bounded by its claimed raw length,
    which must lie in (0, MAX_FRAME]."""
    if len(body) < 9:
        raise WireError("truncated compressed frame header")
    if body[:5] == _ZSTD_MAGIC:
        raise WireError("zstd frames are not supported (send zlib)")
    (raw_len,) = struct.unpack_from(">I", body, 5)
    if not 0 < raw_len <= MAX_FRAME:
        raise WireError(f"compressed frame claims {raw_len} raw bytes, "
                        f"outside (0, cap]")
    try:
        d = zlib.decompressobj()
        raw = d.decompress(body[9:], raw_len)
        if d.unconsumed_tail or not d.eof:
            raise WireError("compressed frame body overruns its claimed "
                            "raw length")
    except (zlib.error, MemoryError) as e:
        raise WireError(f"undecodable compressed frame: {e}") from e
    if len(raw) != raw_len:
        raise WireError(f"compressed frame inflated to {len(raw)} bytes, "
                        f"claimed {raw_len}")
    return raw


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> None:
    tr = tracing.PROC
    t0 = time.perf_counter() if tr.enabled else 0.0
    data = _encode(msg)
    if len(data) > MAX_FRAME:
        raise WireError(f"frame too large: {len(data)}")
    data = _maybe_compress(data)
    sock.sendall(struct.pack(">I", len(data)) + data)
    if tr.enabled:
        tr.charge("wire.send_s", time.perf_counter() - t0)
        tr.charge("wire.bytes_out", 4 + len(data))


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly n bytes; None on clean EOF at a frame boundary.  Reads
    into one preallocated buffer (`recv_into`, no flags, which a TLS
    socket refuses): a TLS socket returns at most one record (<= 16 KiB)
    a call, so a model-sized frame takes thousands of reads."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            if not got:
                return None
            raise WireError(f"EOF mid-frame ({got}/{n} bytes)")
        got += k
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """One frame of any variant; None on clean EOF.  Timing starts after
    the length prefix (the wait before it is the peer's, not the wire's)."""
    header = recv_exact(sock, 4)
    if header is None:
        return None
    tr = tracing.PROC
    t0 = time.perf_counter() if tr.enabled else 0.0
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds cap")
    body = recv_exact(sock, length)
    if body is None:
        raise WireError("EOF between header and body")
    try:
        inner = (_decompress(body)
                 if body[:5] in (_ZLIB_MAGIC, _ZSTD_MAGIC) else body)
        if inner.startswith(_BIN_MAGIC):
            return _decode_binary(inner)
        try:
            msg = json.loads(inner.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WireError(f"undecodable frame: {e}") from e
        if not isinstance(msg, dict):
            raise WireError("frame is not a JSON object")
        return msg
    finally:
        if tr.enabled:
            tr.charge("wire.recv_s", time.perf_counter() - t0)
            tr.charge("wire.bytes_in", 4 + len(body))
