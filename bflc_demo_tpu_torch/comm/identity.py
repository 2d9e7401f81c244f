"""Client identity: Ed25519 wallets with their X25519 half, the public
directory, the HMAC keyring and the authenticated ledger.

Port of `bflc_demo_tpu/comm/identity.py`, whole: `verify_signature`
with its bounded verification memo (:75-138) and
`verify_signatures_batch` (:140-178), the certificate paths' batch
check (one shared multiscalar mul under the pure-Python backend, a loop
under the `cryptography` wheel); the HMAC `KeyRing` (:181-198);
`address_of` (:200); `Wallet` (:207) with its X25519 key
(`dh_public_bytes`, `pair_secret`, :266-278) and its signer surface
`mac` (:260-264); `PublicDirectory` (:280); `provision_wallets` (:312);
`ReplayGuard` (:324); `_op_bytes` (:350); `AuthenticatedLedger`
(:361-432) and `sign_register`, `sign_upload`, `sign_scores`
(:434-447).

Two trust models behind one signer surface (`mac`) and one verifier
surface (`verify`), so that `AuthenticatedLedger` and `FLNode` take
either: the `KeyRing`'s HMAC-SHA256 secrets derived from a master seed
(the verifier can forge any client's tag; closed deployments and
tests), and the wallets' Ed25519 keys behind a `PublicDirectory` (the
writer can check a tag but cannot forge one, and an address is the hash
of the key that signs for it).  Every client op the process fleet sends
is signed by its wallet.  `pair_secret` gives a client pair a shared
seed by Diffie-Hellman, `sha256(b"bflc-pair|" + shared + b"|" +
context)`, which `parallel/secure.py` turns into the pair's masks: the
aggregator holds neither private key and cannot strip them.  Tags bind
the op kind, the sender, the epoch and the payload, and each tag is
single-use at an `AuthenticatedLedger` (a replay answers DUPLICATE;
Ed25519 and HMAC are deterministic, so an honest retry after a
transient rejection sends the same tag).

The backend is the reference's choice: the `cryptography` wheel when it
imports, else the pure-Python `comm/pure25519.py`.  Both give the same
public keys, signatures and DH secrets for the same seed, so a port
wallet's tag verifies at a reference writer and back.  Signing and
verification charge `crypto.sign_s` / `crypto.verify_s` (and their
counts) to `utils/tracing.PROC`.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
import time
from typing import Dict, List, Sequence, Tuple

from bflc_demo_tpu_torch.comm import pure25519 as _pure
from bflc_demo_tpu_torch.ledger.base import LedgerStatus
from bflc_demo_tpu_torch.utils import tracing

try:                                    # prefer the C-backed implementation
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization as _ser
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey, Ed25519PublicKey)
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    ED25519_BACKEND = "cryptography"
except ImportError:
    ED25519_BACKEND = "pure-python"

# verification memo: a deterministic pure function behind a bounded map
# keyed on the whole (pubkey, message, signature) triple; disabled by
# BFLC_CONTROL_PLANE_LEGACY=1 at import, as in the reference
_MEMO_ENABLED = not os.environ.get("BFLC_CONTROL_PLANE_LEGACY")
_VERIFY_MEMO: Dict[bytes, bool] = {}
_VERIFY_MEMO_MAX = 8192


def _memo_key(public_bytes: bytes, message: bytes, signature: bytes,
              domain: bytes = b"1") -> bytes:
    # the domain byte keeps per-item (cofactorless, b"1") verdicts apart
    # from batch (cofactored, b"8") ones: they differ on torsion defects
    h = hashlib.sha256()
    h.update(domain)
    h.update(struct.pack("<qq", len(public_bytes), len(signature)))
    h.update(public_bytes)
    h.update(signature)
    h.update(message)
    return h.digest()


def _verify_signature_raw(public_bytes: bytes, message: bytes,
                          signature: bytes) -> bool:
    if ED25519_BACKEND == "cryptography":
        try:
            Ed25519PublicKey.from_public_bytes(public_bytes).verify(
                signature, message)
            return True
        except (InvalidSignature, ValueError):
            return False
    return _pure.ed25519_verify(public_bytes, message, signature)


def _verify_signature_timed(public_bytes: bytes, message: bytes,
                            signature: bytes) -> bool:
    tr = tracing.PROC
    if tr.enabled:
        t0 = time.perf_counter()
        ok = _verify_signature_raw(public_bytes, message, signature)
        tr.charge("crypto.verify_s", time.perf_counter() - t0)
        tr.charge("crypto.verify_n")
        return ok
    return _verify_signature_raw(public_bytes, message, signature)


def verify_signature(public_bytes: bytes, message: bytes,
                     signature: bytes) -> bool:
    """The one Ed25519 verification point.  Never raises on malformed
    input: a hostile peer's garbage is False."""
    if not _MEMO_ENABLED:
        return _verify_signature_timed(public_bytes, message, signature)
    key = _memo_key(public_bytes, message, signature)
    hit = _VERIFY_MEMO.get(key)
    if hit is not None:
        return hit
    ok = _verify_signature_timed(public_bytes, message, signature)
    _memo_store(key, ok)
    return ok


def _memo_store(key: bytes, ok: bool) -> None:
    if len(_VERIFY_MEMO) >= _VERIFY_MEMO_MAX:
        try:
            _VERIFY_MEMO.pop(next(iter(_VERIFY_MEMO)))
        except KeyError:                # racing evictors: already gone
            pass
    _VERIFY_MEMO[key] = ok


def verify_signatures_batch(items: Sequence[Tuple[bytes, bytes, bytes]]
                            ) -> bool:
    """True iff every (pubkey, message, signature) triple verifies
    (cofactored semantics for the items that reach the batch).  False
    only says that one failed: a caller that needs to know which falls
    back to `verify_signature` per item.  Under the pure-Python backend
    this is Ed25519 batch verification fed through the memo; under the
    `cryptography` wheel, which has no batch API, a loop."""
    if ED25519_BACKEND == "cryptography" or not _MEMO_ENABLED:
        return all(verify_signature(p, m, s) for p, m, s in items)
    pending = []
    for it in items:
        key = _memo_key(it[0], it[1], it[2], domain=b"8")
        hit = _VERIFY_MEMO.get(key)
        if hit is False:
            return False
        if hit is None:
            pending.append((key, it))
    if not pending:
        return True
    tr = tracing.PROC
    t0 = time.perf_counter() if tr.enabled else 0.0
    ok = _pure.ed25519_verify_batch([it for _, it in pending])
    if tr.enabled:
        tr.charge("crypto.verify_s", time.perf_counter() - t0)
        tr.charge("crypto.verify_n", len(pending))
    if ok:
        # only positives memoize: a failed batch does not say which item
        for key, _ in pending:
            _memo_store(key, True)
    return ok


class KeyRing:
    """Per-client HMAC-SHA256 secrets derived from one master seed."""

    def __init__(self, master_seed: bytes):
        if len(master_seed) < 16:
            raise ValueError("master seed must be at least 16 bytes")
        self._master = bytes(master_seed)

    def secret_for(self, address: str) -> bytes:
        return hashlib.sha256(self._master + b"|" + address.encode()).digest()

    def mac(self, address: str, op_bytes: bytes) -> bytes:
        return hmac.new(self.secret_for(address), op_bytes,
                        hashlib.sha256).digest()

    def verify(self, address: str, op_bytes: bytes, tag: bytes) -> bool:
        return hmac.compare_digest(self.mac(address, op_bytes), tag)


def address_of(public_bytes: bytes) -> str:
    """Self-authenticating address: 0x + the first 20 bytes of
    sha256(pubkey), so an address claim is checkable against the key."""
    return "0x" + hashlib.sha256(public_bytes).hexdigest()[:40]


class Wallet:
    """One client's identity: Ed25519 signing and X25519 agreement, built
    from raw 32-byte private keys so that both backends give the same
    public keys, signatures and DH secrets."""

    def __init__(self, sign_private: bytes, dh_private: bytes):
        if len(sign_private) != 32 or len(dh_private) != 32:
            raise ValueError("wallet private keys must be 32 raw bytes")
        self._sign_sk = bytes(sign_private)
        self._dh_sk = bytes(dh_private)
        if ED25519_BACKEND == "cryptography":
            self._sign = Ed25519PrivateKey.from_private_bytes(self._sign_sk)
            self._dh = X25519PrivateKey.from_private_bytes(self._dh_sk)
            self.public_bytes = self._sign.public_key().public_bytes(
                _ser.Encoding.Raw, _ser.PublicFormat.Raw)
            self.dh_public_bytes = self._dh.public_key().public_bytes(
                _ser.Encoding.Raw, _ser.PublicFormat.Raw)
        else:
            self.public_bytes = _pure.ed25519_public(self._sign_sk)
            self.dh_public_bytes = _pure.x25519_public(self._dh_sk)
        self.address = address_of(self.public_bytes)

    @classmethod
    def generate(cls) -> "Wallet":
        """A fresh random identity (`os.urandom`, the reference's)."""
        return cls(os.urandom(32), os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "Wallet":
        sk = hashlib.sha256(b"bflc-ed25519|" + seed).digest()
        dk = hashlib.sha256(b"bflc-x25519|" + seed).digest()
        return cls(sk, dk)

    def sign(self, op_bytes: bytes) -> bytes:
        tr = tracing.PROC
        t0 = time.perf_counter() if tr.enabled else 0.0
        if ED25519_BACKEND == "cryptography":
            sig = self._sign.sign(op_bytes)
        else:
            sig = _pure.ed25519_sign(self._sign_sk, op_bytes)
        if tr.enabled:
            tr.charge("crypto.sign_s", time.perf_counter() - t0)
            tr.charge("crypto.sign_n")
        return sig

    def mac(self, address: str, op_bytes: bytes) -> bytes:
        """The signer surface `KeyRing` shares: a wallet signs only for
        its own address."""
        if address != self.address:
            raise ValueError(f"wallet for {self.address} cannot sign for "
                             f"{address}")
        return self.sign(op_bytes)

    def pair_secret(self, their_dh_public: bytes, context: bytes = b""
                    ) -> bytes:
        """The X25519 shared secret with another wallet, hashed with
        `context` (the round): both endpoints derive the same 32 bytes,
        and whoever holds neither private key cannot."""
        if ED25519_BACKEND == "cryptography":
            shared = self._dh.exchange(X25519PublicKey.from_public_bytes(
                their_dh_public))
        else:
            shared = _pure.x25519_exchange(self._dh_sk, their_dh_public)
        return hashlib.sha256(b"bflc-pair|" + shared + b"|" + context
                              ).digest()


class PublicDirectory:
    """Verifier-side registry: address -> Ed25519 public key, nothing
    else — what the writer holds."""

    def __init__(self):
        self._raw: Dict[str, bytes] = {}

    def enroll(self, public_bytes: bytes) -> str:
        addr = address_of(public_bytes)
        self._raw[addr] = bytes(public_bytes)
        return addr

    def export_raw(self) -> Dict[str, bytes]:
        return dict(self._raw)

    def knows(self, address: str) -> bool:
        return address in self._raw

    def verify(self, address: str, op_bytes: bytes, tag: bytes) -> bool:
        pub = self._raw.get(address)
        if pub is None:
            return False
        return verify_signature(pub, op_bytes, tag)


def provision_wallets(n: int, master_seed: bytes,
                      ) -> Tuple[List[Wallet], PublicDirectory]:
    """N wallets from `master_seed` and the writer's directory of them."""
    wallets = [Wallet.from_seed(master_seed + struct.pack("<q", i))
               for i in range(n)]
    directory = PublicDirectory()
    for w in wallets:
        directory.enroll(w.public_bytes)
    return wallets, directory


class ReplayGuard:
    """Single-use tags bucketed by op epoch; buckets behind the ledger's
    epoch are pruned on consume (their replays fail WRONG_EPOCH anyway)."""

    def __init__(self):
        self._seen: Dict[int, set] = {}

    def seen(self, epoch: int, tag: bytes) -> bool:
        return tag in self._seen.get(epoch, ())

    def consume(self, current_epoch: int, epoch: int, tag: bytes) -> None:
        """Mark a tag used — only after the ledger accepted the op, so a
        transiently rejected op can be retried with the same signature."""
        for ep in [e for e in self._seen if e < current_epoch]:
            del self._seen[ep]
        self._seen.setdefault(epoch, set()).add(tag)


def _op_bytes(kind: str, sender: str, epoch: int, payload: bytes) -> bytes:
    """The signed message: kind, sender, epoch and payload, each
    length-prefixed (the reference's bytes)."""
    b = bytearray()
    kb = kind.encode()
    sb = sender.encode()
    b += struct.pack("<q", len(kb)) + kb
    b += struct.pack("<q", len(sb)) + sb
    b += struct.pack("<q", epoch)
    b += struct.pack("<q", len(payload)) + payload
    return bytes(b)


class AuthenticatedLedger:
    """A tag-verifying proxy in front of a ledger backend.

    Client mutations (register, upload, scores) need a valid tag; reads
    and the writer's own ops (commit, recovery) pass through.  `keyring`
    is anything with `verify(address, op_bytes, tag)`: a `KeyRing` or a
    `PublicDirectory`."""

    def __init__(self, inner, keyring):
        self._inner = inner
        self._keys = keyring
        self._guard = ReplayGuard()

    def _verify(self, kind: str, sender: str, epoch: int, payload: bytes,
                tag: bytes) -> LedgerStatus:
        """OK: a fresh valid tag; DUPLICATE: valid but consumed (a retry
        whose reply was lost, or a replay: the op is in either way);
        BAD_ARG: the tag does not verify."""
        if not self._keys.verify(sender, _op_bytes(kind, sender, epoch,
                                                   payload), tag):
            return LedgerStatus.BAD_ARG
        if self._guard.seen(epoch, tag):
            return LedgerStatus.DUPLICATE
        return LedgerStatus.OK

    def _consume(self, epoch: int, tag: bytes) -> None:
        self._guard.consume(self._inner.epoch, epoch, tag)

    def register_node(self, addr: str, tag: bytes) -> LedgerStatus:
        v = self._verify("register", addr, 0, b"", tag)
        if v != LedgerStatus.OK:
            return v
        st = self._inner.register_node(addr)
        if st == LedgerStatus.OK:
            self._consume(0, tag)
        return st

    def upload_local_update(self, sender: str, payload_hash: bytes,
                            n_samples: int, avg_cost: float, epoch: int,
                            tag: bytes) -> LedgerStatus:
        body = payload_hash + struct.pack("<qd", n_samples, avg_cost)
        v = self._verify("upload", sender, epoch, body, tag)
        if v != LedgerStatus.OK:
            return v
        st = self._inner.upload_local_update(sender, payload_hash,
                                             n_samples, avg_cost, epoch)
        if st == LedgerStatus.OK:
            self._consume(epoch, tag)
        return st

    def upload_scores(self, sender: str, epoch: int,
                      scores: Sequence[float], tag: bytes) -> LedgerStatus:
        body = struct.pack(f"<{len(scores)}d", *scores)
        v = self._verify("scores", sender, epoch, body, tag)
        if v != LedgerStatus.OK:
            return v
        st = self._inner.upload_scores(sender, epoch, scores)
        if st == LedgerStatus.OK:
            self._consume(epoch, tag)
        return st

    def __getattr__(self, name):
        return getattr(self._inner, name)


def sign_register(keys, addr: str) -> bytes:
    return keys.mac(addr, _op_bytes("register", addr, 0, b""))


def sign_upload(keys, sender: str, payload_hash: bytes, n_samples: int,
                avg_cost: float, epoch: int) -> bytes:
    body = payload_hash + struct.pack("<qd", n_samples, avg_cost)
    return keys.mac(sender, _op_bytes("upload", sender, epoch, body))


def sign_scores(keys, sender: str, epoch: int,
                scores: Sequence[float]) -> bytes:
    body = struct.pack(f"<{len(scores)}d", *scores)
    return keys.mac(sender, _op_bytes("scores", sender, epoch, body))
