"""Client identity: Ed25519 wallets, the public directory, replay guard.

Port of the synchronous subset of `bflc_demo_tpu/comm/identity.py`:
`address_of` (:200), `Wallet` (:207) without its X25519 pair secret,
`PublicDirectory` (:280), `provision_wallets` (:312), `ReplayGuard`
(:324), `_op_bytes` (:350), `verify_signature` with its bounded
verification memo (:75-138) and `verify_signatures_batch` (:140-178),
the certificate paths' batch check (one shared multiscalar mul under the
pure-Python backend, a loop under the `cryptography` wheel).  Every
client op the process fleet sends is signed by its wallet and verified
by the writer against the directory: the writer can check a tag but
cannot forge one, and an address is the hash of the key that signs for
it.

The backend is the reference's choice: the `cryptography` wheel when it
imports, else the pure-Python `comm/pure25519.py`.  Ed25519 is
deterministic, so both give the same public keys and signatures for the
same seed, and a port wallet's tag verifies at a reference writer and
back.  Signing and verification charge `crypto.sign_s` /
`crypto.verify_s` (and their counts) to `utils/tracing.PROC`.

Not ported yet: the HMAC `KeyRing`, `AuthenticatedLedger` and its
`sign_*` helpers and the X25519 half of the wallet (`pair_secret`,
`dh_public_bytes`).  They come with TLS and secure aggregation (ROADMAP
A9, A12).
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
from typing import Dict, List, Sequence, Tuple

from bflc_demo_tpu_torch.comm import pure25519 as _pure
from bflc_demo_tpu_torch.utils import tracing

try:                                    # prefer the C-backed implementation
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization as _ser
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey, Ed25519PublicKey)
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


def address_of(public_bytes: bytes) -> str:
    """Self-authenticating address: 0x + the first 20 bytes of
    sha256(pubkey), so an address claim is checkable against the key."""
    return "0x" + hashlib.sha256(public_bytes).hexdigest()[:40]


class Wallet:
    """One client's Ed25519 signing identity, built from a raw 32-byte
    private key so that both backends give the same public key and
    signatures.  `dh_private` is kept for the reference's constructor and
    seed derivation; the X25519 half is not ported yet."""

    def __init__(self, sign_private: bytes, dh_private: bytes):
        if len(sign_private) != 32 or len(dh_private) != 32:
            raise ValueError("wallet private keys must be 32 raw bytes")
        self._sign_sk = bytes(sign_private)
        self._dh_sk = bytes(dh_private)
        if ED25519_BACKEND == "cryptography":
            self._sign = Ed25519PrivateKey.from_private_bytes(self._sign_sk)
            self.public_bytes = self._sign.public_key().public_bytes(
                _ser.Encoding.Raw, _ser.PublicFormat.Raw)
        else:
            self.public_bytes = _pure.ed25519_public(self._sign_sk)
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
