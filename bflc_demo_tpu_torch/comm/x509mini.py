"""Minimal pure-Python x509: an Ed25519 CA and server certificate.

Copy of `bflc_demo_tpu/comm/x509mini.py`: just enough DER for what `ssl`
loads when the `cryptography` wheel is absent —

- a self-signed Ed25519 CA certificate (BasicConstraints CA:TRUE,
  critical),
- an Ed25519 server certificate signed by that CA, carrying the
  SubjectAlternativeName entries `comm/tls.client_context` verifies
  (check_hostname stays on, IP SANs included),
- the server's PKCS#8 private key (RFC 5958 / RFC 8410: a fixed 16-byte
  prefix and the raw 32-byte seed).

Certificates are signed by the port's `comm/identity.Wallet` (Ed25519
signs the DER directly), so for the same wallets, serials and clock the
bytes are the reference's.  OpenSSL >= 1.1.1 accepts Ed25519
certificates and negotiates TLS 1.3 with them.  Validity uses UTCTime,
so not_after is capped at 2049.  Nothing is dropped; only the history
notes of the reference's docstring are.
"""

from __future__ import annotations

import base64
import datetime
import ipaddress
import os
from typing import Iterable, List, Tuple

from bflc_demo_tpu_torch.comm.identity import Wallet

_OID_ED25519 = bytes([0x2B, 0x65, 0x70])            # 1.3.101.112
_OID_CN = bytes([0x55, 0x04, 0x03])                 # 2.5.4.3
_OID_BASIC_CONSTRAINTS = bytes([0x55, 0x1D, 0x13])  # 2.5.29.19
_OID_SAN = bytes([0x55, 0x1D, 0x11])                # 2.5.29.17

# UTCTime encodes two-digit years (< 2050); RFC 5280 requires rolling to
# GeneralizedTime beyond that, so not_after is capped instead ('55' would
# parse as 1955)
_UTCTIME_MAX = datetime.datetime(2049, 12, 31, 23, 59, 59,
                                 tzinfo=datetime.timezone.utc)


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + content


def _seq(*parts: bytes) -> bytes:
    return _tlv(0x30, b"".join(parts))


def _set(*parts: bytes) -> bytes:
    return _tlv(0x31, b"".join(parts))


def _int(v: int) -> bytes:
    raw = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw             # positive INTEGERs stay positive
    return _tlv(0x02, raw)


def _oid(der_body: bytes) -> bytes:
    return _tlv(0x06, der_body)


def _octets(b: bytes) -> bytes:
    return _tlv(0x04, b)


def _bitstring(b: bytes) -> bytes:
    return _tlv(0x03, b"\x00" + b)      # zero unused bits


def _bool_true() -> bytes:
    return _tlv(0x01, b"\xff")


def _utf8(s: str) -> bytes:
    return _tlv(0x0C, s.encode())


def _utctime(dt: datetime.datetime) -> bytes:
    return _tlv(0x17, dt.strftime("%y%m%d%H%M%SZ").encode())


def _explicit(n: int, content: bytes) -> bytes:
    return _tlv(0xA0 | n, content)      # [n] EXPLICIT, constructed


def _name(common_name: str) -> bytes:
    return _seq(_set(_seq(_oid(_OID_CN), _utf8(common_name))))


def _algo_ed25519() -> bytes:
    return _seq(_oid(_OID_ED25519))     # RFC 8410: parameters ABSENT


def _spki(public_bytes: bytes) -> bytes:
    return _seq(_algo_ed25519(), _bitstring(public_bytes))


def _extension(oid: bytes, critical: bool, inner_der: bytes) -> bytes:
    parts = [_oid(oid)]
    if critical:
        parts.append(_bool_true())
    parts.append(_octets(inner_der))
    return _seq(*parts)


def _san_extension(names: Iterable[str]) -> bytes:
    """SubjectAlternativeName: dNSName [2] IA5String (implicit,
    primitive) / iPAddress [7] OCTET STRING — the GeneralName choices
    `ssl`'s check_hostname matches against."""
    general: List[bytes] = []
    for n in names:
        try:
            ip = ipaddress.ip_address(n)
            general.append(_tlv(0x87, ip.packed))
        except ValueError:
            general.append(_tlv(0x82, n.encode()))
    return _extension(_OID_SAN, False, _seq(*general))


def _basic_constraints_ca() -> bytes:
    # CA:TRUE, pathLenConstraint 0 — same shape the cryptography-backed
    # provisioner emits
    return _extension(_OID_BASIC_CONSTRAINTS, True,
                      _seq(_bool_true(), _int(0)))


def _certificate(*, subject_cn: str, issuer_cn: str,
                 subject_pub: bytes, issuer_wallet: Wallet,
                 serial: int, days: int,
                 extensions: List[bytes]) -> bytes:
    now = datetime.datetime.now(datetime.timezone.utc)
    not_before = now - datetime.timedelta(minutes=5)
    not_after = min(now + datetime.timedelta(days=days), _UTCTIME_MAX)
    tbs = _seq(
        _explicit(0, _int(2)),          # version v3
        _int(serial),
        _algo_ed25519(),
        _name(issuer_cn),
        _seq(_utctime(not_before), _utctime(not_after)),
        _name(subject_cn),
        _spki(subject_pub),
        _explicit(3, _seq(*extensions)))
    sig = issuer_wallet.sign(tbs)       # Ed25519 signs the DER directly
    return _seq(tbs, _algo_ed25519(), _bitstring(sig))


def _pkcs8_ed25519(sign_private: bytes) -> bytes:
    # RFC 5958 OneAsymmetricKey with RFC 8410 CurvePrivateKey: the inner
    # OCTET STRING wraps the raw 32-byte seed
    return _seq(_int(0), _algo_ed25519(),
                _octets(_octets(sign_private)))


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der)
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n".encode()
            + b"\n".join(lines)
            + f"\n-----END {label}-----\n".encode())


def provision_tls_pure(cert_dir: str, common_name: str = "127.0.0.1",
                       days: int = 365,
                       include_loopback: bool = True,
                       ) -> Tuple[str, str, str]:
    """Pure-Python drop-in for `comm.tls.provision_tls`'s generation
    step: writes ca.pem / server.pem / server.key under cert_dir and
    returns the three paths.  Same SAN policy as the cryptography-backed
    path (the deployment's common name, plus localhost/127.0.0.1 unless
    include_loopback=False), same 0600 key permissions."""
    os.makedirs(cert_dir, exist_ok=True)
    ca_path = os.path.join(cert_dir, "ca.pem")
    crt_path = os.path.join(cert_dir, "server.pem")
    key_path = os.path.join(cert_dir, "server.key")

    ca_wallet = Wallet.generate()
    srv_wallet = Wallet.generate()
    ca_cert = _certificate(
        subject_cn="bflc-demo-tpu-ca", issuer_cn="bflc-demo-tpu-ca",
        subject_pub=ca_wallet.public_bytes, issuer_wallet=ca_wallet,
        serial=int.from_bytes(os.urandom(16), "big") >> 1, days=days,
        extensions=[_basic_constraints_ca()])
    sans = []
    if include_loopback:
        sans.append("localhost")
    sans.append(common_name)
    if include_loopback and common_name != "127.0.0.1":
        sans.append("127.0.0.1")
    srv_cert = _certificate(
        subject_cn=common_name, issuer_cn="bflc-demo-tpu-ca",
        subject_pub=srv_wallet.public_bytes, issuer_wallet=ca_wallet,
        serial=int.from_bytes(os.urandom(16), "big") >> 1, days=days,
        extensions=[_san_extension(sans)])

    with open(ca_path, "wb") as f:
        f.write(_pem("CERTIFICATE", ca_cert))
    with open(crt_path, "wb") as f:
        f.write(_pem("CERTIFICATE", srv_cert))
    # 0600: the unencrypted server key must not be world-readable
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(_pem("PRIVATE KEY",
                     _pkcs8_ed25519(srv_wallet._sign_sk)))
    return ca_path, crt_path, key_path
