"""Control-plane TLS: confidentiality for every byte between the roles.

Copy of `bflc_demo_tpu/comm/tls.py`.  The reference system's transport is
the FISCO channel protocol, TLS with certificates provisioned by copying
files; `comm/wire`'s Ed25519 tags give integrity and authenticity but not
confidentiality.  This module closes that gap the same way:

- `provision_tls(dir)`: a self-signed CA and a server key and certificate
  signed by it, written as PEMs (ca.pem, server.pem, server.key; the key
  0600).  Existing files are reused.  With the `cryptography` wheel the
  keys are P-256 ECDSA; without it `comm/x509mini.py` writes Ed25519 ones.
- `server_context(dir)` / `client_context(dir)`: `ssl.SSLContext`s for the
  two ends, TLS >= 1.2; the client verifies the server's certificate
  against the CA with `check_hostname` on and `CERT_REQUIRED`.  Client
  authentication stays with the Ed25519 op tags.

`LedgerServer(tls=server_context(...))`, `CoordinatorClient`,
`FailoverClient`, the read fan-out, `Standby(tls_client=, tls_server=)`
and the validator clients take these contexts; a plaintext client
against a TLS server fails the handshake and is closed.  Nothing of the
reference is dropped.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from typing import Tuple

CA_PEM = "ca.pem"
SERVER_PEM = "server.pem"
SERVER_KEY = "server.key"


def provision_tls(cert_dir: str, common_name: str = "127.0.0.1",
                  days: int = 365,
                  include_loopback: bool = True) -> Tuple[str, str, str]:
    """Write (or reuse) ca.pem / server.pem / server.key under cert_dir.

    Returns the three paths.  The server cert carries SANs for the common
    name and (unless include_loopback=False — e.g. provisioning for a real
    remote host) 127.0.0.1/localhost so loopback deployments verify
    cleanly.  Clients enforce the SAN match (client_context keeps
    check_hostname on), so a cert provisioned for one host is useless for
    impersonating another even inside the same CA.

    Without the `cryptography` wheel, generation falls back to the
    pure-Python Ed25519 x509 path (comm.x509mini — same files, same SAN
    policy; OpenSSL >= 1.1.1 negotiates TLS 1.3 with Ed25519 certs), so
    TLS provisioning works everywhere the repo's identity layer does.
    """
    os.makedirs(cert_dir, exist_ok=True)
    ca_path = os.path.join(cert_dir, CA_PEM)
    crt_path = os.path.join(cert_dir, SERVER_PEM)
    key_path = os.path.join(cert_dir, SERVER_KEY)
    if all(os.path.exists(p) for p in (ca_path, crt_path, key_path)):
        return ca_path, crt_path, key_path
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        from bflc_demo_tpu_torch.comm.x509mini import provision_tls_pure
        return provision_tls_pure(cert_dir, common_name=common_name,
                                  days=days,
                                  include_loopback=include_loopback)

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                            "bflc-demo-tpu-ca")])
    ca_cert = (x509.CertificateBuilder()
               .subject_name(ca_name).issuer_name(ca_name)
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(days=days))
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))

    srv_key = ec.generate_private_key(ec.SECP256R1())
    sans = [x509.DNSName(common_name) if not _is_ip(common_name)
            else x509.IPAddress(ipaddress.ip_address(common_name))]
    if include_loopback:
        sans.insert(0, x509.DNSName("localhost"))
        sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    srv_cert = (x509.CertificateBuilder()
                .subject_name(x509.Name([x509.NameAttribute(
                    NameOID.COMMON_NAME, common_name)]))
                .issuer_name(ca_name)
                .public_key(srv_key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=days))
                .add_extension(x509.SubjectAlternativeName(sans),
                               critical=False)
                .sign(ca_key, hashes.SHA256()))

    with open(ca_path, "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    with open(crt_path, "wb") as f:
        f.write(srv_cert.public_bytes(serialization.Encoding.PEM))
    # 0600: the unencrypted server key must not be world-readable — a local
    # reader could impersonate the coordinator
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(srv_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    return ca_path, crt_path, key_path


def _is_ip(name: str) -> bool:
    try:
        ipaddress.ip_address(name)
        return True
    except ValueError:
        return False


def server_context(cert_dir: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(os.path.join(cert_dir, SERVER_PEM),
                        os.path.join(cert_dir, SERVER_KEY))
    return ctx


def client_context(cert_dir: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_verify_locations(os.path.join(cert_dir, CA_PEM))
    # Full server identity: the presented cert must chain to the CA AND
    # carry a SAN matching the address the client dialed (ssl validates IP
    # SANs under check_hostname too — provision_tls always includes the
    # 127.0.0.1 IP SAN plus the deployment's common name).  CA membership
    # alone would let any CA-signed cert impersonate any server.
    ctx.check_hostname = True
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
