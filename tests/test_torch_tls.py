"""The port's control-plane TLS against the reference's (A9.4).

- x509mini: for fixed wallets, serials and a frozen clock the port's DER
  is the reference's byte for byte, and `provision_tls_pure` writes the
  reference's files byte for byte when `os.urandom` is pinned.
- Certificates provisioned by either package (the `cryptography` P-256
  path, and the pure Ed25519 path forced by making the wheel's import
  fail) load in the other package's `server_context` and
  `client_context` and complete a handshake.
- The whole protocol runs over TLS between a port writer and port
  clients, a reference writer and port clients, and a port writer and a
  reference client, and a replica of each package follows over TLS.
- A plaintext client, a client trusting another CA and a certificate for
  another host are each refused by the port's writer.
- C10: a reply sent after `LedgerServer.close()` on a TLS connection
  arrives decrypted and whole (`close` shuts the raw socket's read side;
  `SSLSocket.shutdown` would drop the TLS session first).
- A `--runtime processes --device cpu` fleet runs over TLS.
All on the CPU.
"""

import datetime
import hashlib
import itertools
import os
import socket
import ssl
import sys
import threading
import time
import types

import numpy as np
import pytest

from bflc_demo_tpu.comm import identity as ref_id
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.comm import tls as ref_tls
from bflc_demo_tpu.comm import x509mini as ref_x509
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.comm import identity, ledger_service
from bflc_demo_tpu_torch.comm import tls as port_tls
from bflc_demo_tpu_torch.comm import x509mini as port_x509
from bflc_demo_tpu_torch.comm.wire import WireError, recv_msg, send_msg
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_entries

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)
ADDRS = [f"0x{i:040x}" for i in range(PROTO["client_num"])]
FIXED_NOW = datetime.datetime(2026, 3, 4, 5, 6, 7,
                              tzinfo=datetime.timezone.utc)


def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _delta(w: float) -> bytes:
    return pack_entries({"['W']": np.full((5, 2), w, np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _freeze_clock(monkeypatch):
    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return FIXED_NOW

    shim = types.SimpleNamespace(datetime=Frozen,
                                 timedelta=datetime.timedelta,
                                 timezone=datetime.timezone)
    for mod in (port_x509, ref_x509):
        monkeypatch.setattr(mod, "datetime", shim)


def _pin_urandom(monkeypatch):
    """os.urandom as a counter stream: each package's provisioning draws
    the same bytes when the counter is reset."""
    state = {"n": 0}

    def urandom(k):
        out = hashlib.sha256(b"pinned|%d" % state["n"]).digest()
        state["n"] += 1
        return (out * (k // 32 + 1))[:k]

    monkeypatch.setattr(os, "urandom", urandom)
    return state


def _force_pure(monkeypatch):
    """Make the `cryptography` wheel's import fail for the provisioner."""
    monkeypatch.setitem(sys.modules, "cryptography", None)


# ------------------------------------------------------------- x509mini
def test_x509mini_der_equals_the_references(monkeypatch):
    _freeze_clock(monkeypatch)
    ders = []
    for x509, ident in ((port_x509, identity), (ref_x509, ref_id)):
        ca = ident.Wallet.from_seed(b"x509-ca")
        srv = ident.Wallet.from_seed(b"x509-server")
        ca_der = x509._certificate(
            subject_cn="bflc-demo-tpu-ca", issuer_cn="bflc-demo-tpu-ca",
            subject_pub=ca.public_bytes, issuer_wallet=ca,
            serial=0x1234_5678_9ABC, days=365,
            extensions=[x509._basic_constraints_ca()])
        srv_der = x509._certificate(
            subject_cn="127.0.0.1", issuer_cn="bflc-demo-tpu-ca",
            subject_pub=srv.public_bytes, issuer_wallet=ca,
            serial=(1 << 126) + 7, days=30000,    # capped at 2049
            extensions=[x509._san_extension(
                ["localhost", "127.0.0.1", "db.example", "::1"])])
        ders.append((ca_der, srv_der,
                     x509._pkcs8_ed25519(srv._sign_sk),
                     x509._pem("CERTIFICATE", srv_der)))
    assert ders[0] == ders[1]


@pytest.mark.parametrize("kw", [dict(),
                                dict(common_name="db.internal.example",
                                     include_loopback=False)])
def test_pure_provisioning_writes_the_references_files(monkeypatch,
                                                       tmp_path, kw):
    _freeze_clock(monkeypatch)
    state = _pin_urandom(monkeypatch)
    files = []
    for name, fn in (("port", port_x509.provision_tls_pure),
                     ("ref", ref_x509.provision_tls_pure)):
        state["n"] = 0
        paths = fn(str(tmp_path / name), **kw)
        files.append([open(p, "rb").read() for p in paths])
        assert oct(os.stat(paths[2]).st_mode & 0o777) == "0o600"
    assert files[0] == files[1]


def test_provision_idempotent_and_pure_path_forced(monkeypatch, tmp_path):
    paths = port_tls.provision_tls(str(tmp_path / "a"))
    mtimes = [os.path.getmtime(p) for p in paths]
    assert port_tls.provision_tls(str(tmp_path / "a")) == paths
    assert [os.path.getmtime(p) for p in paths] == mtimes
    assert b"BEGIN PRIVATE KEY" in open(paths[2], "rb").read()
    _force_pure(monkeypatch)
    with pytest.raises(ImportError):
        import cryptography  # noqa: F401
    pure = port_tls.provision_tls(str(tmp_path / "b"))
    # the Ed25519 key's fixed PKCS#8 prefix: the x509mini path ran
    key_der = port_x509._pkcs8_ed25519(b"\0" * 32)[:16]
    import base64
    body = b"".join(open(pure[2], "rb").read().splitlines()[1:-1])
    assert base64.b64decode(body)[:16] == key_der


# --------------------------------------------- contexts across packages
def _handshake(server_ctx, client_ctx, host="127.0.0.1"):
    """One TLS handshake through a port LedgerServer; returns the
    negotiated protocol version."""
    srv = ledger_service.LedgerServer(CFG, _init_blob(), require_auth=False,
                                      stall_timeout_s=60.0, device="cpu",
                                      tls=server_ctx)
    srv.start()
    try:
        c = ledger_service.CoordinatorClient(host, srv.port, tls=client_ctx)
        try:
            assert c.request("info")["ok"]
            return c.sock.version()
        finally:
            c.close()
    finally:
        srv.close()


TLS_PACKAGES = {"port": port_tls, "reference": ref_tls}


@pytest.mark.parametrize("provisioner,contexts,pure", list(itertools.product(
    TLS_PACKAGES, TLS_PACKAGES, (False, True))))
def test_certificates_load_in_either_packages_contexts(monkeypatch, tmp_path,
                                                       provisioner, contexts,
                                                       pure):
    if pure:
        _force_pure(monkeypatch)
    d = str(tmp_path / "certs")
    TLS_PACKAGES[provisioner].provision_tls(d)
    monkeypatch.undo()
    ctx = TLS_PACKAGES[contexts]
    sctx, cctx = ctx.server_context(d), ctx.client_context(d)
    assert cctx.check_hostname and cctx.verify_mode == ssl.CERT_REQUIRED
    assert cctx.minimum_version == ssl.TLSVersion.TLSv1_2
    assert sctx.minimum_version == ssl.TLSVersion.TLSv1_2
    version = _handshake(sctx, cctx)
    assert version in ("TLSv1.2", "TLSv1.3")
    if pure:
        assert version == "TLSv1.3"     # Ed25519 certificates


# ------------------------------------------------ the protocol over TLS
@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tls"))
    port_tls.provision_tls(d)
    return d


def _round_over(c):
    """Register the fleet and drive one round to its commit through
    client `c`; the final info."""
    for a in ADDRS:
        assert c.request("register", addr=a)["ok"]
    committee = c.request("committee")["committee"]
    trainers = [a for a in ADDRS if a not in committee]
    for i, a in enumerate(trainers[: PROTO["needed_update_count"]]):
        blob = _delta(i + 1.0)
        r = c.request("upload", addr=a, blob=blob.hex(),
                      hash=hashlib.sha256(blob).hexdigest(), n=10,
                      cost=1.0, epoch=0)
        assert r["ok"], r
    for a in committee:
        r = c.request("scores", addr=a, epoch=0, scores=[0.5, 0.51, 0.52])
        assert r["ok"], r
    return c.request("info")


def _server(side, certs):
    if side == "port":
        srv = ledger_service.LedgerServer(
            CFG, _init_blob(), require_auth=False, stall_timeout_s=60.0,
            device="cpu", tls=port_tls.server_context(certs))
    else:
        srv = ref_ls.LedgerServer(
            RefConfig(**PROTO), _init_blob(), require_auth=False,
            stall_timeout_s=60.0, ledger_backend="python",
            tls=ref_tls.server_context(certs))
    srv.start()
    return srv


@pytest.mark.parametrize("writer,client", [("port", "port"),
                                           ("reference", "port"),
                                           ("port", "reference")])
def test_whole_protocol_over_tls_across_packages(certs, writer, client):
    srv = _server(writer, certs)
    try:
        if client == "port":
            c = ledger_service.CoordinatorClient(
                srv.host, srv.port, tls=port_tls.client_context(certs))
        else:
            c = ref_ls.CoordinatorClient(srv.host, srv.port,
                                         tls=ref_tls.client_context(certs))
        try:
            assert isinstance(c.sock, ssl.SSLSocket)
            info = _round_over(c)
        finally:
            c.close()
        assert info["epoch"] == 1           # merged and committed
        # a replica of each package follows over the same TLS transport
        rep = ledger_service.replicate(
            srv.host, srv.port, CFG, until_ops=info["log_size"],
            timeout_s=30.0, tls=port_tls.client_context(certs))
        ref_rep = ref_ls.replicate(
            srv.host, srv.port, RefConfig(**PROTO), ledger_backend="python",
            until_ops=info["log_size"], timeout_s=30.0,
            tls=ref_tls.client_context(certs))
        assert rep.log_head().hex() == ref_rep.log_head().hex() \
            == info["log_head"]
    finally:
        srv.close()


# ------------------------------------------------------------ refusals
def _refused_plaintext(srv):
    sock = socket.create_connection((srv.host, srv.port), timeout=5.0)
    sock.settimeout(5.0)
    try:
        send_msg(sock, {"method": "info"})
        with pytest.raises((WireError, ConnectionError, OSError)):
            if recv_msg(sock) is None:          # a clean close refuses too
                raise ConnectionError("closed by the server")
    finally:
        sock.close()


def _refused_wrong_ca(srv, tmp_path):
    other = str(tmp_path / "other-ca")
    port_tls.provision_tls(other)
    with pytest.raises(ssl.SSLError):
        ledger_service.CoordinatorClient(
            srv.host, srv.port, tls=port_tls.client_context(other))


def _refused_wrong_host(_srv, tmp_path):
    d = str(tmp_path / "other-host")
    port_tls.provision_tls(d, common_name="db.internal.example",
                           include_loopback=False)
    other = ledger_service.LedgerServer(
        CFG, _init_blob(), require_auth=False, stall_timeout_s=60.0,
        device="cpu", tls=port_tls.server_context(d))
    other.start()
    try:
        with pytest.raises(ssl.SSLCertVerificationError):
            ledger_service.CoordinatorClient(
                other.host, other.port, tls=port_tls.client_context(d))
    finally:
        other.close()


@pytest.mark.parametrize("case", [_refused_plaintext, _refused_wrong_ca,
                                  _refused_wrong_host],
                         ids=["plaintext", "wrong_ca", "wrong_hostname"])
def test_port_writer_refuses(certs, tmp_path, case):
    srv = _server("port", certs)
    try:
        if case is _refused_plaintext:
            case(srv)
        else:
            case(srv, tmp_path)
        # the accept loop was never wedged: a TLS client still gets in
        c = ledger_service.CoordinatorClient(
            srv.host, srv.port, tls=port_tls.client_context(certs))
        assert c.request("info")["ok"]
        c.close()
    finally:
        srv.close()


def test_c10_reply_after_close_arrives_encrypted_and_whole(certs):
    """C10: `close()` shuts the read side of open connections so that
    replies in flight still go out (C9).  On a TLS connection that must
    leave the session up: the `wait` reply sent after close() decrypts
    and parses on the client, and nothing went out in the clear."""
    srv = _server("port", certs)
    c = ledger_service.CoordinatorClient(srv.host, srv.port,
                                         tls=port_tls.client_context(certs))
    try:
        size = c.request("info")["log_size"]
        got = {}

        def waiter():
            try:
                got["reply"] = c.request("wait", log_size=size,
                                         timeout_s=5.0)
            except Exception as e:      # noqa: BLE001 — the failure
                got["error"] = e

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.5)                 # the request is in the writer
        t0 = time.monotonic()
        srv.close()
        t.join(timeout=10)
        assert "error" not in got, got.get("error")
        reply = got["reply"]
        assert reply["ok"] and reply["log_size"] == size
        assert time.monotonic() - t0 < 4.0      # woken by close, no timeout
        assert c.sock.version() is not None     # the session is still up
    finally:
        c.close()


# ------------------------------------------------------- the fleet
def test_process_fleet_over_tls_on_cpu(tmp_path):
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:1500], ytr[:1500], PROTO["client_num"])
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, (xte[:500], yte[:500]), CFG,
        rounds=3, stall_timeout_s=20.0, timeout_s=300.0, replicas=1,
        tls_dir=str(tmp_path / "certs"), device="cpu")
    assert res.rounds_completed >= 3
    assert res.best_accuracy() > 0.80, res.accuracy_history
    assert res.replica_report["ok"]
    assert res.replica_report["head"] == res.ledger_log_head
    assert res.plaintext_refused is True
    assert sorted(os.listdir(tmp_path / "certs")) == ["ca.pem", "server.key",
                                                      "server.pem"]


def test_cli_tls_flags_apply_only_to_processes(tmp_path, capsys):
    for argv in (["--runtime", "mesh", "--tls-dir", str(tmp_path)],
                 ["--runtime", "host", "--snapshot-interval", "2"],
                 ["--runtime", "processes", "--snapshot-interval", "-1"],
                 ["--runtime", "processes", "--snapshot-dir", "s"]):
        assert cli(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "apply only to --runtime processes" in err
    assert "--snapshot-dir needs --snapshot-interval" in err
