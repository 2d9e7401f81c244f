"""The port's socket ledger against the reference's, both directions.

- A scripted, signed federation (the scripts of the reference's
  tests/test_netledger.py full-round and socket-differential cases, with
  `require_auth=True`: two rounds of signed registers, uploads and
  scores, with a forged upload and a replayed one in between) drives the
  port's `LedgerServer` and the reference's (in a thread, python
  ledger) with the same signed ops — once through the reference's
  `CoordinatorClient` and wallets, once through the port's.  Every reply
  status, the log head, the log size and each committed model blob are
  equal byte for byte.
- Replicas across packages: the port's `replicate` follows the
  reference's writer, and the reference's `replicate` (its ledger's
  `apply_op`) follows the port's, each to the writer's head.
- The reference's server cases against the port's server: a blob/hash
  mismatch, structurally wrong deltas, the blocking `wait`, an unknown
  method, the signed round trip with its forgeries, the gas meter (an
  exhausted budget, blob bytes charged, a spoofed address that cannot
  drain its victim) and the in-thread replica.
All on the CPU; the port's merge engine runs on the CPU here.
"""

import hashlib
import struct
import threading
import time

import numpy as np
import pytest

from bflc_demo_tpu.comm import identity as ref_id
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm import identity, ledger_service
from bflc_demo_tpu_torch.comm.wire import blob_bytes
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import (pack_entries,
                                                     unpack_pytree)

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)


def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _delta(w: float) -> bytes:
    return pack_entries({"['W']": np.full((5, 2), w, np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _port_server(**kw):
    kw.setdefault("require_auth", False)
    srv = ledger_service.LedgerServer(CFG, _init_blob(),
                                      stall_timeout_s=60.0, device="cpu",
                                      **kw)
    srv.start()
    return srv


def _ref_server(**kw):
    srv = ref_ls.LedgerServer(RefConfig(**PROTO), _init_blob(),
                              stall_timeout_s=60.0, ledger_backend="python",
                              **kw)
    srv.start()
    return srv


SIDES = {"port": (identity, ledger_service.CoordinatorClient),
         "reference": (ref_id, ref_ls.CoordinatorClient)}


def _script(srv, side: str):
    """The signed two-round script against `srv` through `side`'s client
    and wallets: (every reply's ok/status, committed model blobs, final
    info)."""
    ident, client_cls = SIDES[side]
    wallets, _ = ident.provision_wallets(PROTO["client_num"],
                                         b"net-master-000001")

    def sign(w, kind, epoch, payload):
        return w.sign(ident._op_bytes(kind, w.address, epoch,
                                      payload)).hex()

    c = client_cls(srv.host, srv.port)
    seen, models = [], []

    def req(method, **kw):
        r = c.request(method, **kw)
        seen.append((method, r.get("ok"), r.get("status")))
        return r

    for w in wallets:
        req("register", addr=w.address, pubkey=w.public_bytes.hex(),
            tag=sign(w, "register", 0, b""))
    intruder = ident.Wallet.from_seed(b"intruder")
    req("register", addr=wallets[0].address,
        pubkey=intruder.public_bytes.hex(),
        tag=sign(intruder, "register", 0, b""))
    for epoch in range(2):
        committee = req("committee")["committee"]
        trainers = [w for w in wallets if w.address not in committee]
        by_addr = {w.address: w for w in wallets}
        for i, w in enumerate(trainers[:3]):
            blob = _delta(float(i + 1 + epoch))
            digest = hashlib.sha256(blob).digest()
            n, cost = 100 + i + 10 * epoch, 1.0 - 0.25 * epoch
            payload = digest + struct.pack("<qd", n, cost)
            if i == 0:
                # another wallet signing for this trainer: refused
                req("upload", addr=w.address, blob=blob, hash=digest.hex(),
                    n=n, cost=cost, epoch=epoch,
                    tag=sign(trainers[1], "upload", epoch, payload))
            req("upload", addr=w.address, blob=blob.hex(), hash=digest.hex(),
                n=n, cost=cost, epoch=epoch,
                tag=sign(w, "upload", epoch, payload))
            if i == 0:
                # the verbatim replay: DUPLICATE at the auth layer
                req("upload", addr=w.address, blob=blob, hash=digest.hex(),
                    n=n, cost=cost, epoch=epoch,
                    tag=sign(w, "upload", epoch, payload))
        ups = req("updates")["updates"]
        got = blob_bytes(req("blob", hash=ups[0]["hash"])["blob"])
        assert hashlib.sha256(got).hexdigest() == ups[0]["hash"]
        for j, addr in enumerate(committee):
            scores = ([0.9, 0.5, 0.1] if j == 0 else [0.8, 0.6, 0.2]) \
                if epoch == 0 else [0.9 - j * 0.1, 0.5, 0.3]
            req("scores", addr=addr, epoch=epoch, scores=scores,
                tag=sign(by_addr[addr], "scores", epoch,
                         struct.pack(f"<{len(scores)}d", *scores)))
        mr = req("model")
        assert mr["epoch"] == epoch + 1
        models.append(blob_bytes(mr["blob"]))
    info = c.request("info")
    c.close()
    return seen, models, info


@pytest.mark.parametrize("side", list(SIDES))
def test_scripted_servers_agree_byte_for_byte(side):
    port_srv, ref_srv = _port_server(require_auth=True), \
        _ref_server(require_auth=True)
    try:
        got = _script(port_srv, side)
        want = _script(ref_srv, side)
    finally:
        port_srv.close()
        ref_srv.close()
    assert got[0] == want[0]                     # every reply's status
    assert got[1] == want[1]                     # committed model blobs
    for key in ("epoch", "log_size", "log_head", "num_registered",
                "last_global_loss", "rounds_completed", "committee"):
        assert got[2][key] == want[2][key], key
    assert got[2]["epoch"] == 2
    # round 0 merged trainers 0 and 1 (equal weights 100/101): the
    # model moved by -lr times their weighted mean delta
    flat = unpack_pytree(got[1][0])
    np.testing.assert_allclose(flat["['W']"], -0.05 * (100 + 2 * 101) / 201,
                               rtol=1e-6)


def test_replicas_follow_across_packages():
    port_srv, ref_srv = _port_server(require_auth=True), \
        _ref_server(require_auth=True)
    try:
        # two signed rounds on each writer: register, upload, scores and
        # commit ops in the streams
        info = _script(ref_srv, "reference")[2]
        info2 = _script(port_srv, "port")[2]
        # the port's replica follows the reference's writer ...
        rep = ledger_service.replicate(ref_srv.host, ref_srv.port, CFG,
                                       until_ops=info["log_size"],
                                       timeout_s=30.0)
        assert rep.log_head().hex() == info["log_head"]
        assert rep.epoch == 2
        # ... and the reference's replica (its ledger's apply_op) the port's
        ref_rep = ref_ls.replicate(port_srv.host, port_srv.port,
                                   RefConfig(**PROTO),
                                   ledger_backend="python",
                                   until_ops=info2["log_size"],
                                   timeout_s=30.0)
        assert ref_rep.log_head().hex() == info2["log_head"] \
            == info["log_head"]
        assert ref_rep.num_registered == PROTO["client_num"]
    finally:
        port_srv.close()
        ref_srv.close()


@pytest.fixture
def server():
    srv = _port_server()
    yield srv
    srv.close()


def _client(srv):
    return ledger_service.CoordinatorClient(srv.host, srv.port,
                                            timeout_s=10.0)


def _register_all(c, n=PROTO["client_num"]):
    addrs = [f"0x{i:040x}" for i in range(n)]
    for a in addrs:
        assert c.request("register", addr=a)["ok"]
    return addrs


def test_wrong_hash_and_bad_deltas_rejected(server):
    c = _client(server)
    _register_all(c)
    blob = _delta(1.0)
    r = c.request("upload", addr="0x" + "0" * 40, blob=blob,
                  hash="00" * 32, n=1, cost=0.0, epoch=0)
    assert not r["ok"] and r["status"] == "BAD_ARG"
    for bad in ({"['W']": np.ones((5, 2), np.float32)},
                {"['W']": np.ones((5, 3), np.float32),
                 "['b']": np.zeros((2,), np.float32)},
                {"['W']": np.ones((5, 2), np.float32),
                 "['b']": np.zeros((2,), np.float32),
                 "['c']": np.zeros((1,), np.float32)},
                {"['W']": np.full((5, 2), "x"),
                 "['b']": np.zeros((2,), np.float32)},
                {"['W']": np.ones((5, 2), np.float16),      # a codec layout
                 "['b']": np.zeros((2,), np.float32)}):
        blob = pack_entries(bad)
        digest = hashlib.sha256(blob).digest()
        r = c.request("upload", addr="0x" + "0" * 40, blob=blob,
                      hash=digest.hex(), n=1, cost=0.0, epoch=0)
        assert not r["ok"] and r["status"] == "BAD_ARG", r
    assert c.request("info")["update_count"] == 0
    assert not c.request("frobnicate")["ok"]
    r = c.request("aupload")
    assert not r["ok"] and "A9" in r["error"]
    c.close()


def test_wait_blocks_until_log_grows(server):
    c = _client(server)
    base = c.request("info")["log_size"]
    t0 = time.monotonic()

    def later():
        time.sleep(0.3)
        c2 = _client(server)
        c2.request("register", addr="0x" + "1" * 40)
        c2.close()

    threading.Thread(target=later, daemon=True).start()
    r = c.request("wait", log_size=base, timeout_s=10.0)
    assert r["log_size"] == base + 1
    assert time.monotonic() - t0 >= 0.25
    c.close()


def test_in_thread_replica_head_equality(server):
    c = _client(server)
    _register_all(c)
    size = c.request("info")["log_size"]
    replica = ledger_service.replicate(server.host, server.port, CFG,
                                       until_ops=size, timeout_s=30.0)
    assert replica.log_head().hex() == c.request("info")["log_head"]
    assert replica.num_registered == PROTO["client_num"]
    c.close()


def test_gas_budget_exhaustion_rejects_storage_ops():
    srv = _port_server(gas_budget_per_epoch=2_500)
    c = _client(srv)
    try:
        assert 2 * ledger_service.GAS_REGISTER <= 2_500 \
            < 3 * ledger_service.GAS_REGISTER
        addr = "0x" + "ab" * 20
        assert c.request("register", addr=addr)["ok"]
        assert c.request("register", addr=addr)["status"] == \
            "ALREADY_REGISTERED"                      # still costs gas
        r3 = c.request("register", addr=addr)
        assert r3["status"] == "OUT_OF_GAS" and not r3["ok"]
        assert c.request("info")["ok"]                # queries are free
        assert c.request("register", addr="0x" + "cd" * 20)["ok"]
    finally:
        c.close()
        srv.close()


def test_upload_gas_scales_with_blob_bytes():
    srv = _port_server(gas_budget_per_epoch=10_000)
    c = _client(srv)
    try:
        addrs = _register_all(c)
        committee = set(c.request("committee")["committee"])
        trainers = [a for a in addrs if a not in committee]
        big = bytes(64 * 1024)
        r = c.request("upload", addr=trainers[0], blob=big,
                      hash=hashlib.sha256(big).hexdigest(), n=10, cost=1.0,
                      epoch=0)
        assert r["status"] == "OUT_OF_GAS"
        assert srv.ledger.update_count == 0
        blob = _delta(1.0)
        r2 = c.request("upload", addr=trainers[1], blob=blob,
                       hash=hashlib.sha256(blob).hexdigest(), n=10,
                       cost=1.0, epoch=0)
        assert r2["ok"], r2
    finally:
        c.close()
        srv.close()


def test_spoofed_address_cannot_drain_victim_budget():
    (victim, attacker), directory = identity.provision_wallets(
        2, b"gas-auth-master-01")
    srv = _port_server(require_auth=True, directory=directory,
                       gas_budget_per_epoch=1_500)
    c = _client(srv)
    try:
        for _ in range(5):
            r = c.request("register", addr=victim.address,
                          pubkey=victim.public_bytes.hex(),
                          tag=attacker.sign(identity._op_bytes(
                              "register", victim.address, 0, b"")).hex())
            assert not r["ok"] and r["status"] == "BAD_ARG"
        r = c.request("register", addr=victim.address,
                      pubkey=victim.public_bytes.hex(),
                      tag=victim.sign(identity._op_bytes(
                          "register", victim.address, 0, b"")).hex())
        assert r["ok"], r
        # closed enrollment: an unknown identity is refused
        stranger = identity.Wallet.from_seed(b"stranger")
        r = c.request("register", addr=stranger.address,
                      pubkey=stranger.public_bytes.hex(),
                      tag=stranger.sign(identity._op_bytes(
                          "register", stranger.address, 0, b"")).hex())
        assert not r["ok"] and r["error"] == "unknown identity"
    finally:
        c.close()
        srv.close()


def test_unported_server_options_raise_naming_the_item():
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9 \(hier"):
        ledger_service.LedgerServer(CFG, _init_blob(), device="cpu",
                                    cell_registry={"0x": (1, 1)})
    # TLS and the snapshot options are ported (A9.4, A9.5)
    for kw in (dict(snapshot_dir="d"), dict(tls=object()),
               dict(snapshot_interval=2)):
        ledger_service.LedgerServer(CFG, _init_blob(), device="cpu",
                                    **kw).close()
    with pytest.raises(TypeError):
        ledger_service.LedgerServer(CFG, _init_blob(), device="cpu",
                                    frobnicate=1)
    # the reference's defaults of those options are accepted
    srv = ledger_service.LedgerServer(CFG, _init_blob(), device="cpu",
                                      quorum=0, wal_path="", tls=None)
    srv.close()
