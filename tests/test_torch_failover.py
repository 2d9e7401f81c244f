"""Writer failover, quorum-ack and the read fan-out of the port's process
fleet, against the reference.

- Promotion evidence: for one wallet seed and one chain the two
  packages' evidence dicts are equal (Ed25519 is deterministic), each
  verifies the other's, tampering is rejected, a bare fence does not
  demote a writer and evidence signed by a key that is not provisioned
  is refused at the socket; a client's fence moves only on evidence.
- The reference's in-thread tests (tests/test_failover.py,
  tests/test_dataplane.py) with the port's classes: promotion over the
  same chain (its WAL holding the whole chain), two standbys in priority
  order, the lower one re-following the winner, the client's rotation,
  the split-brain drill through a killable proxy, quorum-ack (six
  cases), the read fan-out server and the read set a standby advertises.
- Mixed fleets: port standbys (quorum 1, so the reference writer counts
  their acks only if their handshake is the reference's byte for byte)
  follow a reference writer and promote when it dies, and a reference
  client finishes the next round on them; a reference standby follows
  the port's writer and promotes, and a port client finishes the round.
- The committed model bytes across a failover: one signed script with
  the writer closed before the scores commits on the promoted writer
  the blob the unfailed port writer and the reference writer commit,
  every merge on the engine's mesh leg (`BFLC_MESH_AGG_MIN=1`, B5's plain
  version on the CPU).
- The process drill of the reference (its `slow` TestProcessFailoverDrill
  geometry) on the CPU: 6 clients, the primary SIGKILLed at epoch 2 of
  4, the standby promotes and a replica reaches the promoted writer's
  head, with `timeout_s` so a hang fails.
- The standby's TLS and snapshot options (ported), the fleet's refusals
  of what is still unported (chaos, telemetry) and the CLI's quorum check.
Every wait is bounded; no assertion depends on a sub-second race.
"""

import contextlib
import hashlib
import socket as _socket
import struct
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bflc_demo_tpu.comm import failover as ref_fo
from bflc_demo_tpu.comm import identity as ref_id
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.comm.dataplane import ReadFanoutServer, ReadRouter
from bflc_demo_tpu_torch.comm.failover import (FailoverClient, Standby,
                                             WriterDead)
from bflc_demo_tpu_torch.comm.identity import (Wallet, _op_bytes,
                                               provision_wallets)
from bflc_demo_tpu_torch.comm.ledger_service import (
    CoordinatorClient, LedgerServer, make_promotion_evidence,
    verify_promotion_evidence, verify_promotion_signature)
from bflc_demo_tpu_torch.comm.wire import (WireError, blob_bytes, recv_msg,
                                           send_msg)
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.ledger.base import OP_UPLOAD, decode_op
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_entries

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)
REF_CFG = RefConfig(**PROTO)


@pytest.fixture(autouse=True)
def _quiet_keyless_warnings():
    """The reference's own tests build keyless clients and wallet-less
    standbys (each warns by design); the warning tests catch their own."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _delta_blob(v):
    return pack_entries({"['W']": np.full((5, 2), v, np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


def _server(**kw):
    kw.setdefault("stall_timeout_s", 60.0)
    srv = LedgerServer(CFG, kw.pop("init", _init_blob()),
                       ledger_backend="python", device="cpu", **kw)
    srv.start()
    return srv


def _standby(eps, index, **kw):
    sb = Standby(CFG, list(eps), index, heartbeat_s=0.3,
                 stall_timeout_s=60.0, ledger_backend="python",
                 device="cpu", **kw)
    sb.endpoints[index] = (sb.host, sb.port)
    return sb


def _run(sb):
    threading.Thread(target=sb.run, daemon=True).start()
    return sb


def _until(cond, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.05)


def _register_all(client, wallets):
    for w in wallets:
        r = client.request("register", addr=w.address,
                           pubkey=w.public_bytes.hex(),
                           tag=_sign(w, "register", 0, b""))
        assert r["ok"], r


def _uploads(client, wallets, epoch, blob_of=None):
    committee = set(client.request("committee")["committee"])
    trainers = [w for w in wallets if w.address not in committee]
    for i, w in enumerate(trainers[: CFG.needed_update_count]):
        blob = (blob_of or (lambda i: _delta_blob(
            float(i + 1) * 0.1 + epoch)))(i)
        digest = hashlib.sha256(blob).digest()
        payload = digest + struct.pack("<qd", 10 + i, 1.0)
        r = client.request("upload", addr=w.address, blob=blob.hex(),
                           hash=digest.hex(), n=10 + i, cost=1.0,
                           epoch=epoch,
                           tag=_sign(w, "upload", epoch, payload))
        assert r["ok"] or r["status"] == "DUPLICATE", r
    return committee


def _scores(client, wallets, epoch, committee):
    n_up = CFG.needed_update_count
    for j, w in enumerate([w for w in wallets if w.address in committee]):
        scores = [0.5 + 0.01 * (j + u) for u in range(n_up)]
        payload = struct.pack(f"<{n_up}d", *scores)
        r = client.request("scores", addr=w.address, epoch=epoch,
                           scores=scores,
                           tag=_sign(w, "scores", epoch, payload))
        assert r["ok"] or r["status"] in ("DUPLICATE", "WRONG_EPOCH"), r


def _drive_round(client, wallets, epoch):
    """One full round through signed requests: uploads by the first
    `needed_update_count` non-committee wallets, then the committee's
    scores (the merge and commit)."""
    _scores(client, wallets, epoch, _uploads(client, wallets, epoch))


def _chain_head(ops):
    h = b""
    for op in ops:
        hh = hashlib.sha256()
        if h:
            hh.update(h)
        hh.update(bytes.fromhex(op))
        h = hh.digest()
    return h.hex()


# ------------------------------------------------------------- evidence
def _chains():
    """A writer ledger with a few ops and a replica of it, in each
    package."""
    out = {}
    for side, mk, cfg in (("port", make_ledger, CFG),
                          ("reference", lambda c: ref_make_ledger(
                              c, backend="python"), REF_CFG)):
        writer, standby = mk(cfg), mk(cfg)
        for i in range(CFG.client_num):
            writer.register_node(f"0x{i:040x}")
        for i in range(writer.log_size()):
            assert standby.apply_op(writer.log_op(i)) == 0
        out[side] = (writer, standby)
    return out


def test_evidence_dicts_equal_the_references():
    chains = _chains()
    evs = {}
    for side, (_, standby) in chains.items():
        assert standby.promote_writer(1, 1) == 0
        mod = ref_ls if side == "reference" else None
        wallet = (ref_id.Wallet if mod else Wallet).from_seed(b"sb-ev-seed")
        evs[side] = (mod.make_promotion_evidence if mod
                     else make_promotion_evidence)(standby, wallet, 1)
    assert evs["port"] == evs["reference"]
    assert evs["port"]["ix"] == CFG.client_num


@pytest.mark.parametrize("signer", ["port", "reference"])
def test_each_package_verifies_the_others_evidence(signer):
    chains = _chains()
    _, standby = chains[signer]
    assert standby.promote_writer(1, 1) == 0
    if signer == "port":
        w = Wallet.from_seed(b"sb-x")
        ev = make_promotion_evidence(standby, w, 1)
        verifier, writer = ref_ls, chains["reference"][0]
    else:
        w = ref_id.Wallet.from_seed(b"sb-x")
        ev = ref_ls.make_promotion_evidence(standby, w, 1)
        verifier = None
        writer = chains["port"][0]
    keys = {1: w.public_bytes}
    if verifier is None:
        assert verify_promotion_evidence(ev, writer, keys)
        assert verify_promotion_signature(ev, keys)
    else:
        assert verifier.verify_promotion_evidence(ev, writer, keys)
        assert verifier.verify_promotion_signature(ev, keys)


def test_evidence_verifies_and_rejects_tampering():
    writer, standby = _chains()["port"]
    w = Wallet.from_seed(b"standby-ev-1")
    keys = {1: w.public_bytes}
    assert standby.promote_writer(1, 1) == 0
    ev = make_promotion_evidence(standby, w, 1)
    assert verify_promotion_evidence(ev, writer, keys)
    # a divergent suffix on the writer keeps the prefix binding
    writer.close_round()
    assert verify_promotion_evidence(ev, writer, keys)
    assert not verify_promotion_evidence(dict(ev, sig="00" * 64), writer,
                                         keys)
    assert not verify_promotion_evidence(dict(ev, gen=0), writer, keys)
    assert not verify_promotion_evidence(ev, writer, {})
    assert not verify_promotion_evidence(
        ev, writer, {1: Wallet.from_seed(b"other").public_bytes})
    other_chain = make_ledger(CFG)
    other_chain.register_node("0x" + "9" * 40)
    assert not verify_promotion_evidence(ev, other_chain, keys)
    assert not verify_promotion_signature({"gen": "x"}, keys)


def test_bare_fence_does_not_demote():
    srv = _server(require_auth=False, standby_keys={
        1: Wallet.from_seed(b"sb").public_bytes})
    c = CoordinatorClient(srv.host, srv.port, timeout_s=10.0)
    try:
        r = c.request("info", fence=999)
        assert r["ok"] and r.get("status") != "STALE_WRITER"
        assert r["gen"] == 0 and "gen_ev" not in r
        assert not srv.fenced.is_set()
        c2 = CoordinatorClient(srv.host, srv.port, timeout_s=10.0)
        assert c2.request("info")["ok"]
        c2.close()
    finally:
        c.close()
        srv.close()


def test_forged_evidence_rejected_at_the_socket():
    real = Wallet.from_seed(b"sb-real")
    srv = _server(require_auth=False, standby_keys={1: real.public_bytes})
    c = CoordinatorClient(srv.host, srv.port, timeout_s=10.0)
    try:
        fake = make_ledger(CFG)
        assert fake.promote_writer(1, 1) == 0
        ev = make_promotion_evidence(fake, Wallet.from_seed(b"attacker"), 1)
        r = c.request("info", fence=1, fence_ev=ev)
        assert r["ok"] and not srv.fenced.is_set()
    finally:
        c.close()
        srv.close()


def test_client_fence_moves_only_on_evidence():
    sb = Wallet.from_seed(b"fence-sb")
    chain = make_ledger(CFG)
    assert chain.promote_writer(1, 1) == 0
    ev = make_promotion_evidence(chain, sb, 1)
    forged = dict(ev, gen=999, sig="11" * 64)
    keyed = FailoverClient([("127.0.0.1", 1), ("127.0.0.1", 2)],
                           standby_keys={1: sb.public_bytes})
    fields = {}
    keyed._learn_fence({"gen": 999, "gen_ev": forged}, fields)
    keyed._learn_fence({"gen": 999}, fields)           # a bare integer
    assert keyed.gen == 0 and keyed.gen_ev is None
    keyed._learn_fence({"gen": 1, "gen_ev": ev}, fields)
    assert keyed.gen == 1 and keyed.gen_ev == ev and fields["fence"] == 1
    keyless = FailoverClient([("127.0.0.1", 1)])
    keyless._learn_fence({"gen": 999, "gen_ev": {"gen": 999}}, {})
    assert keyless.gen == 999           # the documented, weaker bar


# --------------------------------------------------- in-thread promotion
class TestInThreadPromotion:
    def test_standby_promotes_and_continues_the_chain(self):
        wallets, directory = provision_wallets(CFG.client_num,
                                               b"failover-master-0001")
        srv = _server(directory=directory)
        standby = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)],
                                1))
        client = FailoverClient([(srv.host, srv.port),
                                 (standby.host, standby.port)],
                                timeout_s=15.0)
        try:
            _register_all(client, wallets)
            _drive_round(client, wallets, epoch=0)
            info = client.request("info")
            assert info["epoch"] == 1
            head_before, size_before = info["log_head"], info["log_size"]
            _until(lambda: standby.ledger.log_size() >= size_before,
                   what="standby lagging")
            srv.close()
            assert standby.promoted.wait(timeout=30), "no promotion"
            info2 = client.request("info")     # fails over automatically
            assert info2["epoch"] == 1 and info2["gen"] == 1
            assert info2["log_size"] == size_before + 1   # the fence op
            ops = client.request("log_range", start=0,
                                 end=size_before)["ops"]
            assert _chain_head(ops) == head_before
            _drive_round(client, wallets, epoch=1)
            assert client.request("info")["epoch"] == 2
        finally:
            client.close()
            standby.stop()
            srv.close()

    def test_promoted_writer_wal_holds_full_chain(self, tmp_path):
        wallets, directory = provision_wallets(CFG.client_num,
                                               b"failover-master-0003")
        srv = _server(directory=directory)
        wal = str(tmp_path / "promoted.wal")
        standby = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)],
                                1, wal_path=wal))
        client = FailoverClient([(srv.host, srv.port),
                                 (standby.host, standby.port)],
                                timeout_s=15.0)
        try:
            _register_all(client, wallets)
            _drive_round(client, wallets, epoch=0)
            size = client.request("info")["log_size"]
            _until(lambda: standby.ledger.log_size() >= size)
            srv.close()
            assert standby.promoted.wait(timeout=30)
            _drive_round(client, wallets, epoch=1)
            info = client.request("info")
            for fresh in (make_ledger(CFG),
                          ref_make_ledger(REF_CFG, backend="python")):
                assert fresh.replay_wal(wal) == info["log_size"]
                assert fresh.log_head().hex() == info["log_head"]
        finally:
            client.close()
            standby.stop()
            srv.close()

    def test_two_standbys_promote_in_priority_order(self):
        wallets, directory = provision_wallets(CFG.client_num,
                                               b"failover-master-0002")
        srv = _server(directory=directory)
        eps = [(srv.host, srv.port), ("127.0.0.1", 0), ("127.0.0.1", 0)]
        sb1 = _standby(eps, 1)
        eps[1] = (sb1.host, sb1.port)
        sb2 = _standby(eps, 2)
        eps[2] = (sb2.host, sb2.port)
        _run(sb1)
        _run(sb2)
        client = FailoverClient(eps, timeout_s=15.0)
        try:
            _register_all(client, wallets)
            _drive_round(client, wallets, epoch=0)
            size = client.request("info")["log_size"]
            _until(lambda: min(sb1.ledger.log_size(),
                               sb2.ledger.log_size()) >= size)
            sb1.stop()
            srv.close()
            assert sb2.promoted.wait(timeout=45), \
                "second standby did not promote"
            assert client.request("info")["epoch"] == 1
            _drive_round(client, wallets, epoch=1)
            info = client.request("info")
            assert info["epoch"] == 2 and info["writer_index"] == 2
        finally:
            client.close()
            sb1.stop()
            sb2.stop()
            srv.close()

    def test_lower_priority_standby_refollows_promoted_winner(self):
        wallets, directory = provision_wallets(CFG.client_num,
                                               b"failover-master-0004")
        srv = _server(directory=directory)
        eps = [(srv.host, srv.port), ("127.0.0.1", 0), ("127.0.0.1", 0)]
        sb1 = _standby(eps, 1)
        eps[1] = (sb1.host, sb1.port)
        sb2 = _standby(eps, 2)
        eps[2] = (sb2.host, sb2.port)
        _run(sb1)
        _run(sb2)
        client = FailoverClient(eps, timeout_s=15.0)
        try:
            _register_all(client, wallets)
            _drive_round(client, wallets, epoch=0)
            size = client.request("info")["log_size"]
            _until(lambda: min(sb1.ledger.log_size(),
                               sb2.ledger.log_size()) >= size)
            srv.close()
            assert sb1.promoted.wait(timeout=30)
            assert not sb2.promoted.is_set()
            _drive_round(client, wallets, epoch=1)
            size2 = client.request("info")["log_size"]
            _until(lambda: sb2.ledger.log_size() >= size2, 30,
                   "sb2 re-following the promoted writer")
            assert not sb2.promoted.is_set()
            assert sb2.ledger.log_head() == sb1.ledger.log_head()
            assert sb2.ledger.generation == 1
        finally:
            client.close()
            sb1.stop()
            sb2.stop()
            srv.close()

    def test_standby_ahead_of_the_promoted_writer_drops_its_suffix(self):
        """C12: with quorum-ack 1 the dead writer's last ops reached the
        second standby only (the kill cut the first one's frames).  The
        first promotes without them; the second must roll back to the
        fenced chain and keep acking, or the promoted writer loses its
        one quorum follower and every mutation times out."""
        wallets, directory = provision_wallets(CFG.client_num,
                                               b"failover-master-0012")
        sbw = {i: Wallet.from_seed(b"c12-sb-%d" % i) for i in (1, 2)}
        keys = {i: w.public_bytes for i, w in sbw.items()}
        srv = _server(directory=directory, quorum=1, quorum_timeout_s=10.0,
                      standby_keys=keys)
        eps = [(srv.host, srv.port), ("127.0.0.1", 0), ("127.0.0.1", 0)]
        sb1 = _standby(eps, 1, wallet=sbw[1], standby_keys=keys, quorum=1,
                       quorum_timeout_s=10.0)
        eps[1] = (sb1.host, sb1.port)
        sb2 = _standby(eps, 2, wallet=sbw[2], standby_keys=keys, quorum=1,
                       quorum_timeout_s=10.0)
        eps[2] = (sb2.host, sb2.port)
        armed, cut = threading.Event(), threading.Event()
        follow_op = sb1._await_upload_payload

        def lose_frame(op_bytes, ctl, writer):
            if armed.is_set() and not cut.is_set():
                # the op's frame never arrives whole: the stream breaks
                # once the writer is gone
                assert cut.wait(timeout=30)
                raise WriterDead("frame cut by the kill")
            return follow_op(op_bytes, ctl, writer)

        sb1._await_upload_payload = lose_frame
        _run(sb1)
        _run(sb2)
        client = FailoverClient(eps, timeout_s=30.0, standby_keys=keys)
        try:
            _register_all(client, wallets)
            _drive_round(client, wallets, epoch=0)
            size = client.request("info")["log_size"]
            _until(lambda: min(sb1.ledger.log_size(),
                               sb2.ledger.log_size()) >= size)
            armed.set()
            _uploads(client, wallets, epoch=1)      # acked through sb2
            _until(lambda: sb2.ledger.log_size() >= size + 3)
            assert sb1.ledger.log_size() == size
            srv.close()
            client.close()
            cut.set()
            assert sb1.promoted.wait(timeout=30)
            _drive_round(client, wallets, epoch=1)  # quorum: sb2's acks
            info = client.request("info")
            assert info["epoch"] == 2 and info["gen"] == 1
            _until(lambda: sb2.ledger.log_size() >= info["log_size"], 30,
                   "sb2 following the promoted writer")
            assert sb2.ledger.log_head().hex() == info["log_head"]
            assert sb2.ledger.generation == 1 and not sb2.promoted.is_set()
        finally:
            client.close()
            sb1.stop()
            sb2.stop()
            srv.close()

    def test_standby_diverging_from_an_unfenced_writer_stops(self):
        """C12's bound: ops of ours that the writer lacks are dropped only
        past a promotion fence.  Against a writer of our own generation
        (no promotion between the chains) the standby stops on the
        divergence, as the reference's does, and keeps its chain."""
        srv = _server(require_auth=False)
        sb = _standby([(srv.host, srv.port), ("127.0.0.1", 0)], 1)
        c = CoordinatorClient(srv.host, srv.port, timeout_s=15.0)
        try:
            for i in range(2):
                assert c.request("register", addr=f"0x{i:040x}")["ok"]
            sb.ledger.register_node(f"0x{0:040x}")
            sb.ledger.register_node(f"0x{7:040x}")      # not the writer's
            head = sb.ledger.log_head()
            with pytest.raises(RuntimeError, match="divergence at op 1"):
                sb._follow((srv.host, srv.port))
            assert sb.ledger.log_size() == 2
            assert sb.ledger.log_head() == head
        finally:
            c.close()
            sb.stop()
            srv.close()

    def test_rollback_drops_a_failed_fence(self):
        sb = _standby([("127.0.0.1", 1), ("127.0.0.1", 0)], 1)
        try:
            for i in range(CFG.client_num):
                sb.ledger.register_node(f"0x{i:040x}")
            head = sb.ledger.log_head()
            assert sb.ledger.promote_writer(1, 1) == 0
            sb._rollback_last_op()
            assert sb.ledger.log_head() == head
            assert sb.ledger.generation == 0
            assert sb.ledger.log_size() == CFG.client_num
        finally:
            sb.stop()

    def test_standby_rejects_bad_index(self):
        with pytest.raises(ValueError):
            Standby(CFG, [("127.0.0.1", 1)], 1, device="cpu")


class TestFailoverClient:
    def test_rotates_to_live_endpoint(self):
        srv = _server(require_auth=False)
        client = FailoverClient([("127.0.0.1", 1), (srv.host, srv.port)],
                                timeout_s=5.0)
        try:
            assert client.request("info")["ok"]
            assert client.current_endpoint == (srv.host, srv.port)
        finally:
            client.close()
            srv.close()

    def test_all_dead_raises(self):
        client = FailoverClient([("127.0.0.1", 1)], timeout_s=1.0,
                                max_cycles=2)
        with pytest.raises(ConnectionError):
            client.request("info")

    def test_keyless_multi_endpoint_warns_about_fence_poisoning(self):
        eps = [("127.0.0.1", 1), ("127.0.0.1", 2)]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            FailoverClient(eps, timeout_s=1.0)
        assert any("standby_keys" in str(w.message) for w in caught)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            FailoverClient(eps[:1], timeout_s=1.0)
            FailoverClient(eps, timeout_s=1.0, standby_keys={
                1: Wallet.from_seed(b"keyless-warn-test").public_bytes})


class _Partition:
    """A killable TCP forwarder: the standby's only path to the writer."""

    def __init__(self, target):
        self._target = target
        self._socks = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._lsock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._lsock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self.host, self.port = self._lsock.getsockname()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                a, _ = self._lsock.accept()
                b = _socket.create_connection(self._target, timeout=5.0)
            except OSError:
                return
            with self._lock:
                self._socks += [a, b]
            for src, dst in ((a, b), (b, a)):
                threading.Thread(target=self._pump, args=(src, dst),
                                 daemon=True).start()

    def _pump(self, src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def cut(self):
        self._stop.set()
        with self._lock:
            socks, self._socks = self._socks, []
        for s in [self._lsock] + socks:
            try:
                s.close()
            except OSError:
                pass


def test_partition_promote_heal_single_history():
    """The split-brain drill: partition the writer from its standby, let
    it promote, heal, and one committed history survives."""
    wallets, directory = provision_wallets(CFG.client_num,
                                           b"splitbrain-master-01")
    sb_wallet = Wallet.from_seed(b"splitbrain-standby-1")
    keys = {1: sb_wallet.public_bytes}
    srv = _server(directory=directory, standby_keys=keys)
    proxy = _Partition((srv.host, srv.port))
    standby = _run(_standby([(proxy.host, proxy.port), ("127.0.0.1", 0)],
                            1, wallet=sb_wallet, standby_keys=keys))
    direct = CoordinatorClient(srv.host, srv.port, timeout_s=10.0)
    informed = None
    try:
        for w in wallets[:-1]:
            r = direct.request("register", addr=w.address,
                               pubkey=w.public_bytes.hex(),
                               tag=_sign(w, "register", 0, b""))
            assert r["ok"], r
        size_before = srv.ledger.log_size()
        _until(lambda: standby.ledger.log_size() >= size_before)
        proxy.cut()
        assert standby.promoted.wait(timeout=30), "no promotion"
        w_div = wallets[-1]
        r = direct.request("register", addr=w_div.address,
                           pubkey=w_div.public_bytes.hex(),
                           tag=_sign(w_div, "register", 0, b""))
        assert r["ok"], r
        assert srv.ledger.log_size() == size_before + 1
        assert standby.ledger.log_op(size_before) != \
            srv.ledger.log_op(size_before)      # a genuine fork
        promoted_ep = (standby.host, standby.port)
        informed = FailoverClient([(srv.host, srv.port), promoted_ep],
                                  timeout_s=10.0, standby_keys=keys)
        informed.gen = 1            # saw the promotion, lost the proof
        r = informed.request("info")
        assert r["gen"] == 1        # answered by the promoted writer
        assert not srv.fenced.is_set()
        assert informed.gen_ev is not None       # learned retroactively
        informed._cur = 0
        informed.close()
        r2 = informed.request("info")            # now WITH the evidence
        assert r2["gen"] == 1
        assert srv.fenced.wait(timeout=10), "stale writer not fenced"
        r3 = informed.request("register", addr=w_div.address,
                              pubkey=w_div.public_bytes.hex(),
                              tag=_sign(w_div, "register", 0, b""))
        assert r3["ok"] or r3["status"] == "DUPLICATE"
        assert standby.ledger.verify_log()

        def refused():
            try:
                CoordinatorClient(srv.host, srv.port, timeout_s=2.0).close()
                return False
            except (ConnectionError, OSError):
                return True
        _until(refused, 10, "the stale writer still accepts connections")
    finally:
        if informed is not None:
            informed.close()
        direct.close()
        standby.stop()
        srv.close()


# ----------------------------------------------------------- quorum-ack
class TestQuorumAck:
    def test_acknowledged_op_is_on_the_standby(self):
        srv = _server(require_auth=False, quorum=1, quorum_timeout_s=10.0)
        standby = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)],
                                1, require_auth=False))
        c = CoordinatorClient(srv.host, srv.port, timeout_s=15.0)
        try:
            _until(lambda: srv._sub_acked, 10, "standby never followed")
            for i in range(CFG.client_num):
                r = c.request("register", addr=f"0x{i:040x}")
                assert r["ok"], r
                assert standby.ledger.log_size() >= srv.ledger.log_size()
        finally:
            c.close()
            standby.stop()
            srv.close()

    def test_no_quorum_means_replication_timeout_then_retry_succeeds(self):
        srv = _server(require_auth=False, quorum=1, quorum_timeout_s=0.5)
        c = CoordinatorClient(srv.host, srv.port, timeout_s=15.0)
        standby = None
        try:
            r = c.request("register", addr="0x" + "01" * 20)
            assert not r["ok"] and r["status"] == "REPLICATION_TIMEOUT", r
            assert srv.ledger.num_registered == 1
            standby = _run(_standby([(srv.host, srv.port),
                                     ("127.0.0.1", 0)], 1,
                                    require_auth=False))
            deadline = time.monotonic() + 15
            while True:
                r2 = c.request("register", addr="0x" + "01" * 20)
                if r2["status"] == "ALREADY_REGISTERED":
                    break
                assert time.monotonic() < deadline, r2
                time.sleep(0.2)
            _until(lambda: standby.ledger.num_registered >= 1, 15)
        finally:
            c.close()
            if standby is not None:
                standby.stop()
            srv.close()

    def test_anonymous_acker_cannot_fake_quorum(self):
        sb_wallet = Wallet.from_seed(b"quorum-sb-1")
        srv = _server(require_auth=False, quorum=1, quorum_timeout_s=1.0,
                      standby_keys={1: sb_wallet.public_bytes})
        c = CoordinatorClient(srv.host, srv.port, timeout_s=15.0)
        liar = standby = None
        try:
            liar = CoordinatorClient(srv.host, srv.port, timeout_s=5.0)
            send_msg(liar.sock, {"method": "subscribe", "from": 0})
            send_msg(liar.sock, {"ack": 10 ** 18})
            time.sleep(0.3)
            r = c.request("register", addr="0x" + "aa" * 20)
            assert r["status"] == "REPLICATION_TIMEOUT", r
            standby = _run(_standby([(srv.host, srv.port),
                                     ("127.0.0.1", 0)], 1,
                                    require_auth=False, wallet=sb_wallet))
            deadline = time.monotonic() + 15
            while True:
                r2 = c.request("register", addr="0x" + "aa" * 20)
                if r2["status"] == "ALREADY_REGISTERED":
                    break
                assert time.monotonic() < deadline, r2
                time.sleep(0.3)
        finally:
            c.close()
            if liar is not None:
                liar.close()
            if standby is not None:
                standby.stop()
            srv.close()

    def test_quorum_two_standbys(self):
        w1, w2 = Wallet.from_seed(b"q2-sb-1"), Wallet.from_seed(b"q2-sb-2")
        keys = {1: w1.public_bytes, 2: w2.public_bytes}
        srv = _server(require_auth=False, quorum=2, quorum_timeout_s=1.0,
                      standby_keys=keys)
        eps = [(srv.host, srv.port), ("127.0.0.1", 0), ("127.0.0.1", 0)]
        sbs = []
        c = CoordinatorClient(srv.host, srv.port, timeout_s=15.0)
        try:
            sbs.append(_run(_standby(eps, 1, require_auth=False, wallet=w1,
                                     standby_keys=keys)))
            _until(lambda: srv._sub_acked, 10)
            r = c.request("register", addr="0x" + "bb" * 20)
            assert r["status"] == "REPLICATION_TIMEOUT", r
            sbs.append(_run(_standby(eps, 2, require_auth=False, wallet=w2,
                                     standby_keys=keys)))
            deadline = time.monotonic() + 15
            while True:
                r2 = c.request("register", addr="0x" + "bb" * 20)
                if r2["status"] == "ALREADY_REGISTERED":
                    break
                assert time.monotonic() < deadline, r2
                time.sleep(0.3)
            for sb in sbs:
                _until(lambda: sb.ledger.num_registered >= 1, 15)
        finally:
            c.close()
            for sb in sbs:
                sb.stop()
            srv.close()

    def test_skipped_blob_is_not_certified_by_a_later_ack(self):
        class _FlakyBlobStandby(Standby):
            """Both mirror paths (the fetch and the op stream's
            piggyback) fail for the chosen digests."""

            def __init__(self, *a, **kw):
                self.fail_digests = set()
                super().__init__(*a, **kw)

            def _failing(self, op_bytes) -> bool:
                return bool(op_bytes) and op_bytes[0] == OP_UPLOAD and \
                    decode_op(op_bytes).get("payload_hash") in \
                    self.fail_digests

            def _mirror_upload_payload(self, op_bytes, ctl):
                if self._failing(op_bytes):
                    return False
                return super()._mirror_upload_payload(op_bytes, ctl)

            def _harvest_pushed_blob(self, msg, op_bytes):
                if not self._failing(op_bytes):
                    super()._harvest_pushed_blob(msg, op_bytes)

        srv = _server(require_auth=False, quorum=1, quorum_timeout_s=1.5)
        standby = _FlakyBlobStandby(
            CFG, [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
            heartbeat_s=0.3, stall_timeout_s=60.0, require_auth=False,
            ledger_backend="python", device="cpu")
        standby.endpoints[1] = (standby.host, standby.port)
        _run(standby)
        c = CoordinatorClient(srv.host, srv.port, timeout_s=20.0)
        try:
            _until(lambda: srv._sub_acked, 10)
            for i in range(CFG.client_num):
                assert c.request("register", addr=f"0x{i:040x}")["ok"]
            committee = set(c.request("committee")["committee"])
            trainers = [f"0x{i:040x}" for i in range(CFG.client_num)
                        if f"0x{i:040x}" not in committee]
            blob_a, blob_b = _delta_blob(1.0), _delta_blob(2.0)
            dig_a = hashlib.sha256(blob_a).digest()
            dig_b = hashlib.sha256(blob_b).digest()
            standby.fail_digests.add(dig_a.hex())
            r = c.request("upload", addr=trainers[0], blob=blob_a.hex(),
                          hash=dig_a.hex(), n=10, cost=1.0, epoch=0)
            assert r["status"] == "REPLICATION_TIMEOUT", r
            r = c.request("upload", addr=trainers[1], blob=blob_b.hex(),
                          hash=dig_b.hex(), n=11, cost=1.0, epoch=0)
            assert r["status"] == "REPLICATION_TIMEOUT", r
            r = c.request("upload", addr=trainers[0], blob=blob_a.hex(),
                          hash=dig_a.hex(), n=10, cost=1.0, epoch=0)
            assert r["status"] == "REPLICATION_TIMEOUT", r
            assert standby._blobs.get(dig_a) is None
            standby.fail_digests.clear()
            deadline = time.monotonic() + 20
            while True:
                r = c.request("upload", addr=trainers[0],
                              blob=blob_a.hex(), hash=dig_a.hex(), n=10,
                              cost=1.0, epoch=0)
                if r["status"] == "DUPLICATE":
                    break
                assert time.monotonic() < deadline, r
                time.sleep(0.3)
            assert standby._blobs.get(dig_a) == blob_a
            assert standby._blobs.get(dig_b) == blob_b
        finally:
            c.close()
            standby.stop()
            srv.close()

    def test_acknowledged_upload_payload_is_on_the_standby(self):
        srv = _server(require_auth=False, quorum=1, quorum_timeout_s=10.0)
        standby = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)],
                                1, require_auth=False))
        c = CoordinatorClient(srv.host, srv.port, timeout_s=20.0)
        try:
            _until(lambda: srv._sub_acked, 10)
            for i in range(CFG.client_num):
                assert c.request("register", addr=f"0x{i:040x}")["ok"]
            committee = set(c.request("committee")["committee"])
            trainer = next(f"0x{i:040x}" for i in range(CFG.client_num)
                           if f"0x{i:040x}" not in committee)
            blob = _delta_blob(1.5)
            digest = hashlib.sha256(blob).digest()
            r = c.request("upload", addr=trainer, blob=blob.hex(),
                          hash=digest.hex(), n=10, cost=1.0, epoch=0)
            assert r["ok"], r
            assert standby._blobs.get(digest) == blob
        finally:
            c.close()
            standby.stop()
            srv.close()


# -------------------------------------------------------- read fan-out
class TestReadFanout:
    def test_replica_serves_hash_verified_reads(self):
        store = {hashlib.sha256(b"abc").digest(): b"abc"}
        model = _init_blob()
        rep = ReadFanoutServer(
            store.get, lambda: (0, hashlib.sha256(model).digest(), model))
        rep.start()
        try:
            c = CoordinatorClient(rep.host, rep.port)
            h = hashlib.sha256(b"abc").hexdigest()
            assert blob_bytes(c.request("blob", hash=h)["blob"]) == b"abc"
            assert blob_bytes(c.request("model")["blob"]) == model
            r = c.request("upload", addr="0x0", blob=b"", hash="",
                          n=1, cost=0.0, epoch=0)
            assert not r["ok"] and "unknown method" in r["error"]
            c.close()
        finally:
            rep.close()

    def test_lying_replica_fails_hash_check_and_router_falls_back(self):
        srv = _server(require_auth=False)
        liar = ReadFanoutServer(
            lambda d: b"not-the-blob",
            lambda: (0, hashlib.sha256(b"forged").digest(), b"forged"))
        liar.start()
        try:
            ctl = CoordinatorClient(srv.host, srv.port)
            router = ReadRouter(ctl)
            router._read_set = [liar.endpoint]
            mr = router.fetch_model()
            assert mr["ok"] and mr["source"] == "writer"
            assert mr["blob"] == _init_blob()
            ctl.close()
        finally:
            liar.close()
            srv.close()

    def test_stale_replica_first_in_rotation_does_not_mask_fresh_one(self):
        srv = _server(require_auth=False)
        model = _init_blob()
        stale = ReadFanoutServer(
            lambda d: None,
            lambda: (0, hashlib.sha256(b"old-model").digest(), b"old-model"))
        fresh = ReadFanoutServer(
            lambda d: None,
            lambda: (0, hashlib.sha256(model).digest(), model))
        stale.start()
        fresh.start()
        try:
            ctl = CoordinatorClient(srv.host, srv.port)
            router = ReadRouter(ctl)
            router._read_set = [stale.endpoint, fresh.endpoint]
            router._rr = 0
            mr = router.fetch_model()
            assert mr["ok"] and mr["blob"] == model
            assert mr["source"] == "replica", mr["source"]
            ctl.close()
        finally:
            stale.close()
            fresh.close()
            srv.close()

    def test_dead_replica_mid_run_degrades_to_coordinator(self):
        srv = _server(require_auth=False)
        payload = b"p" * 4096
        digest = hashlib.sha256(payload).digest()
        srv._blobs[digest] = payload
        rep = ReadFanoutServer({digest: payload}.get, lambda: None)
        rep.start()
        try:
            ctl = CoordinatorClient(srv.host, srv.port)
            router = ReadRouter(ctl)
            router._read_set = [rep.endpoint]
            h = digest.hex()
            assert router.fetch_blobs([h])[h] == payload
            assert router.reads[("blob", "replica")] == 1
            rep.close()
            payload2 = b"q" * 4096
            d2 = hashlib.sha256(payload2).digest()
            srv._blobs[d2] = payload2
            assert router.fetch_blobs([d2.hex()])[d2.hex()] == payload2
            assert router.reads[("blob", "writer")] == 1
            ctl.close()
        finally:
            rep.close()
            srv.close()


class TestReadSetAdvertisement:
    def test_standby_read_ep_advertised_and_served(self):
        wallet = Wallet.from_seed(b"dp-readset-standby-1")
        keys = {1: wallet.public_bytes}
        srv = _server(require_auth=False, standby_keys=keys)
        sb = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                           wallet=wallet, standby_keys=keys))
        try:
            ctl = CoordinatorClient(srv.host, srv.port)
            deadline = time.monotonic() + 20.0
            meta = {}
            while time.monotonic() < deadline:
                meta = ctl.request("model", meta=1)
                if meta.get("read_set"):
                    break
                time.sleep(0.2)
            assert meta.get("read_set") == [list(sb.read_server.endpoint)]
            assert "blob" not in meta
            _until(lambda: sb._model_blob is not None)
            router = ReadRouter(ctl)
            router.note_read_set(meta)
            mr = router.fetch_model()
            assert mr["ok"] and mr["blob"] == _init_blob()
            assert mr["source"] == "replica", mr["source"]
            assert router.fetch_model()["source"] == "cache"
            ctl.close()
        finally:
            sb.stop()
            srv.close()

    def test_anonymous_subscriber_read_ep_ignored(self):
        srv = _server(require_auth=False, standby_keys={1: b"\x01" * 32})
        try:
            sub = CoordinatorClient(srv.host, srv.port)
            send_msg(sub.sock, {"method": "subscribe", "from": 0,
                                "read_ep": ["127.0.0.1", 1]})
            time.sleep(0.5)
            ctl = CoordinatorClient(srv.host, srv.port)
            assert not ctl.request("model", meta=1).get("read_set")
            ctl.close()
            sub.close()
        finally:
            srv.close()


# --------------------------------------------------------- mixed fleets
def test_port_standbys_follow_a_reference_writer_and_promote():
    wallets, _ = ref_id.provision_wallets(CFG.client_num,
                                          b"mixed-failover-01")
    sbw = {i: Wallet.from_seed(b"mixed-sb-%d" % i) for i in (1, 2)}
    keys = {i: w.public_bytes for i, w in sbw.items()}
    srv = ref_ls.LedgerServer(REF_CFG, _init_blob(), stall_timeout_s=60.0,
                              ledger_backend="python", quorum=1,
                              quorum_timeout_s=10.0, standby_keys=keys)
    srv.start()
    eps = [(srv.host, srv.port), ("127.0.0.1", 0), ("127.0.0.1", 0)]
    sb1 = _standby(eps, 1, wallet=sbw[1], standby_keys=keys, quorum=1,
                   quorum_timeout_s=10.0)
    eps[1] = (sb1.host, sb1.port)
    sb2 = _standby(eps, 2, wallet=sbw[2], standby_keys=keys, quorum=1,
                   quorum_timeout_s=10.0)
    eps[2] = (sb2.host, sb2.port)
    _run(sb1)
    _run(sb2)
    client = ref_fo.FailoverClient(eps, timeout_s=20.0, standby_keys=keys)
    try:
        _until(lambda: sum(srv._sub_eligible.values()) == 2, 20,
               "the reference writer to count both port standbys")
        # quorum 1 at the reference writer: every ok below is a port ack
        _register_all(client, wallets)
        _drive_round(client, wallets, epoch=0)
        size = client.request("info")["log_size"]
        _until(lambda: min(sb1.ledger.log_size(),
                           sb2.ledger.log_size()) >= size)
        srv.close()
        # a closed reference writer goes on answering the connections it
        # holds; drop the client's, as a killed writer process would
        client.close()
        assert sb1.promoted.wait(timeout=30)
        _drive_round(client, wallets, epoch=1)   # acked through sb2
        info = client.request("info")
        assert info["epoch"] == 2 and info["gen"] == 1
        assert client.gen == 1 and client.gen_ev["sb"] == 1
        _until(lambda: sb2.ledger.log_size() >= info["log_size"], 30)
        assert sb2.ledger.log_head().hex() == info["log_head"]
    finally:
        client.close()
        sb1.stop()
        sb2.stop()
        srv.close()


def test_reference_standby_follows_the_port_writer_and_promotes():
    wallets, _ = provision_wallets(CFG.client_num, b"mixed-failover-02")
    ref_sbw = ref_id.Wallet.from_seed(b"mixed-ref-sb-1")
    keys = {1: ref_sbw.public_bytes}
    srv = _server(quorum=1, quorum_timeout_s=10.0, standby_keys=keys)
    standby = ref_fo.Standby(REF_CFG, [(srv.host, srv.port),
                                       ("127.0.0.1", 0)], 1,
                             heartbeat_s=0.3, stall_timeout_s=60.0,
                             ledger_backend="python", wallet=ref_sbw,
                             standby_keys=keys)
    standby.endpoints[1] = (standby.host, standby.port)
    threading.Thread(target=standby.run, daemon=True).start()
    client = FailoverClient([(srv.host, srv.port),
                             (standby.host, standby.port)],
                            timeout_s=20.0, standby_keys=keys)
    try:
        _until(lambda: any(srv._sub_eligible.values()), 20,
               "the port writer to count the reference standby")
        _register_all(client, wallets)
        _drive_round(client, wallets, epoch=0)
        # the piggyback: the reference standby mirrored every payload
        # and the committed model without fetching them
        size = client.request("info")["log_size"]
        _until(lambda: standby.ledger.log_size() >= size)
        srv.close()
        assert standby.promoted.wait(timeout=30)
        _drive_round(client, wallets, epoch=1)
        info = client.request("info")
        assert info["epoch"] == 2 and info["gen"] == 1
        assert client.gen == 1 and client.gen_ev is not None
    finally:
        client.close()
        standby.stop()
        srv.close()


# ------------------------------------------------ bytes across failover
def _wide_init():
    rng = np.random.default_rng(10)
    return pack_entries({"['W']": rng.standard_normal((64, 48)).astype(
        np.float32), "['b']": rng.standard_normal(48).astype(np.float32)})


def _wide_delta(i):
    rng = np.random.default_rng(100 + i)
    return pack_entries({
        "['W']": (rng.standard_normal((64, 48)) * 0.1).astype(np.float32),
        "['b']": (rng.standard_normal(48) * 0.1).astype(np.float32)})


def _committed_model(kind, wallets):
    """Round 0 of the signed script: 'port' and 'reference' writers
    alone, 'failover' a port writer closed after the uploads with its
    standby committing the scores."""
    if kind == "reference":
        srv = ref_ls.LedgerServer(REF_CFG, _wide_init(),
                                  stall_timeout_s=60.0,
                                  ledger_backend="python")
        srv.start()
    else:
        srv = _server(init=_wide_init())
    sb = None
    eps = [(srv.host, srv.port)]
    if kind == "failover":
        sb = _run(_standby([(srv.host, srv.port), ("127.0.0.1", 0)], 1))
        eps.append((sb.host, sb.port))
    client = FailoverClient(eps, timeout_s=20.0)
    try:
        _register_all(client, wallets)
        committee = _uploads(client, wallets, 0, _wide_delta)
        if sb is not None:
            size = client.request("info")["log_size"]
            _until(lambda: sb.ledger.log_size() >= size)
            srv.close()
            assert sb.promoted.wait(timeout=30)
        _scores(client, wallets, 0, committee)
        if sb is not None:
            assert client.request("info")["gen"] == 1
        r = client.request("model")
        assert r["epoch"] == 1
        writer = sb.server if sb is not None else srv
        leg = getattr(getattr(writer, "engine", None), "last_leg", None)
        return blob_bytes(r["blob"]), leg, client.request("info")
    finally:
        client.close()
        if sb is not None:
            sb.stop()
        srv.close()


def test_committed_model_bytes_survive_a_failover(monkeypatch):
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    wallets, _ = provision_wallets(CFG.client_num, b"bytes-failover-01")
    port, port_leg, _ = _committed_model("port", wallets)
    moved, moved_leg, info = _committed_model("failover", wallets)
    ref, _, _ = _committed_model("reference", wallets)
    assert port_leg == moved_leg == "mesh"
    assert info["gen"] == 1
    assert moved == port == ref


def test_closed_writer_serves_no_late_request(monkeypatch):
    """C20: a request that reaches a writer's socket after close() is not
    served.  Shutting a connection's read side does not drop bytes that
    arrive before its serving thread wakes, so under load the failover
    drill's closed writer took the first committee score while the
    promoted standby took the second (epoch 0 after both scores:
    `test_committed_model_bytes_survive_a_failover`'s flake).  The
    serving thread here wakes 0.5 s late, after the close."""
    from bflc_demo_tpu_torch.comm import ledger_service
    srv = _server()
    real = ledger_service.recv_msg

    def wakes_late(conn):
        time.sleep(0.5)
        return real(conn)
    monkeypatch.setattr(ledger_service, "recv_msg", wakes_late)
    client = CoordinatorClient(srv.host, srv.port, timeout_s=5.0)
    try:
        time.sleep(0.1)          # its serving thread is in the late recv
        srv.close()
        with pytest.raises((ConnectionError, WireError, OSError)):
            client.request("info")
    finally:
        client.close()
        srv.close()


class _ScriptedWriter:
    """A client's view of the writer: `state` replies from a script of
    (epoch, role), the round's one update, and each `scores` request
    recorded and answered WRONG_EPOCH the first time, OK after."""

    def __init__(self, states):
        self.states = list(states)
        self.scores = []

    def request(self, method, **kw):
        if method == "state":
            epoch, role = self.states.pop(0) if self.states else (99, "")
            return {"ok": True, "epoch": epoch, "role": role}
        if method == "updates":
            return {"ok": True, "updates": [{"hash": "ab" * 32}]}
        if method == "scores":
            self.scores.append(kw["epoch"])
            return ({"ok": False, "status": "WRONG_EPOCH"}
                    if len(self.scores) == 1 else {"ok": True,
                                                   "status": "OK"})
        assert method == "wait", method
        return {"ok": True, "log_size": 0}


class _ScriptedRouter:
    def fetch_blobs(self, hashes):
        return {h: b"" for h in hashes}

    def fetch_model(self):
        return {"ok": True, "epoch": 0, "blob": b""}


@pytest.mark.parametrize("states, scored", [
    # the writer moved past the round: it is settled, nothing to score
    ([(2, "comm"), (3, ""), (5, "")], [2]),
    # a failover lost the commit that opened epoch 2 (the writer is back
    # at 1), and the member must score epoch 2 when the chain reaches it
    ([(2, "comm"), (1, ""), (2, "comm"), (5, "")], [2, 2]),
])
def test_c13_wrong_epoch_counts_as_scored_only_past_the_round(
        monkeypatch, states, scored):
    """C13: a committee member that saw epoch 2 on the dead writer and
    sent its scores to the promoted one (still at epoch 1) got
    WRONG_EPOCH and marked epoch 2 scored.  When the promoted chain
    reached epoch 2 with the same committee, no member scored and the
    stall recovery, which reseats only a silent committee, never fired:
    the config-5 failover run stopped at 2 of 7 rounds."""
    from bflc_demo_tpu_torch.meshagg import engine
    from bflc_demo_tpu_torch.utils import serialization
    monkeypatch.setattr(engine, "score_candidates_batched",
                        lambda model, params, deltas, *a: torch.zeros(
                            len(deltas)))
    monkeypatch.setattr(serialization, "restore_pytree", lambda t, f: t)
    monkeypatch.setattr(serialization, "unpack_pytree", lambda b: {})
    writer = _ScriptedWriter(states)
    counts = {"trainings": 0, "scored": 0, "blob_bytes": 0}
    pr._client_sync_loop(writer, _ScriptedRouter(),
                         Wallet.from_seed(b"c13-committee-member"), None,
                         {}, CFG, None, None, 10, 5, None, lambda b: b,
                         counts, lambda: None)
    assert writer.scores == scored
    assert not writer.states


class _PromotedWriter(_ScriptedWriter):
    """A promoted writer: it accepts every score row."""

    def request(self, method, **kw):
        if method == "scores":
            self.scores.append(kw["epoch"])
            return {"ok": True, "status": "OK"}
        return super().request(method, **kw)


class _LostBlobsRouter(_ScriptedRouter):
    """The first fetch asks for blobs no live writer holds."""

    def __init__(self):
        self.fetches = 0

    def fetch_blobs(self, hashes):
        self.fetches += 1
        if self.fetches == 1:
            raise LookupError("blobs unavailable from every source")
        return super().fetch_blobs(hashes)


def test_c17_a_committee_member_repolls_blobs_lost_with_the_writer(
        monkeypatch):
    """C17: a committee member read the round's `updates` from the
    primary, which died before its standby mirrored those uploads; the
    promoted writer could not serve their blobs, `fetch_blobs` raised
    LookupError and the member's process died.  With both committee
    members gone the writer-kill drill on the card stopped at 2 of 4
    rounds.  The member now waits and re-polls the promoted writer's
    list."""
    from bflc_demo_tpu_torch.meshagg import engine
    from bflc_demo_tpu_torch.utils import serialization
    monkeypatch.setattr(engine, "score_candidates_batched",
                        lambda model, params, deltas, *a: torch.zeros(
                            len(deltas)))
    monkeypatch.setattr(serialization, "restore_pytree", lambda t, f: t)
    monkeypatch.setattr(serialization, "unpack_pytree", lambda b: {})
    writer = _PromotedWriter([(2, "comm"), (2, "comm"), (5, "")])
    router = _LostBlobsRouter()
    counts = {"trainings": 0, "scored": 0, "blob_bytes": 0}
    pr._client_sync_loop(writer, router,
                         Wallet.from_seed(b"c17-committee-member"), None,
                         {}, CFG, None, None, 10, 5, None, lambda b: b,
                         counts, lambda: None)
    assert router.fetches == 2
    assert writer.scores == [2]
    assert counts["scored"] == 1
    assert not writer.states


def test_c14_a_lagging_follower_gets_each_commits_model_on_the_stream():
    """C14: the op stream piggybacked a commit op's model only while it
    was the writer's newest.  A follower lagging behind the next commit
    (async FedBuff on the card: 13-43 ops behind) got older commits bare,
    fetched the writer's newest model on every op after them, found it
    the wrong one, and fell further behind; its snapshot metas lost their
    model.  Now each of the last PAST_MODELS commits' models rides."""
    from bflc_demo_tpu_torch.comm.ledger_service import PAST_MODELS
    from bflc_demo_tpu_torch.ledger.base import OP_COMMIT
    wallets, directory = provision_wallets(CFG.client_num,
                                           b"failover-master-0014")
    srv = _server(directory=directory)
    client = FailoverClient([(srv.host, srv.port)], timeout_s=30.0)
    sub = None
    try:
        _register_all(client, wallets)
        rounds = 3
        assert rounds <= PAST_MODELS + 1
        for epoch in range(rounds):
            _drive_round(client, wallets, epoch)
        size = client.request("info")["log_size"]
        # a follower that subscribes from 0 lags behind every commit
        sub = _socket.create_connection((srv.host, srv.port), timeout=30)
        send_msg(sub, {"method": "subscribe", "from": 0})
        commits = []
        for _ in range(size):
            frame = recv_msg(sub)
            op = bytes.fromhex(frame["op"])
            if op[0] == OP_COMMIT:
                want = bytes.fromhex(decode_op(op)["model_hash"])
                blob = frame.get("blob")
                commits.append(blob is not None and hashlib.sha256(
                    blob_bytes(blob)).digest() == want)
        assert commits == [True] * rounds
    finally:
        if sub is not None:
            sub.close()
        client.close()
        srv.close()


def test_a_client_cannot_hold_the_writers_mutations():
    """No peer pauses the writer: a `settled` request with a hold (a
    method the writer does not have) is refused, and the next mutation
    is served at once."""
    wallets, directory = provision_wallets(CFG.client_num,
                                           b"failover-master-0015")
    srv = _server(directory=directory)
    client = FailoverClient([(srv.host, srv.port)], timeout_s=30.0)
    try:
        _register_all(client, wallets[:-1])
        r = client.request("settled", timeout_s=0.3, hold_s=60.0)
        assert not r["ok"]
        t0 = time.monotonic()
        _register_all(client, wallets[-1:])
        assert time.monotonic() - t0 < 5.0
        assert client.request("info")["num_registered"] == CFG.client_num
    finally:
        client.close()
        srv.close()


def _proc_state(pid: int) -> str:
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


@pytest.mark.parametrize("raises", [False, True])
def test_the_drill_pause_stops_the_clients_and_continues_them(raises):
    """The writer-kill drill's pause: every live client is SIGSTOPped in
    the block and SIGCONTed after it, also when the block raises."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=time.sleep, args=(60,), daemon=True)
             for _ in range(2)]
    for p in procs:
        p.start()
    try:
        with pytest.raises(RuntimeError) if raises else \
                contextlib.nullcontext():
            with pr._paused(procs) as rec:
                for p in procs:
                    _until(lambda: _proc_state(p.pid) == "T", 10,
                           "the client stopped")
                if raises:
                    raise RuntimeError("the kill failed")
        assert rec["stopped"] == 2 and rec["wait_s"] > 0
        for p in procs:
            _until(lambda: _proc_state(p.pid) != "T", 10,
                   "the client continued")
            assert p.is_alive()
    finally:
        for p in procs:
            p.kill()
            p.join(timeout=10)


# --------------------------------------------------- the process drill
def test_process_drill_kills_the_writer_and_the_standby_finishes():
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:1500], ytr[:1500], CFG.client_num)
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, (xte[:500], yte[:500]), CFG,
        rounds=4, standbys=1, kill_writer_at_epoch=2, stall_timeout_s=20.0,
        timeout_s=120.0, replicas=1, device="cpu")
    assert res.rounds_completed >= 4
    assert res.best_accuracy() > 0.80, res.accuracy_history
    assert res.replica_report["ok"]
    assert res.replica_report["head"] == res.ledger_log_head
    fo = res.failover
    assert fo["killed_at_epoch"] == 2 and fo["writer_index"] == 1
    assert fo["gen"] == 1 and fo["gap_s"] is not None and fo["gap_s"] > 0
    assert res.final_info["gen"] == 1
    # the promoted writer committed the rounds after the kill (and round
    # 1 again when the kill beat that commit's replication)
    assert [m["epoch"] for m in res.writer_merges] in ([2, 3], [1, 2, 3])
    for mods in res.child_foreign_modules.values():
        assert mods == []


# ---------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,item", [
    (dict(tls_client=object()), "tls_client"),
    (dict(tls_server=object()), "tls_server"),
    (dict(snapshot_interval=2), "snapshot_interval")])
def test_standby_refuses_unported_options(kw, item):
    # the reference's TLS and snapshot options are ported (A9.4, A9.5):
    # the standby takes each and keeps it for the server it becomes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # wallet-less standby
        sb = Standby(CFG, [("127.0.0.1", 1), ("127.0.0.1", 0)], 1,
                     device="cpu", **kw)
    try:
        assert getattr(sb, item) == kw[item]
    finally:
        sb.stop()


@pytest.mark.parametrize("kw", [dict(chaos_seed=7),
                                dict(chaos_profile="light"),
                                dict(telemetry_dir="t")])
def test_fleet_refuses_unported_options(kw):
    shards = [(np.zeros((2, 5), np.float32), np.zeros(2, np.int64))] * 6
    with pytest.raises(NotImplementedError, match=r"ROADMAP A(9|14)"):
        pr.run_federated_processes("make_softmax_regression", shards,
                                   shards[0], CFG, standbys=1,
                                   device="cpu", **kw)


def test_fleet_checks_standby_counts():
    shards = [(np.zeros((2, 5), np.float32), np.zeros(2, np.int64))] * 6
    for kw, match in ((dict(kill_writer_at_epoch=1), "standbys >= 1"),
                      (dict(standbys=1, quorum=1), "standbys >= 2")):
        with pytest.raises(ValueError, match=match):
            pr.run_federated_processes("make_softmax_regression", shards,
                                       shards[0], CFG, device="cpu", **kw)


def test_standby_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Standby(CFG, [("127.0.0.1", 1), ("127.0.0.1", 0)], 1)


@pytest.mark.parametrize("argv,err", [
    (["--quorum", "1"], "--standbys >= Q+1"),
    (["--standbys", "1", "--quorum", "1"], "--standbys >= Q+1"),
    (["--runtime", "mesh", "--standbys", "1"], "apply only to --runtime"),
])
def test_cli_quorum_needs_enough_standbys(capsys, argv, err):
    argv = ["--device", "cpu", "--runtime", "processes", *argv]
    assert cli(argv) == 2
    assert err in capsys.readouterr().err


def test_subscriber_handshake_bytes_are_the_references():
    """The port standby's signed subscribe passes the reference writer's
    handshake check, and a reference standby's passes the port's."""
    sbw = Wallet.from_seed(b"hs-sb")
    keys = {1: sbw.public_bytes}
    for server in (ref_ls.LedgerServer(REF_CFG, _init_blob(),
                                       require_auth=False,
                                       ledger_backend="python",
                                       standby_keys=keys),
                   _server(require_auth=False, standby_keys=keys)):
        server.start()
        sub = CoordinatorClient(server.host, server.port, timeout_s=10.0)
        try:
            send_msg(sub.sock, {"method": "subscribe", "from": 0, "sb": 1})
            ch = bytes.fromhex(recv_msg(sub.sock)["challenge"])
            msg = LedgerServer._SUB_MAGIC + ch + struct.pack("<Iq", 1, 0)
            assert msg.startswith(ref_ls.LedgerServer._SUB_MAGIC)
            send_msg(sub.sock, {"tag": sbw.sign(msg).hex()})
            _until(lambda: any(server._sub_eligible.values()), 10)
        finally:
            sub.close()
            server.close()
