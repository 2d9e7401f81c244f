"""Certified snapshots in the port (A9.5), held against the reference.

The reference's `tests/test_snapshot.py` classes, case for case on the
port's `ledger/snapshot.py`, `PyLedger`, `LedgerServer`, `Standby` and
`ValidatorNode`, each held against the reference on the CPU:

- TestCanonicalState: the state bytes and `state_digest` after the same
  history are the reference's at every phase; torn and trailing bytes
  are refused by both; the async and genome tails decode byte for byte
  and are refused by name where the port's ledger would have to hold
  them.
- TestSnapshotOp: the snapshot op and the chain head after it are the
  reference's; a replica re-derives the digest and refuses a lying one.
- TestGcAndRestore: GC keeps the chain verifiable; the `BFLCWAL2` file
  after `gc_prefix` and `compact_wal` is the reference's byte for byte
  and each package replays the other's; a restored replica replays only
  the tail; `clone_prefix` of a compacted ledger.
- TestArtifacts: the artifact file's bytes for the same meta are the
  reference's, each package reads the other's, torn and bit-flipped
  files are refused and the previous one serves, retention.
- TestVerifyMeta: hash checks, generation regression, a stale or forged
  certificate refused, a certificate minted by reference validators
  accepted.
- TestLiveStateSync: a port writer GCs and a late port standby
  state-syncs, GCs behind streamed snapshots and serves the snapshot on
  its read fan-out; `replicate` of either package state-syncs from the
  other's writer; a forged offer never installs;
  `BFLC_SNAPSHOT_LEGACY=1` keeps every snapshot op off the chain (the
  same head as the reference's writer without snapshots).
- Mixed fleets: a reference writer with port validators and a late port
  standby, and the reverse: the late validator installs the snapshot
  through `bft_snapshot`, the standby state-syncs, and all certify the
  same op stream.
- TestChaosDrill: the reference's scene without the chaos monitor
  (`eval/snapshot_drill.py`), with a validator restarted empty and the
  state-synced standby's promotion.
"""

import hashlib
import os
import socket
import struct
import threading
import time
import warnings

import numpy as np
import pytest

from bflc_demo_tpu.comm import bft as ref_bft
from bflc_demo_tpu.comm import failover as ref_fo
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.ledger import clone_prefix as ref_clone_prefix
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger import snapshot as ref_snap
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm import bft as port_bft
from bflc_demo_tpu_torch.comm.failover import Standby
from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                     LedgerServer, replicate)
from bflc_demo_tpu_torch.eval import snapshot_drill
from bflc_demo_tpu_torch.ledger import LedgerStatus, clone_prefix, make_ledger
from bflc_demo_tpu_torch.ledger import snapshot as snap
from bflc_demo_tpu_torch.ledger.base import decode_op
from bflc_demo_tpu_torch.protocol import ProtocolConfig, bft_quorum
from bflc_demo_tpu_torch.utils.serialization import pack_entries

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)
REF_CFG = RefConfig(**PROTO)
ADDRS = [f"0x{i:040x}" for i in range(CFG.client_num)]


def _ledgers():
    # the python ledgers, which compact (the native one never does:
    # tests/test_torch_native_ledger.py), as in the reference's tests
    return (make_ledger(CFG, backend="python"),
            ref_make_ledger(REF_CFG, backend="python"))


def _fill(led):
    for a in ADDRS:
        assert led.register_node(a) == LedgerStatus.OK


def _upload_half(led):
    ep = led.epoch
    committee = led.committee()
    got = 0
    for a in ADDRS:
        if a in committee:
            continue
        h = hashlib.sha256(f"{ep}|{a}".encode()).digest()
        if led.upload_local_update(a, h, 10, 1.0 + 0.5 * got, ep) == \
                LedgerStatus.OK:
            got += 1
        if got >= CFG.needed_update_count:
            break


def _scores(led, only_first=False):
    ep = led.epoch
    for j, a in enumerate(led.committee()):
        assert led.upload_scores(a, ep, [0.5 + 0.1 * j, 0.6, 0.7 - 0.1 * j]) \
            == LedgerStatus.OK
        if only_first:
            return


def _drive_round(led):
    ep = led.epoch
    _upload_half(led)
    _scores(led)
    mh = hashlib.sha256(f"model{ep}".encode()).digest()
    assert led.commit_model(mh, ep) == LedgerStatus.OK


def _with_rounds(n, led=None):
    led = led if led is not None else make_ledger(CFG, backend="python")
    _fill(led)
    for _ in range(n):
        _drive_round(led)
    return led


def _meta(mod, led, model=b"model-blob-bytes"):
    """Emit a snapshot op on `led` with `mod`'s codec; its offer meta."""
    pos, prev, state = led.log_size(), led.log_head(), led.encode_state()
    op = mod.make_snapshot_op(led)
    assert led.apply_op(op) == LedgerStatus.OK
    return {"i": pos, "epoch": led.epoch, "gen": led.generation, "op": op,
            "prev_head": prev, "cert": None, "state": state, "model": model}


# ------------------------------------------------------- canonical state
class TestCanonicalState:
    def test_roundtrip(self):
        led = _with_rounds(1)
        state = led.encode_state()
        d = snap.decode_state(state)
        assert snap.encode_state_dict(d) == state
        assert d["epoch"] == led.epoch and d["reg_order"] == ADDRS

    @pytest.mark.parametrize("phase", ["registration", "uploads",
                                       "pending", "committed", "closed",
                                       "reseated", "promoted"])
    def test_state_bytes_equal_the_references(self, phase):
        states = []
        for led in _ledgers():
            _fill(led)
            if phase != "registration":
                _drive_round(led)
            if phase == "uploads":
                _upload_half(led)
            elif phase == "pending":
                # a committee short of one row: force, then pending
                _upload_half(led)
                _scores(led, only_first=True)
                assert led.force_aggregate() == LedgerStatus.OK
            elif phase == "committed":
                _drive_round(led)
            elif phase == "closed":
                ep = led.epoch
                a = next(a for a in ADDRS if a not in led.committee())
                led.upload_local_update(a, b"\1" * 32, 5, 2.0, ep)
                assert led.close_round() == LedgerStatus.OK
            elif phase == "reseated":
                assert led.reseat_committee(ADDRS[-2:]) == LedgerStatus.OK
            elif phase == "promoted":
                assert led.promote_writer(1, 2) == LedgerStatus.OK
            states.append((led.encode_state(), led.state_digest()))
        assert states[0] == states[1]

    def test_truncated_and_trailing_refuse(self):
        state = _with_rounds(1).encode_state()
        for bad in (state[: len(state) // 2], state + b"\0",
                    b"not-a-state-blob"):
            for mod in (snap, ref_snap):
                with pytest.raises(ValueError):
                    mod.decode_state(bad)

    @pytest.mark.parametrize("tails", [
        dict(async_=True), dict(async_=True, acommits=True),
        dict(genome=True), dict(async_=True, acommits=True, genome=True)])
    def test_unported_tails_decode_and_refuse_by_name(self, tails):
        """Every tail decodes as the reference's; the async tails (A9.6)
        and the genome tail (A9.9) re-encode and install byte for
        byte."""
        d = ref_snap.decode_state(_with_rounds(
            1, ref_make_ledger(REF_CFG, backend="python")).encode_state())
        if tails.get("async_"):
            d["async"] = (7, [(5, ADDRS[1], b"\2" * 32, 10, 1.5, 3, 1)],
                          {5: {ADDRS[0]: 0.25}})
        if tails.get("acommits"):
            d["async_acommits"] = 4
        if tails.get("genome"):
            d["genome"] = (0.5, 3, 2, 0.125)
        blob = ref_snap.encode_state_dict(d)
        assert snap.decode_state(blob) == ref_snap.decode_state(blob)
        assert snap.encode_state_dict(snap.decode_state(blob)) == blob
        extra = (dict(delta_density=0.6, adapt_every=2)
                 if tails.get("genome") else {})
        if tails.get("async_"):
            extra.update(async_buffer=3, async_reseat_every=(
                2 if tails.get("acommits") else 0))
        acfg = ProtocolConfig(**PROTO, **extra)
        led = snap.restore_snapshot(blob, acfg, 20, b"\3" * 32)
        assert led.encode_state() == blob
        if tails.get("async_"):
            assert [e.aseq for e in led.async_buffer_view()] == [5]
        if tails.get("genome"):
            assert (led.effective_density, led.effective_staleness,
                    led.genome_epoch, led.last_disagreement) == \
                (0.5, 3, 2, 0.125)


# ---------------------------------------------------------- snapshot op
class TestSnapshotOp:
    def test_op_and_head_equal_the_references(self):
        out = []
        for led, mod in zip(_ledgers(), (snap, ref_snap)):
            _with_rounds(2, led)
            op = mod.make_snapshot_op(led)
            size = led.log_size()
            assert led.apply_op(op) == LedgerStatus.OK
            assert led.log_size() == size + 1
            ep, digest = snap.parse_snapshot_op(op)
            assert ep == led.epoch and digest == led.state_digest()
            out.append((op, led.log_head()))
        assert out[0] == out[1]
        assert decode_op(out[0][0])["op"] == "snapshot"

    def test_each_replays_the_others_snapshot_op(self):
        port, ref = _ledgers()
        for led in (port, ref):
            _with_rounds(1, led)
        port_op, ref_op = snap.make_snapshot_op(port), \
            ref_snap.make_snapshot_op(ref)
        assert port.apply_op(ref_op) == LedgerStatus.OK
        assert ref.apply_op(port_op) == LedgerStatus.OK
        assert port.log_head() == ref.log_head()

    @pytest.mark.parametrize("lie", ["digest", "epoch", "length"])
    def test_lying_op_refused_by_both(self, lie):
        for led in _ledgers():
            _with_rounds(1, led)
            op = bytearray(snap.make_snapshot_op(led))
            if lie == "digest":
                op[-1] ^= 0xFF
            elif lie == "epoch":
                struct.pack_into("<q", op, 1, led.epoch + 3)
            else:
                op += b"\0"
            size = led.log_size()
            assert led.apply_op(bytes(op)) == LedgerStatus.BAD_ARG
            assert led.log_size() == size

    def test_parse_rejects_garbage(self):
        for mod in (snap, ref_snap):
            assert mod.parse_snapshot_op(b"") is None
            assert mod.parse_snapshot_op(b"\x04" + b"\0" * 40) is None
            assert mod.parse_snapshot_op(bytes([9]) + b"\0" * 39) is None


# ------------------------------------------------------ GC and restore
class TestGcAndRestore:
    def test_gc_prefix_keeps_chain_verifiable(self):
        led = _with_rounds(2)
        meta = _meta(snap, led)
        pos, head, size = meta["i"], led.log_head(), led.log_size()
        assert led.gc_prefix(pos + 1, meta["state"]) == pos + 1
        assert led.log_base == pos + 1 and led.log_size() == size
        assert led.log_head() == head and led.verify_log()
        with pytest.raises(IndexError):
            led.log_op(0)
        with pytest.raises(ValueError):
            led.head_at(pos)
        assert led.head_at(pos + 1) == head
        _drive_round(led)
        assert led.verify_log()

    def test_restored_replicas_replay_only_the_tail_across_packages(self):
        port, ref = _ledgers()
        metas = []
        for led, mod in ((port, snap), (ref, ref_snap)):
            _with_rounds(2, led)
            metas.append(_meta(mod, led))
            _drive_round(led)
        for mod, meta, src, cfg in ((snap, metas[1], ref, CFG),
                                    (ref_snap, metas[0], port, REF_CFG)):
            rep = mod.restore_snapshot(meta["state"], cfg, meta["i"] + 1,
                                       mod.snapshot_base_head(meta))
            assert rep.log_size() == meta["i"] + 1
            for j in range(meta["i"] + 1, src.log_size()):
                assert rep.apply_op(src.log_op(j)) == LedgerStatus.OK
            assert rep.log_head() == src.log_head()
            assert rep.state_digest() == src.state_digest()

    def test_clone_prefix_on_compacted_ledger(self):
        port, ref = _ledgers()
        for led, mod in ((port, snap), (ref, ref_snap)):
            _with_rounds(2, led)
            meta = _meta(mod, led)
            led.gc_prefix(meta["i"] + 1, meta["state"])
            _drive_round(led)
        cl = clone_prefix(port, port.log_size(), CFG)
        ref_cl = ref_clone_prefix(ref, ref.log_size(), REF_CFG)
        assert cl.log_head() == ref_cl.log_head() == port.log_head()
        assert cl.log_base == port.log_base
        with pytest.raises(RuntimeError):
            clone_prefix(port, port.log_base - 1, CFG)

    def test_compacted_wal_equals_the_references(self, tmp_path):
        files = []
        ledgers = _ledgers()
        for led, mod, name in zip(ledgers, (snap, ref_snap),
                                  ("port", "ref")):
            wal = str(tmp_path / f"{name}.wal")
            assert led.attach_wal(wal)
            _with_rounds(2, led)
            full = os.path.getsize(wal)
            meta = _meta(mod, led)
            led.gc_prefix(meta["i"] + 1, meta["state"])    # compacts
            _drive_round(led)
            led.detach_wal()
            assert os.path.getsize(wal) < full
            files.append(wal)
        blobs = [open(f, "rb").read() for f in files]
        assert blobs[0] == blobs[1] and blobs[0].startswith(b"BFLCWAL2")
        # each package replays the other's compacted journal
        for wal, led in zip(files, reversed(_ledgers())):
            led.replay_wal(wal)
            assert led.log_head() == ledgers[0].log_head()
            assert led.log_size() == ledgers[0].log_size()
            assert led.log_base == ledgers[0].log_base
            assert led.state_digest() == ledgers[0].state_digest()

    def test_wal_bytes_bounded_across_rounds(self, tmp_path):
        wal = str(tmp_path / "bounded.wal")
        led = make_ledger(CFG, backend="python")
        assert led.attach_wal(wal)
        _fill(led)
        sizes = []
        for _ in range(8):
            _drive_round(led)
            assert led.apply_op(snap.make_snapshot_op(led)) == \
                LedgerStatus.OK
            led.gc_prefix(led.log_size(), None)
            sizes.append(os.path.getsize(wal))
        assert max(sizes[2:]) - min(sizes[2:]) < 512, sizes
        led.detach_wal()

    def test_torn_wal2_header_refused(self, tmp_path):
        led = _with_rounds(2)
        meta = _meta(snap, led)
        led.gc_prefix(meta["i"] + 1, meta["state"])
        good = str(tmp_path / "good.wal")
        led.save_wal(good)
        blob = open(good, "rb").read()
        torn = str(tmp_path / "torn.wal")
        with open(torn, "wb") as f:
            f.write(blob[:60])
        for fresh in _ledgers():
            with pytest.raises(ValueError, match="compacted-WAL"):
                fresh.replay_wal(torn)
        # a ledger that already holds ops refuses the whole file
        busy = _with_rounds(0)
        with pytest.raises(ValueError, match="fresh ledger"):
            busy.replay_wal(good)


# ------------------------------------------------------------ artifacts
class TestArtifacts:
    def test_artifact_bytes_equal_and_read_across(self, tmp_path):
        meta = _meta(snap, _with_rounds(1))
        p = snap.write_snapshot_file(str(tmp_path / "port"), meta)
        r = ref_snap.write_snapshot_file(str(tmp_path / "ref"), meta)
        assert os.path.basename(p) == os.path.basename(r)
        assert open(p, "rb").read() == open(r, "rb").read()
        for reader, path in ((snap, r), (ref_snap, p)):
            m = reader.read_snapshot_file(path)
            assert bytes(m["state"]) == meta["state"]
            assert bytes(m["model"]) == meta["model"]
            assert m["i"] == meta["i"] and m["epoch"] == meta["epoch"]
        assert not any(n.endswith(".tmp")
                       for n in os.listdir(tmp_path / "port"))

    @pytest.mark.parametrize("corruption", ["truncate", "bitflip-blob",
                                            "bitflip-header"])
    def test_torn_and_corrupt_refuse_and_fall_back(self, tmp_path,
                                                   corruption):
        d = str(tmp_path)
        led = _with_rounds(1)
        good = _meta(snap, led)
        snap.write_snapshot_file(d, good)
        _drive_round(led)
        p = snap.write_snapshot_file(d, _meta(snap, led))
        blob = bytearray(open(p, "rb").read())
        if corruption == "truncate":
            blob = blob[: len(blob) - 9]
        elif corruption == "bitflip-blob":
            blob[-3] ^= 0x40
        else:
            blob[3] ^= 0x01
        with open(p, "wb") as fh:
            fh.write(bytes(blob))
        for mod in (snap, ref_snap):
            with pytest.raises(ValueError):
                mod.read_snapshot_file(p)
            fb = mod.latest_snapshot(d)
            assert fb is not None and fb["i"] == good["i"]

    def test_prune_retention(self, tmp_path):
        d = str(tmp_path)
        led = _with_rounds(1)
        for _ in range(4):
            snap.write_snapshot_file(d, _meta(snap, led))
            _drive_round(led)
        assert len(snap.list_snapshot_files(d)) == 4
        assert ref_snap.list_snapshot_files(d) == snap.list_snapshot_files(d)
        assert snap.prune_snapshots(d, keep=2) == 2
        assert len(snap.list_snapshot_files(d)) == 2

    def test_legacy_switch(self, monkeypatch):
        monkeypatch.delenv("BFLC_SNAPSHOT_LEGACY", raising=False)
        assert not snap.snapshot_legacy()
        monkeypatch.setenv("BFLC_SNAPSHOT_LEGACY", "1")
        assert snap.snapshot_legacy() and ref_snap.snapshot_legacy()


# ----------------------------------------------------------- verify meta
def _validators(mod, n=4, seed=b"snapmeta-v-01", ports=None):
    wallets, keys = mod.provision_validators(n, seed)
    nodes = [mod.ValidatorNode(
        REF_CFG if mod is ref_bft else CFG, w, i, validator_keys=keys,
        require_auth=False, port=(ports or [0] * n)[i])
        for i, w in enumerate(wallets)]
    for v in nodes:
        v.start()
    return nodes, keys


class TestVerifyMeta:
    def test_hash_checks(self):
        meta = _meta(snap, _with_rounds(1), model=None)
        for mod in (snap, ref_snap):
            assert mod.verify_snapshot_meta(meta) == ""
            bad = dict(meta, state=meta["state"][:-1] + b"\xee")
            assert "digest" in mod.verify_snapshot_meta(bad)
            bad = dict(meta, model=b"not the committed model")
            assert "model" in mod.verify_snapshot_meta(bad)
            assert "malformed" in mod.verify_snapshot_meta({"i": "x"})

    def test_generation_regression_refused(self):
        meta = _meta(snap, _with_rounds(1), model=None)
        assert "backwards" in snap.verify_snapshot_meta(meta,
                                                        min_generation=5)

    @pytest.mark.parametrize("minter", ["port", "reference"])
    def test_stale_or_forged_certificate_refused(self, minter):
        mod = port_bft if minter == "port" else ref_bft
        nodes, vkeys = _validators(mod)
        try:
            led = _with_rounds(0)
            asm = mod.CertificateAssembler(
                [(v.host, v.port) for v in nodes], vkeys, bft_quorum(4),
                backlog_fn=lambda j: (led.log_op(j), None))
            prev = b"\0" * 32
            for j in range(led.log_size()):
                assert asm.certify(j, led.log_op(j), None, prev) is not None
                prev = port_bft.next_head(prev, led.log_op(j))
            meta = _meta(snap, led, model=None)
            cert = asm.certify(meta["i"], meta["op"], None,
                               meta["prev_head"])
            asm.close()
            assert cert is not None
            meta["cert"] = cert.to_wire()
            q = bft_quorum(4)
            for verify in (snap.verify_snapshot_meta,
                           ref_snap.verify_snapshot_meta):
                assert verify(meta, bft_quorum=q, bft_keys=vkeys) == ""
                assert "certificate" in verify(dict(meta, cert=None),
                                               bft_quorum=q, bft_keys=vkeys)
                assert "quorum-bind" in verify(dict(meta, i=meta["i"] + 7),
                                               bft_quorum=q, bft_keys=vkeys)
                assert "quorum-bind" in verify(
                    dict(meta, cert=dict(meta["cert"], t=9)),
                    bft_quorum=q, bft_keys=vkeys)
        finally:
            for v in nodes:
                v.close()


# ----------------------------------------------------- live state-sync
def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _socket_round(c):
    ep = c.request("info")["epoch"]
    committee = c.request("committee")["committee"]
    got = 0
    for i, a in enumerate(a for a in ADDRS if a not in committee):
        blob = pack_entries({"['W']": np.full((5, 2), i + ep + 1.0,
                                              np.float32),
                             "['b']": np.zeros((2,), np.float32)})
        if c.request("upload", addr=a, blob=blob,
                     hash=hashlib.sha256(blob).hexdigest(), n=10, cost=1.0,
                     epoch=ep).get("ok"):
            got += 1
        if got >= CFG.needed_update_count:
            break
    for a in committee:
        assert c.request("scores", addr=a, epoch=ep,
                         scores=[0.5, 0.55, 0.6])["ok"]


def _await(cond, timeout_s=20.0, step=0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _port_writer(**kw):
    srv = LedgerServer(CFG, _init_blob(), require_auth=False,
                       stall_timeout_s=2.0, device="cpu", **kw)
    srv.start()
    return srv


def _ref_writer(**kw):
    srv = ref_ls.LedgerServer(REF_CFG, _init_blob(), require_auth=False,
                              stall_timeout_s=2.0, ledger_backend="python",
                              **kw)
    srv.start()
    return srv


def _port_standby(endpoint, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # wallet-less standby
        sb = Standby(CFG, [endpoint, ("127.0.0.1", 0)], 1,
                     stall_timeout_s=2.0, device="cpu", **kw)
    sb.endpoints[1] = (sb.host, sb.port)
    threading.Thread(target=sb.run, daemon=True).start()
    return sb


def _ref_standby(endpoint, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sb = ref_fo.Standby(REF_CFG, [endpoint, ("127.0.0.1", 0)], 1,
                            stall_timeout_s=2.0, ledger_backend="python",
                            **kw)
    sb.endpoints[1] = (sb.host, sb.port)
    threading.Thread(target=sb.run, daemon=True).start()
    return sb


class TestLiveStateSync:
    def test_writer_gc_standby_state_sync_and_fanout(self, tmp_path):
        snapdir = str(tmp_path / "snaps")
        srv = _port_writer(snapshot_interval=2, snapshot_dir=snapdir)
        sb = None
        c = CoordinatorClient(srv.host, srv.port)
        try:
            for a in ADDRS:
                assert c.request("register", addr=a)["ok"]
            for _ in range(4):
                _socket_round(c)
            assert _await(lambda: c.request("info")["log_base"] > 0)
            info = c.request("info")
            assert info["snapshot_i"] + 1 <= info["log_size"]
            r = c.request("log_range", start=0, end=4)
            assert r.get("error") == "PREFIX_GC" and r["base"] > 0
            assert snap.list_snapshot_files(snapdir)
            assert not any(n.endswith(".tmp") for n in os.listdir(snapdir))
            # a subscriber asking from below the base: the state_sync frame
            sub = CoordinatorClient(srv.host, srv.port, timeout_s=5.0)
            from bflc_demo_tpu_torch.comm.wire import recv_msg, send_msg
            send_msg(sub.sock, {"method": "subscribe", "from": 0})
            assert recv_msg(sub.sock) == {"state_sync": 1,
                                          "base": info["log_base"]}
            sub.close()

            sb = _port_standby((srv.host, srv.port), snapshot_interval=2)
            assert _await(lambda: sb.ledger.log_size() >= info["log_size"])
            assert sb.ledger.log_base > 0 and sb.state_syncs
            assert sb.ledger.log_head().hex() == \
                c.request("info")["log_head"] or \
                sb.ledger.log_size() > info["log_size"]
            assert sb._model_blob is not None
            base0 = sb.ledger.log_base
            for _ in range(2):
                _socket_round(c)
            assert _await(lambda: sb.ledger.log_base > base0)
            assert sb.gc_log and sb._latest_snapshot is not None
            rc = CoordinatorClient(*sb.read_server.endpoint)
            try:
                r = rc.request("snapshot")
                assert r["ok"] and r["i"] == sb._latest_snapshot["i"]
                r2 = rc.request("snapshot", want_i=r["i"] + 1)
                assert not r2["ok"] and r2.get("status") == "STALE"
            finally:
                rc.close()
            # an ack straddling the base: the standby's acks are chain
            # positions, and the quorum wait counts them past the GC
            k = c.request("kernels")
            assert k["stream_acked"] >= k["log_base"] - 1
        finally:
            if sb is not None:
                sb.stop()
            c.close()
            srv.close()

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_replicate_state_syncs_across_packages(self, writer):
        srv = (_port_writer if writer == "port" else _ref_writer)(
            snapshot_interval=1)
        c = CoordinatorClient(srv.host, srv.port)
        try:
            for a in ADDRS:
                assert c.request("register", addr=a)["ok"]
            for _ in range(3):
                _socket_round(c)
            assert _await(lambda: c.request("info")["log_base"] > 0)
            info = c.request("info")
            rep = replicate(srv.host, srv.port, CFG,
                            until_ops=info["log_size"], timeout_s=30.0)
            ref_rep = ref_ls.replicate(srv.host, srv.port, REF_CFG,
                                       ledger_backend="python",
                                       until_ops=info["log_size"],
                                       timeout_s=30.0)
            for r in (rep, ref_rep):
                assert r.log_base > 0
                assert r.log_head().hex() == info["log_head"]
        finally:
            c.close()
            srv.close()

    @pytest.mark.parametrize("standby", ["port", "reference"])
    def test_quorum_ack_with_a_state_synced_standby(self, standby):
        """Quorum-ack over a compacted chain: the follower's acks are
        positions past the GC base and still satisfy the quorum wait."""
        srv = _port_writer(snapshot_interval=1, quorum=1)
        c = CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
        sb = None
        try:
            sb = (_port_standby if standby == "port" else _ref_standby)(
                (srv.host, srv.port), snapshot_interval=1)
            for a in ADDRS:
                assert c.request("register", addr=a)["ok"]
            for _ in range(3):
                _socket_round(c)
            assert _await(lambda: c.request("info")["log_base"] > 0)
            _socket_round(c)             # every ack now past the base
            k = c.request("kernels")
            assert k["stream_acked"] >= k["log_base"]
            assert sb.ledger.log_base > 0
        finally:
            if sb is not None:
                sb.stop()
            c.close()
            srv.close()

    def test_forged_offer_never_installs(self):
        assert snapshot_drill.forged_offer_refused("cpu")

    def test_legacy_pins_snapshots_off(self, monkeypatch):
        heads = {}
        for mode in ("legacy", "interval0", "reference"):
            if mode == "legacy":
                monkeypatch.setenv("BFLC_SNAPSHOT_LEGACY", "1")
                srv = _port_writer(snapshot_interval=2)
            elif mode == "interval0":
                monkeypatch.delenv("BFLC_SNAPSHOT_LEGACY", raising=False)
                srv = _port_writer(snapshot_interval=0)
            else:
                srv = _ref_writer()
            c = CoordinatorClient(srv.host, srv.port)
            try:
                for a in ADDRS:
                    assert c.request("register", addr=a)["ok"]
                for _ in range(2):
                    _socket_round(c)
                time.sleep(1.2)          # the monitor loop had its chance
                info = c.request("info")
                assert info.get("log_base", 0) == 0
                assert "snapshot_epoch" not in info
                ops = c.request("log_range", start=0,
                                end=info["log_size"])["ops"]
                assert all(bytes.fromhex(o)[0] != 9 for o in ops)
                heads[mode] = info["log_head"]
            finally:
                c.close()
                srv.close()
        assert heads["legacy"] == heads["interval0"] == heads["reference"]


# ------------------------------------------------------------ mixed fleets
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("writer,others", [("reference", "port"),
                                           ("port", "reference")])
def test_mixed_fleet_state_syncs_a_standby_and_a_validator(writer, others):
    """A writer of one package with four validators of the other, one of
    them down until the writer has GC'd; then it and a late standby of
    the other package join past the GC base: the validator installs the
    snapshot through `bft_snapshot`, the standby state-syncs, and all
    certify the same op stream."""
    vmod = port_bft if others == "port" else ref_bft
    late = _free_port()
    wallets, vkeys = vmod.provision_validators(4, b"snap-mixed-v-01")
    cfg = CFG if others == "port" else REF_CFG
    nodes = [vmod.ValidatorNode(cfg, w, i, validator_keys=vkeys,
                                require_auth=False)
             for i, w in enumerate(wallets[:3])]
    for v in nodes:
        v.start()
    eps = [(v.host, v.port) for v in nodes] + [("127.0.0.1", late)]
    mk = _port_writer if writer == "port" else _ref_writer
    srv = mk(snapshot_interval=1, bft_validators=eps, bft_keys=vkeys)
    c = CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
    sb = None
    try:
        for a in ADDRS:
            assert c.request("register", addr=a)["ok"]
        for _ in range(3):
            _socket_round(c)
        assert _await(lambda: c.request("info")["log_base"] > 0)
        # the late validator, empty, on the port the writer dials
        node = vmod.ValidatorNode(cfg, wallets[3], 3, port=late,
                                  validator_keys=vkeys, require_auth=False)
        node.start()
        nodes.append(node)
        sb = (_port_standby if others == "port" else _ref_standby)(
            (srv.host, srv.port), snapshot_interval=1,
            bft_validators=eps, bft_keys=vkeys)
        _socket_round(c)
        assert _await(lambda: (lambda i: i["certified_size"]
                               == i["log_size"])(c.request("info")))
        info = c.request("info")
        assert _await(lambda: node._head_base > 0
                      and node.ledger.log_size() == info["log_size"])
        assert _await(lambda: sb.ledger.log_size() == info["log_size"])
        heads = {v.ledger.log_head().hex() for v in nodes}
        assert heads == {info["log_head"]}
        assert sb.ledger.log_head().hex() == info["log_head"]
        assert sb.ledger.log_base > 0
    finally:
        if sb is not None:
            sb.stop()
        c.close()
        srv.close()
        for v in nodes:
            v.close()


# -------------------------------------------------------------- the drill
class TestChaosDrill:
    def test_sigkill_standby_gc_rejoin_state_sync(self, tmp_path):
        acc = snapshot_drill.run_snapshot_rejoin("cpu", str(tmp_path))
        assert acc["state_sync_s"] and acc["validator_installs"]
        assert acc["promoted_started_log_base"] > 0
        assert acc["model_bytes_equal_plain"]
        assert acc["writer_wal_magic"] == "BFLCWAL2"
        assert acc["forged_offer_refused"]
