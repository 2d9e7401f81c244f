"""Asynchronous buffered aggregation (FedBuff) in the port, against the
reference, on the CPU.

- The reference's `tests/test_async.py` classes case for case on the
  port: `TestSyncPathPinned` (its golden head and state digests, the
  sync ledger refusing opcodes 10-12, `BFLC_ASYNC_LEGACY`, the buffer
  bound), `TestAsyncLedger` and `TestAsyncService` (the writer with 4
  validators in threads).
- Across the packages, byte for byte: the opcode 10/11/12 encoders and
  `ascores_sign_payload`, `decode_op` of every async op, and a seeded
  async op script (uploads at random base epochs, score pairs, drains of
  random size) replayed through a port and a reference ledger in both
  directions at blocks 1 and 8 and reseat 0 and 2: the same status of
  every op, heads, canonical state bytes (the async and acommit tails),
  selections, weights and seatings.
- One signed async stream (3 drains, a stale upload, a reseat at drain
  2, blocks 2) through a writer of either package, with validators of
  either package (a 2+2 mixed quorum included) and a client of either
  package: every run ends at one chain head and one model hash, so the
  port writer's drained bytes (B5's plain version under
  `BFLC_MESH_AGG_MIN=1`) are the reference writer's.
- In threads: a standby mirrors the buffer's blobs and serves them from
  its read fan-out, then promotes and drains the buffer it inherited to
  a never-failed writer's model bytes; and C11, an ack whose snapshot GC
  overtook the certify loop still carries its op's certificate.
- Port client processes against the reference's writer, and the CPU
  process drill at the reference drill's protocol with `async_buffer=3`:
  the primary SIGKILLed at epoch 2 of 4, the promoted standby drains,
  the replica reaches its head.
- The CLI parses `--async-buffer` as the reference does and refuses it
  off the processes runtime.
"""

import dataclasses
import hashlib
import multiprocessing as mp
import struct
import threading
import time

import numpy as np
import pytest

from bflc_demo_tpu.comm import bft as ref_bft
from bflc_demo_tpu.comm import failover as ref_fo
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.ledger import base as ref_base
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger.pyledger import PyLedger as RefPyLedger
from bflc_demo_tpu.ledger.tool import decode_op as ref_decode_op
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import flags as ref_flags
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.comm.bft import (ValidatorClient, ValidatorNode,
                                          provision_validators)
from bflc_demo_tpu_torch.comm.failover import FailoverClient
from bflc_demo_tpu_torch.comm.identity import _op_bytes, provision_wallets
from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                     LedgerServer)
from bflc_demo_tpu_torch.comm.wire import blob_bytes
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.ledger import (LedgerStatus, async_enabled,
                                        make_ledger)
from bflc_demo_tpu_torch.ledger.base import (ascores_sign_payload,
                                             decode_op, encode_ascores_op,
                                             encode_aupload_op,
                                             staleness_weight)
from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
from bflc_demo_tpu_torch.ledger.snapshot import decode_state
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import (pack_entries,
                                                     pack_pytree)

ACFG = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                      needed_update_count=3, learning_rate=0.05,
                      batch_size=16, async_buffer=3,
                      max_staleness=2).validate()


def _sync_scripted_ledger() -> PyLedger:
    """The scripted sync round the reference's byte pin hashes."""
    led = PyLedger(6, 2, 2, 3, -999)
    addrs = [f"addr-{i:02d}" for i in range(6)]
    for a in addrs:
        assert led.register_node(a) == LedgerStatus.OK
    committee = led.committee()
    trainers = [a for a in addrs if a not in committee]
    for j, a in enumerate(trainers[:3]):
        h = hashlib.sha256(a.encode()).digest()
        assert led.upload_local_update(a, h, 10 + j, 0.5 + j,
                                       0) == LedgerStatus.OK
    for a in committee:
        assert led.upload_scores(a, 0, [0.1, 0.9, 0.4]) == LedgerStatus.OK
    assert led.commit_model(b"\x42" * 32, 0) == LedgerStatus.OK
    return led


def _async_ledger(cfg=ACFG):
    led = make_ledger(cfg)
    for i in range(cfg.client_num):
        assert led.register_node(f"c{i}") == LedgerStatus.OK
    committee = led.committee()
    trainers = [f"c{i}" for i in range(cfg.client_num)
                if f"c{i}" not in committee]
    return led, committee, trainers


class TestSyncPathPinned:
    """`async_buffer=0` (the default) keeps the synchronous protocol byte
    for byte: chain bytes, state bytes and op admissibility."""

    # the reference's digests (tests/test_async.py), captured before async
    GOLDEN_HEAD = ("14656aaf3dd7a54729706d2e84bd0cd3"
                   "257235d2f628cfeafdad3a970fb14bc9")
    GOLDEN_STATE = ("dfdd082f6fe7ccb00e8182858815cb54"
                    "6e72d64b468ff24d076a03d6e53c8b9d")

    def test_sync_chain_and_state_bytes_unchanged(self):
        led = _sync_scripted_ledger()
        assert led.log_head().hex() == self.GOLDEN_HEAD
        assert hashlib.sha256(
            led.encode_state()).hexdigest() == self.GOLDEN_STATE

    def test_sync_ledger_refuses_the_async_op_family(self):
        led = _sync_scripted_ledger()
        assert led.async_upload("addr-00", b"\0" * 32, 5, 0.1,
                                0) == LedgerStatus.BAD_ARG
        assert led.apply_op(encode_aupload_op(
            "addr-00", b"\0" * 32, 5, 0.1, 0)) == LedgerStatus.BAD_ARG
        assert led.apply_op(encode_ascores_op(
            "addr-00", [(0, 0.5)])) == LedgerStatus.BAD_ARG
        assert decode_state(led.encode_state())["async"] is None

    def test_async_legacy_env_pins_sync(self, monkeypatch):
        monkeypatch.setenv("BFLC_ASYNC_LEGACY", "1")
        assert not async_enabled(ACFG)
        # either backend may serve the pinned sync chain (auto: native,
        # as in the reference); neither runs the async op family
        assert make_ledger(ACFG).backend == "native"
        led = make_ledger(ACFG, backend="python")
        assert led.async_buffer == 0
        # the pinned chain is the sync chain: the golden script's bytes
        for i in range(6):
            led.register_node(f"addr-{i:02d}")
        assert led.log_head() == _sync_scripted_ledger().head_at(6)

    def test_native_backend_refused_for_async(self):
        with pytest.raises(ValueError, match="python ledger backend"):
            make_ledger(ACFG, backend="native")

    def test_async_buffer_must_fit_trainer_population(self):
        for cfg in (ProtocolConfig, RefConfig):
            base = cfg(**{f: getattr(ACFG, f) for f in (
                "client_num", "comm_count", "aggregate_count",
                "needed_update_count", "async_buffer", "max_staleness")})
            with pytest.raises(ValueError, match="trainer population"):
                dataclasses.replace(base, async_buffer=5).validate()
            with pytest.raises(ValueError, match="must be >= 0"):
                dataclasses.replace(base, max_staleness=-1).validate()


class TestAsyncLedger:
    def test_admission_staleness_dup_cap_and_commit(self):
        led, committee, trainers = _async_ledger()
        for j, s in enumerate(trainers[:3]):
            assert led.async_upload(
                s, hashlib.sha256(s.encode()).digest(), 10 + j,
                1.0 + j, 0) == LedgerStatus.OK
        assert led.async_buffer_depth == 3
        assert led.async_upload(trainers[0], b"\1" * 32, 5, 0.1,
                                0) == LedgerStatus.DUPLICATE
        assert led.async_upload(trainers[3], b"\2" * 32, 5, 0.1,
                                0) == LedgerStatus.CAP_REACHED
        assert led.async_scores(trainers[0],
                                [(0, 0.5)]) == LedgerStatus.NOT_COMMITTEE
        assert led.async_scores(committee[0],
                                [(99, 0.5)]) == LedgerStatus.NOT_READY
        assert led.async_scores(
            committee[0], [(0, 0.2), (1, 0.9), (2, 0.5)]) == LedgerStatus.OK
        entries, selected, weights, loss = led.async_selection(3)
        assert selected == [1, 2]
        assert weights == [10.0, 11.0, 12.0]    # staleness 0: raw n
        assert led.async_commit(b"\x13" * 32, 0, 3) == LedgerStatus.OK
        assert led.epoch == 1 and led.async_buffer_depth == 0
        assert led.last_global_loss == pytest.approx(
            (11 * 2.0 + 12 * 3.0) / 23, rel=1e-5)

    def test_staleness_stamp_discount_and_cap(self):
        led, committee, trainers = _async_ledger()
        for epoch in range(3):
            assert led.async_upload(trainers[0], bytes([epoch]) * 32, 10,
                                    1.0, epoch) == LedgerStatus.OK
            assert led.async_commit(bytes([epoch]) * 32, epoch,
                                    1) == LedgerStatus.OK
        assert led.epoch == 3
        assert led.async_upload(trainers[1], b"\7" * 32, 8, 1.0,
                                1) == LedgerStatus.OK
        e = led.async_buffer_view()[-1]
        assert e.staleness == 2 and e.base_epoch == 1
        _, _, weights, _ = led.async_selection(1)
        assert weights[0] == pytest.approx(8 * staleness_weight(2))
        assert led.effective_staleness == ACFG.max_staleness
        assert led.async_upload(trainers[2], b"\x08" * 32, 8, 1.0,
                                0) == LedgerStatus.WRONG_EPOCH
        assert led.async_upload(trainers[2], b"\x08" * 32, 8, 1.0,
                                7) == LedgerStatus.BAD_ARG

    def test_replica_replay_reproduces_head_and_state(self):
        led, committee, trainers = _async_ledger()
        for j, s in enumerate(trainers[:3]):
            led.async_upload(s, hashlib.sha256(s.encode()).digest(),
                             10 + j, 1.0, 0)
        led.async_scores(committee[0], [(0, 0.3), (2, 0.8)])
        led.async_commit(b"\x21" * 32, 0, 2)
        replica = make_ledger(ACFG)
        for i in range(led.log_size()):
            assert replica.apply_op(led.log_op(i)) == LedgerStatus.OK
        assert replica.log_head() == led.log_head()
        assert replica.state_digest() == led.state_digest()
        assert replica.async_buffer_depth == 1

    def test_validate_op_leaves_async_state_untouched(self):
        led, committee, trainers = _async_ledger()
        led.async_upload(trainers[0], b"\3" * 32, 10, 1.0, 0)
        op = encode_aupload_op(trainers[1], b"\4" * 32, 5, 0.5, 0)
        before = led.state_digest()
        assert led.validate_op(op) == LedgerStatus.OK
        assert led.state_digest() == before
        assert led.async_buffer_depth == 1

    def test_state_roundtrip_with_buffered_entries(self):
        from bflc_demo_tpu_torch.ledger.snapshot import restore_snapshot
        led, committee, trainers = _async_ledger()
        led.async_upload(trainers[0], b"\5" * 32, 10, 1.5, 0)
        led.async_scores(committee[1], [(0, 0.7)])
        blob = led.encode_state()
        r = restore_snapshot(blob, ACFG, led.log_size(), led.log_head())
        assert r.state_digest() == led.state_digest()
        assert r.async_buffer_depth == 1
        assert r.async_upload(trainers[1], b"\6" * 32, 5, 0.5,
                              0) == LedgerStatus.OK

    def test_acommit_epoch_and_k_guards(self):
        led, committee, trainers = _async_ledger()
        assert led.async_commit(b"\0" * 32, 0, 1) == LedgerStatus.NOT_READY
        led.async_upload(trainers[0], b"\1" * 32, 5, 0.5, 0)
        assert led.async_commit(b"\0" * 32, 5,
                                1) == LedgerStatus.WRONG_EPOCH
        assert led.async_commit(b"\0" * 32, 0, 2) == LedgerStatus.NOT_READY


# ------------------------------------------------------ across packages
def test_async_encoders_and_sign_payload_equal_the_references():
    rng = np.random.default_rng(11)
    for _ in range(20):
        sender = "0x" + rng.bytes(20).hex()
        ph = rng.bytes(32)
        n, cost = int(rng.integers(1, 1 << 40)), float(rng.normal())
        base = int(rng.integers(0, 1 << 30))
        assert encode_aupload_op(sender, ph, n, cost, base) == \
            ref_base.encode_aupload_op(sender, ph, n, cost, base)
        pairs = [(int(rng.integers(0, 1 << 40)), float(rng.normal() * 1e3))
                 for _ in range(int(rng.integers(1, 6)))]
        assert encode_ascores_op(sender, pairs) == \
            ref_base.encode_ascores_op(sender, pairs)
        assert ascores_sign_payload(pairs) == \
            ref_base.ascores_sign_payload(pairs)


def _scripted(cls, blocks, reseat, seed, steps=240):
    """A seeded async op script on a ledger of `cls`: uploads at random
    base epochs in and past the staleness window, random score pairs
    (drained and live entries, non-committee senders) and drains of
    random size, with each call's status, selection and seating."""
    rng = np.random.default_rng(seed)
    led = cls(8, 2, 2, 3, async_buffer=4, max_staleness=3,
              async_reseat_every=reseat, reduce_blocks=blocks)
    trace = [int(led.register_node(f"c{i}")) for i in range(8)]
    for _ in range(steps):
        r, ep = rng.random(), led.epoch
        if r < 0.5:
            trace.append(int(led.async_upload(
                f"c{rng.integers(8)}", rng.bytes(32),
                int(rng.integers(1, 50)), float(rng.random()),
                int(rng.integers(max(0, ep - 5), ep + 1)))))
        elif r < 0.8:
            live = [e.aseq for e in led.async_buffer_view()]
            pairs = [(a, float(rng.standard_normal())) for a in live
                     if rng.random() < 0.7] or [(0, 1.0)]
            trace.append(int(led.async_scores(f"c{rng.integers(8)}",
                                              pairs)))
        elif led.async_buffer_depth:
            k = int(rng.integers(1, led.async_buffer_depth + 1))
            entries, sel, weights, loss = led.async_selection(k)
            trace.append(([e.aseq for e in entries], sel, weights, loss,
                          led.async_reseat_due(),
                          led.derive_async_seats(k)))
            trace.append(int(led.async_commit(rng.bytes(32), ep, k)))
    return led, trace


@pytest.mark.parametrize("blocks,reseat", [(1, 0), (1, 2), (8, 0), (8, 2)])
def test_async_op_script_replays_across_packages(blocks, reseat):
    port, ptrace = _scripted(PyLedger, blocks, reseat, seed=blocks + reseat)
    ref, rtrace = _scripted(RefPyLedger, blocks, reseat,
                            seed=blocks + reseat)
    assert ptrace == rtrace
    assert port.log_head() == ref.log_head()
    assert port.encode_state() == ref.encode_state()
    ops = [port.log_op(i) for i in range(port.log_size())]
    assert ops == [ref.log_op(i) for i in range(ref.log_size())]
    codes = {op[0] for op in ops}
    assert {10, 11, 12} <= codes
    acommits = [op for op in ops if op[0] == 12]
    assert any(b"BLK1" in op for op in acommits) == (blocks > 1)
    assert any(len(op) > 49 + (12 if blocks > 1 else 0)
               for op in acommits) == (reseat > 0)
    for op in ops:
        assert decode_op(op) == ref_decode_op(op)
    # replay in both directions: each package's replica takes the other's
    # chain to the same head and state
    kw = dict(async_buffer=4, max_staleness=3, async_reseat_every=reseat,
              reduce_blocks=blocks)
    for src, cls in ((port, RefPyLedger), (ref, PyLedger)):
        replica = cls(8, 2, 2, 3, **kw)
        for op in ops:
            assert replica.apply_op(op) == LedgerStatus.OK
        assert replica.log_head() == src.log_head()
        assert replica.encode_state() == src.encode_state()
        assert replica.committee() == src.committee()


# ------------------------------------------- one signed async stream
SCFG = dict(client_num=8, comm_count=2, aggregate_count=2,
            needed_update_count=4, learning_rate=0.05, batch_size=16,
            async_buffer=3, max_staleness=4, async_reseat_every=2,
            reduce_blocks=2)


def _model_blob():
    return pack_entries({"['W']": np.full((5, 2), 0.5, np.float32),
                         "['b']": np.full((2,), -0.25, np.float32)})


def _delta(seed):
    rng = np.random.default_rng(seed)
    return pack_entries({
        "['W']": rng.standard_normal((5, 2)).astype(np.float32),
        "['b']": rng.standard_normal((2,)).astype(np.float32)})


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


def _aupload(cl, w, seed, base):
    blob = _delta(seed)
    d = hashlib.sha256(blob).digest()
    n, cost = 10 + seed, 0.5 + 0.125 * seed
    return cl.request("aupload", addr=w.address, blob=blob, hash=d.hex(),
                      n=n, cost=cost, base_epoch=base,
                      tag=_sign(w, "aupload", base,
                                d + struct.pack("<qd", n, cost)))


def _ascores(cl, w, pairs):
    return cl.request("ascores", addr=w.address,
                      pairs=[[a, s] for a, s in pairs],
                      tag=w.sign(_op_bytes("ascores", w.address, 0,
                                           ascores_sign_payload(pairs))).hex())


def _validators(kinds, seed):
    vws, vkeys = provision_validators(len(kinds), seed)
    rws, _ = ref_bft.provision_validators(len(kinds), seed)
    cfg, rcfg = ProtocolConfig(**SCFG), RefConfig(**SCFG)
    nodes = [ValidatorNode(cfg, vws[i], i, validator_keys=vkeys)
             if kind == "port" else
             ref_bft.ValidatorNode(rcfg, rws[i], i, validator_keys=vkeys)
             for i, kind in enumerate(kinds)]
    for v in nodes:
        v.start()
    return nodes, [(v.host, v.port) for v in nodes], vkeys


def _stream(writer, kinds=(), client="port", seed=b"async-stream-01"):
    """Register 8 wallets, then 3 drains of 3 signed auploads each (one
    at a stale base), every live entry scored by the committee before
    the drain's last upload; returns the writer's info and model hash,
    the validators' heads and the writer's merge legs."""
    wallets, directory = provision_wallets(8, seed)
    nodes, eps, vkeys = _validators(list(kinds), seed) if kinds else \
        ([], None, None)
    bft = dict(bft_validators=eps, bft_keys=vkeys, bft_timeout_s=8.0) \
        if kinds else {}
    if writer == "port":
        srv = LedgerServer(ProtocolConfig(**SCFG), _model_blob(),
                           directory=directory, stall_timeout_s=120.0,
                           device="cpu", **bft)
    else:
        from bflc_demo_tpu.comm.identity import \
            provision_wallets as ref_provision_wallets
        srv = ref_ls.LedgerServer(
            RefConfig(**SCFG), _model_blob(),
            directory=ref_provision_wallets(8, seed)[1],
            stall_timeout_s=120.0, ledger_backend="python", **bft)
    srv.start()
    Client = FailoverClient if client == "port" else ref_fo.FailoverClient
    cl = Client([(srv.host, srv.port)], timeout_s=20.0, bft_keys=vkeys)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        by_addr = {w.address: w for w in wallets}
        for drain in range(3):
            ep = cl.request("info")["epoch"]
            committee = cl.request("committee")["committee"]
            trainers = [w for w in wallets if w.address not in committee]
            for j in range(3):
                w = trainers[(drain + j) % len(trainers)]
                base = ep - 1 if drain and j == 0 else ep
                if j == 2:
                    au = cl.request("aupdates")["updates"]
                    for c, addr in enumerate(committee):
                        pairs = [(u["aseq"], 0.25 * (c + 1) + 0.5 * k)
                                 for k, u in enumerate(au)]
                        assert _ascores(cl, by_addr[addr], pairs)["ok"]
                r = _aupload(cl, w, 10 * drain + j, base)
                assert r["ok"], r
            assert r["epoch"] == ep + 1, r      # the drain rode the ack
        info = cl.request("info")
        model = cl.request("model", meta=1)
        legs = ([m["leg"] for m in srv.merge_log] if writer == "port"
                else None)
        return (info, model.get("hash"), [v.ledger.log_head().hex()
                                          for v in nodes], legs)
    finally:
        cl.close()
        srv.close()
        for v in nodes:
            v.close()


@pytest.fixture
def b5_leg(monkeypatch):
    """Every drain on the engine's kernel leg (B5's plain version here)."""
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")


def test_drained_model_bytes_equal_the_reference_writers(b5_leg):
    port, port_model, _, legs = _stream("port")
    ref, ref_model, _, _ = _stream("ref")
    assert legs == ["blocked"] * 3
    assert port["epoch"] == ref["epoch"] == 3
    assert port["async_buffer_depth"] == ref["async_buffer_depth"] == 0
    assert port_model == ref_model and port_model
    assert (port["log_size"], port["log_head"]) == \
        (ref["log_size"], ref["log_head"])
    assert port["committee"] == ref["committee"]


@pytest.mark.parametrize("writer,kinds,client", [
    ("port", ("port", "ref", "port", "ref"), "ref"),
    ("ref", ("ref", "port", "ref", "port"), "port")])
def test_mixed_quorums_and_clients_certify_one_async_stream(writer, kinds,
                                                            client, b5_leg):
    info, model, heads, _ = _stream(writer, kinds, client)
    plain, plain_model, _, _ = _stream("port")
    assert info["certified_size"] == info["log_size"]
    assert heads == [info["log_head"]] * 4
    assert (info["log_head"], model) == (plain["log_head"], plain_model)


def test_c11_ack_keeps_its_certificate_when_gc_overtakes_the_reply():
    """The monitor's snapshot GC can run between the certify loop and the
    reply's certificate lookup.  The K-th aupload appends its drain and a
    snapshot op in the same request; its ack must still carry the
    aupload's certificate, or a certificate-checking client refuses it
    (fault C11)."""
    seed = b"async-c11-race"
    wallets, directory = provision_wallets(8, seed)
    nodes, eps, vkeys = _validators(["port"] * 4, seed)
    srv = LedgerServer(ProtocolConfig(**SCFG), _model_blob(),
                       directory=directory, stall_timeout_s=120.0,
                       device="cpu", bft_validators=eps, bft_keys=vkeys,
                       bft_timeout_s=8.0, snapshot_interval=1)
    certify = srv._ensure_certified

    def overtaken(upto, timeout_s=None):
        cert = certify(upto, timeout_s)
        srv._maybe_finalize_snapshot()      # the monitor wins the race
        return cert

    srv._ensure_certified = overtaken
    srv.start()
    cl = FailoverClient([(srv.host, srv.port)], timeout_s=20.0,
                        bft_keys=vkeys, max_cycles=1)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        committee = cl.request("committee")["committee"]
        trainers = [w for w in wallets if w.address not in committee]
        for drain in range(2):
            for j in range(3):
                r = _aupload(cl, trainers[j + 3 * drain], 10 * drain + j,
                             drain)
                assert r["ok"] and r["cert"], r
            assert r["epoch"] == drain + 1
        info = cl.request("info")
        assert info["log_base"] > 0
        assert info["certified_size"] == info["log_size"]
    finally:
        cl.close()
        srv.close()
        for v in nodes:
            v.close()


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_promoted_standby_drains_the_buffer_it_inherited(b5_leg):
    """In threads: a standby follows an async writer while two entries
    sit in the buffer, and its read fan-out serves their blobs by hash;
    the writer dies, and the promoted standby's next admission drains
    the inherited buffer on B5's plain version to the model bytes of a
    writer that never died."""
    from bflc_demo_tpu_torch.comm.failover import Standby
    cfg = ProtocolConfig(**SCFG)
    wallets, directory = provision_wallets(8, b"async-promote-01")

    def writer():
        srv = LedgerServer(cfg, _model_blob(), directory=directory,
                           stall_timeout_s=120.0, device="cpu")
        srv.start()
        return srv

    def script(cl, upto):
        committee = cl.request("committee")["committee"]
        trainers = [w for w in wallets if w.address not in committee]
        return [_aupload(cl, trainers[j], j, 0) for j in upto]

    plain = writer()
    cl = FailoverClient([(plain.host, plain.port)], timeout_s=15.0)
    try:
        for w in wallets:
            cl.request("register", addr=w.address,
                       pubkey=w.public_bytes.hex(),
                       tag=_sign(w, "register", 0, b""))
        script(cl, range(3))
        want = cl.request("model", meta=1)["hash"]
    finally:
        cl.close()
        plain.close()

    srv = writer()
    sb = Standby(cfg, [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                 heartbeat_s=0.3, stall_timeout_s=120.0, device="cpu")
    sb.endpoints[1] = (sb.host, sb.port)
    threading.Thread(target=sb.run, daemon=True).start()
    cl = FailoverClient([(srv.host, srv.port), (sb.host, sb.port)],
                        timeout_s=15.0)
    try:
        for w in wallets:
            cl.request("register", addr=w.address,
                       pubkey=w.public_bytes.hex(),
                       tag=_sign(w, "register", 0, b""))
        ups = script(cl, range(2))
        assert all(r["ok"] for r in ups)
        size = cl.request("info")["log_size"]
        deadline = time.monotonic() + 20
        while sb.ledger.log_size() < size:
            assert time.monotonic() < deadline, "standby lagging"
            time.sleep(0.05)
        buffered = [e.payload_hash for e in sb.ledger.async_buffer_view()]
        assert len(buffered) == 2
        rd = CoordinatorClient(*sb.read_server.endpoint)
        try:
            for h in buffered:
                r = rd.request("blob", hash=h.hex())
                assert hashlib.sha256(blob_bytes(r["blob"])).digest() == h
        finally:
            rd.close()
        srv.close()
        assert sb.promoted.wait(timeout=30), "no promotion"
        r = script(cl, [2])[0]
        assert r["ok"] and r["epoch"] == 1, r
        assert cl.request("model", meta=1)["hash"] == want
        assert [m["leg"] for m in sb.server.merge_log] == ["blocked"]
        assert sb.server.merge_log[0]["drained"] == 3
    finally:
        cl.close()
        sb.stop()
        srv.close()


class TestAsyncService:
    """The reference's writer cases over real sockets with 4 port
    validators re-executing the async op family."""

    @pytest.fixture
    def fleet(self):
        cfg = dataclasses.replace(ACFG, client_num=8,
                                  needed_update_count=4,
                                  max_staleness=4).validate()
        wallets, _ = provision_wallets(8, b"async-test-seed")
        vws, vkeys = provision_validators(4, b"async-test-validators")
        nodes = [ValidatorNode(cfg, w, i, validator_keys=vkeys)
                 for i, w in enumerate(vws)]
        for v in nodes:
            v.start()
        blob0 = pack_pytree({"W": np.zeros((5, 2), np.float32),
                             "b": np.zeros((2,), np.float32)})
        srv = LedgerServer(cfg, blob0, device="cpu",
                           bft_validators=[(v.host, v.port) for v in nodes],
                           bft_keys=vkeys)
        srv.start()
        cl = CoordinatorClient(srv.host, srv.port)
        try:
            yield cfg, wallets, srv, cl, nodes
        finally:
            cl.close()
            srv.close()
            for v in nodes:
                v.close()

    def _aupload(self, cl, w, i, base):
        blob = pack_pytree({"W": np.full((5, 2), 0.1 * (i + 1), np.float32),
                            "b": np.zeros((2,), np.float32)})
        d = hashlib.sha256(blob).digest()
        payload = d + struct.pack("<qd", 10 + i, 1.0)
        return cl.request("aupload", addr=w.address, blob=blob,
                          hash=d.hex(), n=10 + i, cost=1.0, base_epoch=base,
                          tag=_sign(w, "aupload", base, payload))

    def _register(self, cl, wallets):
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        committee = set(cl.request("committee")["committee"])
        return ([w for w in wallets if w.address not in committee],
                [w for w in wallets if w.address in committee])

    def test_buffered_round_certifies_and_triggers_at_k(self, fleet):
        cfg, wallets, srv, cl, nodes = fleet
        trainers, comm_ws = self._register(cl, wallets)
        r = self._aupload(cl, trainers[0], 0, 0)
        assert r["ok"] and r.get("cert"), r
        assert self._aupload(cl, trainers[1], 1, 0)["ok"]
        r = self._aupload(cl, trainers[0], 0, 0)
        assert r["status"] == "DUPLICATE", r
        au = cl.request("aupdates")
        assert au["ok"] and len(au["updates"]) == 2
        pairs = [(u["aseq"], 0.5 + 0.1 * i)
                 for i, u in enumerate(au["updates"])]
        assert _ascores(cl, comm_ws[0], pairs)["ok"]
        # a replayed ascores tag: refused across the staleness window
        assert _ascores(cl, comm_ws[0], pairs)["status"] == "DUPLICATE"
        r = self._aupload(cl, trainers[2], 2, 0)
        assert r["ok"] and r["epoch"] == 1, r
        info = cl.request("info")
        assert info["epoch"] == 1
        assert info["certified_size"] == info["log_size"]
        assert info["async_buffer_depth"] == 0
        assert info["eff_staleness"] == cfg.max_staleness
        assert self._aupload(cl, trainers[3], 3, 0)["ok"]
        assert cl.request("aupdates")["updates"][0]["staleness"] == 1
        info = cl.request("info")
        for v in nodes:
            vc = ValidatorClient((v.host, v.port))
            try:
                vinfo = vc.request("info", at=info["log_size"])
            finally:
                vc.close()
            if vinfo.get("log_size") == info["log_size"]:
                assert vinfo["head_at"] == info["log_head"]

    def test_sync_ops_refused_in_async_mode(self, fleet):
        cfg, wallets, srv, cl, nodes = fleet
        w = wallets[0]
        cl.request("register", addr=w.address, pubkey=w.public_bytes.hex(),
                   tag=_sign(w, "register", 0, b""))
        blob = pack_pytree({"W": np.zeros((5, 2), np.float32),
                            "b": np.zeros((2,), np.float32)})
        d = hashlib.sha256(blob).digest()
        r = cl.request("upload", addr=w.address, blob=blob, hash=d.hex(),
                       n=10, cost=1.0, epoch=0,
                       tag=_sign(w, "upload", 0,
                                 d + struct.pack("<qd", 10, 1.0)))
        assert not r["ok"] and "async mode" in r.get("error", ""), r
        r = cl.request("scores", addr=w.address, epoch=0, scores=[0.5],
                       tag="00")
        assert not r["ok"] and "async mode" in r.get("error", ""), r

    def test_forged_ascores_tag_refused(self, fleet):
        cfg, wallets, srv, cl, nodes = fleet
        trainers, comm_ws = self._register(cl, wallets)
        assert self._aupload(cl, trainers[0], 0, 0)["ok"]
        forged = trainers[1].sign(_op_bytes(
            "ascores", comm_ws[0].address, 0,
            ascores_sign_payload([(0, 0.9)]))).hex()
        r = cl.request("ascores", addr=comm_ws[0].address,
                       pairs=[[0, 0.9]], tag=forged)
        assert not r["ok"] and r["status"] == "BAD_ARG"


# ------------------------------------------------------------ processes
FLEET_PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
                   needed_update_count=3, learning_rate=0.05, batch_size=16)


def _shards(rows):
    xtr, ytr, xte, yte = load_occupancy()
    return (iid_shards(xtr[:rows], ytr[:rows], FLEET_PROTO["client_num"]),
            (xte[:500], yte[:500]))


def test_port_clients_against_the_reference_writer():
    cfg = ProtocolConfig(**FLEET_PROTO, async_buffer=3)
    shards, _ = _shards(6 * 250)
    init = pack_pytree(make_softmax_regression().init_params(0))
    srv = ref_ls.LedgerServer(RefConfig(**FLEET_PROTO, async_buffer=3),
                              init, stall_timeout_s=60.0,
                              ledger_backend="python")
    srv.start()
    ctx = mp.get_context("spawn")
    report_q = ctx.Queue()
    procs = [ctx.Process(target=pr._client_proc, args=pr.client_args(
        [(srv.host, srv.port)], b"async-mixed-fleet-01", i,
        "make_softmax_regression", {}, sx, sy, 2, dict(vars(cfg)), 3, None,
        "cpu", report_q), daemon=True) for i, (sx, sy) in enumerate(shards)]
    try:
        for p in procs:
            p.start()
        reports = [report_q.get(timeout=120) for _ in procs]
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        srv.close()
    assert srv.ledger.epoch >= 3
    ops = [srv.ledger.log_op(i) for i in range(srv.ledger.log_size())]
    assert not {2, 3, 4} & {op[0] for op in ops}
    assert {10, 12} <= {op[0] for op in ops}
    replica = make_ledger(cfg)
    for op in ops:
        assert replica.apply_op(op) == LedgerStatus.OK
    assert replica.log_head() == srv.ledger.log_head()
    assert sum(r["trainings"] for r in reports) >= 9
    for rep in reports:
        assert rep["foreign_modules"] == [], rep


def test_async_process_drill_promoted_writer_drains():
    """The reference drill's protocol in async mode: the primary dies at
    epoch 2 of 4 and the promoted standby drains the rest."""
    cfg = ProtocolConfig(**FLEET_PROTO, async_buffer=3)
    shards, test_set = _shards(1500)
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, test_set, cfg, rounds=4,
        standbys=1, kill_writer_at_epoch=2, stall_timeout_s=20.0,
        timeout_s=120.0, replicas=1, device="cpu")
    assert res.rounds_completed >= 4
    fo = res.failover
    assert fo["killed_at_epoch"] >= 2 and fo["writer_index"] == 1
    assert fo["gen"] == 1 and fo["gap_s"] is not None
    assert res.replica_report["ok"]
    assert res.replica_report["head"] == res.ledger_log_head
    after = [m for m in res.writer_merges if m["mono"] > fo["kill_mono"]]
    assert after and all(m["drained"] == 3 for m in after)
    assert all(sum(c["aupload"].values()) == c["trainings"]
               for c in res.client_counts.values())
    for mods in res.child_foreign_modules.values():
        assert mods == []


# ------------------------------------------------------------------ CLI
def test_cli_parses_the_async_flags_as_the_reference():
    from bflc_demo_tpu_torch.__main__ import _parser
    from bflc_demo_tpu_torch.utils import flags
    argv = ["--async-buffer", "10", "--max-staleness", "5",
            "--async-reseat-every", "2"]
    cfg = flags.parse_protocol(_parser().parse_args(argv))
    _, ref_cfg = ref_flags.parse_args(argv)
    for name, value in vars(cfg).items():
        assert getattr(ref_cfg, name) == value, name
    assert (cfg.async_buffer, cfg.max_staleness,
            cfg.async_reseat_every) == (10, 5, 2)


def test_cli_refuses_async_off_the_processes_runtime(capsys, monkeypatch):
    from bflc_demo_tpu_torch.__main__ import main
    assert main(["--device", "cpu", "--async-buffer", "3"]) == 2
    assert "--runtime processes" in capsys.readouterr().err
    monkeypatch.setenv("BFLC_ASYNC_BUFFER", "3")
    assert main(["--device", "cpu", "--runtime", "host"]) == 2


# ------------------------------------------------------------------ C16
def test_c16_a_still_buffered_sender_gets_a_certless_duplicate():
    """C16: the ledger keeps one buffered delta a sender, so a second
    aupload while the first waits in the buffer is answered DUPLICATE,
    and no op of that request reaches the chain, so the ack carries no
    certificate.  A certificate-checking client takes it as "still
    buffered, retry at the next version" and gets the reply; before the
    repair it took the writer for dead and raised.  A DUPLICATE whose
    certificate is present but forged is still refused."""
    vwallets, vkeys = provision_validators(4, b"c16-validators")
    nodes = [ValidatorNode(ACFG, w, i, validator_keys=vkeys)
             for i, w in enumerate(vwallets)]
    for v in nodes:
        v.start()
    server = LedgerServer(ACFG, _model_blob(),
                          bft_validators=[(v.host, v.port) for v in nodes],
                          bft_keys=vkeys, device="cpu")
    server.start()
    wallets, _ = provision_wallets(ACFG.client_num, b"c16-clients")
    cl = FailoverClient([(server.host, server.port)], timeout_s=10.0,
                        max_cycles=1, bft_keys=vkeys)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        w = wallets[0]
        first = _aupload(cl, w, 1, 0)
        assert first["ok"] and first["cert"] is not None
        second = _aupload(cl, w, 2, 0)      # the first is still buffered
        assert second["status"] == "DUPLICATE" and not second["ok"]
        assert second.get("cert") is None
        assert server.ledger.async_buffer_depth == 1
        # a DUPLICATE with a certificate must still verify
        forged = dict(second, cert=dict(first["cert"], sigs={}))
        assert not cl._certified_ack("aupload", {}, forged)
    finally:
        cl.close()
        server.close()
        for v in nodes:
            v.close()
