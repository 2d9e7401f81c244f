"""Sparse and quantized uploads through the port's fleet, against the
reference's, on the CPU.

- The reference's `tests/test_sparse.py` pins on the port's writer: a
  scripted sync round of density-0.05 uploads commits the reference's
  golden model hash on the legacy host loop and on the engine's kernel
  leg (B5's plain version here); density 1.0 commits the dense golden,
  and `BFLC_SPARSE_LEGACY=1` pins the dense chain; a dense fleet refuses
  a sparse blob and an f32 fleet refuses an f16 blob at the door with
  the reference's message; an async FedBuff drain of sparse blobs
  commits the same hash on both legs and on the reference's writer.
- Validators: `check_sparse_upload_op` returns the reference's verdicts
  (well-formed, a malformed `#topk` record, no evidence, forged
  evidence, a non-upload op); a density-armed `ValidatorNode` refuses
  with `SPARSE` before its replica is touched, and a dense one ignores
  the gate.
- One signed stream of each codec setting — sync top-k/i8 with the
  clients' error feedback, and async count-sketch/f16 with a reseat —
  through a writer of either package, with validators of either package
  (2+2 quorums) and clients of either package (each encoding with its
  own package's `_DeltaEncoder`): every run certifies its whole chain
  and ends at the plain port run's head and model hash.
- The snapshot GC and the `BFLCWAL2` journal on a sparse chain: port
  and reference writers driven by the same rounds write the same WAL
  bytes and the same snapshot state, keep each upload's blob evidence
  past its commit, and drop it with the op auth below the GC base.
- Port client processes (top-k/i8, error feedback) against the
  reference's writer, and the port's CPU fleet with 4 validators in the
  async count-sketch/f16 setting of `chip_smoke.py`'s
  `sketch_async_drill`: every op certified, no `SPARSE` refusal, the
  replica at the writer's head.
"""

import dataclasses
import hashlib
import multiprocessing as mp
import os
import struct

import numpy as np
import pytest

from bflc_demo_tpu.client import process_runtime as ref_pr
from bflc_demo_tpu.comm import bft as ref_bft
from bflc_demo_tpu.comm import failover as ref_fo
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.comm.identity import \
    provision_wallets as ref_provision_wallets
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref_ser
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.comm.bft import (ValidatorNode,
                                          check_sparse_upload_op,
                                          provision_validators)
from bflc_demo_tpu_torch.comm.failover import FailoverClient
from bflc_demo_tpu_torch.comm.identity import (Wallet, _op_bytes,
                                               provision_wallets)
from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                     LedgerServer)
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.ledger.base import (ascores_sign_payload,
                                             encode_register_op,
                                             encode_upload_op)
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.codecs import (TOPK_SUFFIX, pack_entries,
                                              pack_pytree, pack_sparse,
                                              unpack_pytree)

# the reference's golden digests (tests/test_sparse.py:44-49)
GOLDEN_SPARSE_MODEL = ("2044a0aa0a2fb09858cd5e8b1b6bf410"
                       "60a84571b7a6cc91c09135e92cf1d8c4")
GOLDEN_DENSE_MODEL = ("1139b686390e0c76c9c2d12173d41669"
                      "594da3550f7b5ffd56a08ce176f33683")


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


def _tree(rng, scale=1.0):
    return {"W1": (rng.standard_normal((24, 16)) * scale
                   ).astype(np.float32),
            "b1": (rng.standard_normal((16,)) * scale).astype(np.float32),
            "W2": (rng.standard_normal((16, 3)) * scale
                   ).astype(np.float32)}


def _flat(tree):
    return {f"['{k}']": v for k, v in tree.items()}


@pytest.fixture
def b5_leg(monkeypatch):
    """Every merge on the engine's kernel leg (B5's plain version)."""
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY", raising=False)
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")


# ------------------------------------------ the reference's pinned round
def _sync_round_model_hash(package, density, legacy_blobs=False,
                           dtype="f32", codec="topk"):
    """The reference's scripted config-1 sync round
    (tests/test_sparse.py:57-108) through a writer of `package`."""
    kw = dict(client_num=20, comm_count=4, aggregate_count=6,
              needed_update_count=10, learning_rate=0.05, batch_size=16,
              delta_density=density, delta_dtype=dtype, delta_codec=codec)
    rng = np.random.default_rng(13)
    blob0 = pack_pytree(_flat(_tree(rng)))
    if package == "port":
        wallets, directory = provision_wallets(20, b"sparse-parity-seed")
        srv = LedgerServer(ProtocolConfig(**kw), blob0, device="cpu")
        Client = CoordinatorClient
    else:
        wallets, directory = ref_provision_wallets(20, b"sparse-parity-seed")
        srv = ref_ls.LedgerServer(RefConfig(**kw), blob0,
                                  ledger_backend="python")
        Client = ref_ls.CoordinatorClient
    srv.start()
    cl = Client(srv.host, srv.port)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        committee = set(cl.request("committee")["committee"])
        trainers = [w for w in wallets if w.address not in committee]
        for i, w in enumerate(trainers[:10]):
            t = _flat(_tree(np.random.default_rng(300 + i), 0.1))
            blob = (pack_pytree(t) if legacy_blobs
                    else pack_sparse(t, density, dtype, codec))
            d = hashlib.sha256(blob).digest()
            payload = d + struct.pack("<qd", 20 + i, 1.0 + 0.05 * i)
            r = cl.request("upload", addr=w.address, blob=blob,
                           hash=d.hex(), n=20 + i, cost=1.0 + 0.05 * i,
                           epoch=0, tag=_sign(w, "upload", 0, payload))
            assert r["ok"], r
        for j, w in enumerate([w for w in wallets
                               if w.address in committee]):
            row = [0.5 + 0.01 * (j + u) for u in range(10)]
            payload = struct.pack("<10d", *row)
            r = cl.request("scores", addr=w.address, epoch=0, scores=row,
                           tag=_sign(w, "scores", 0, payload))
            assert r["ok"] or r.get("status") == "WRONG_EPOCH", r
        assert cl.request("info")["epoch"] == 1
        return cl.request("model")["hash"]
    finally:
        cl.close()
        srv.close()


def test_sparse_round_hash_is_the_references_golden_on_both_legs(
        monkeypatch):
    monkeypatch.setenv("BFLC_MESH_AGG_LEGACY", "1")
    monkeypatch.delenv("BFLC_MESH_AGG_MIN", raising=False)
    legacy = _sync_round_model_hash("port", 0.05)
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    assert legacy == _sync_round_model_hash("port", 0.05) == \
        GOLDEN_SPARSE_MODEL


def test_density_one_and_legacy_pin_are_the_dense_chain(monkeypatch):
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    assert _sync_round_model_hash("port", 1.0) == GOLDEN_DENSE_MODEL
    monkeypatch.setenv("BFLC_SPARSE_LEGACY", "1")
    assert _sync_round_model_hash("port", 0.05, legacy_blobs=True) == \
        GOLDEN_DENSE_MODEL


@pytest.mark.parametrize("dtype,codec,density", [
    ("i8", "topk", 0.01), ("f16", "sketch", 0.1), ("f32", "sketch", 0.05),
    ("i8", "topk", 1.0)])
def test_codec_round_hash_equals_the_reference_writers(b5_leg, dtype,
                                                       codec, density):
    assert _sync_round_model_hash("port", density, dtype=dtype,
                                  codec=codec) == \
        _sync_round_model_hash("ref", density, dtype=dtype, codec=codec)


def test_wrong_layouts_refused_at_the_door_with_the_references_message():
    """A dense fleet refuses a sparse blob (its records are extra keys),
    an f32 fleet an f16 blob (its dtype), as the reference does; an
    i8 fleet admits the quantized blob."""
    g = _flat(_tree(np.random.default_rng(0)))
    blob0 = pack_pytree(g)
    cases = ((ProtocolConfig(), RefConfig(), pack_sparse(g, 0.05), False),
             (ProtocolConfig(), RefConfig(), pack_sparse(g, 1.0, "f16"),
              False),
             (ProtocolConfig(delta_dtype="i8"), RefConfig(delta_dtype="i8"),
              pack_sparse(g, 1.0, "i8"), True),
             (ProtocolConfig(delta_dtype="i8"), RefConfig(delta_dtype="i8"),
              pack_sparse(g, 0.05, "i8"), False))
    for cfg, rcfg, blob, admitted in cases:
        srv = LedgerServer(cfg, blob0, require_auth=False,
                           stall_timeout_s=3600.0, device="cpu")
        rsrv = ref_ls.LedgerServer(rcfg, blob0, require_auth=False,
                                   stall_timeout_s=3600.0,
                                   ledger_backend="python")
        try:
            err, flat = srv._decode_delta(blob)
            rerr, rflat = rsrv._decode_delta(blob)
            assert err == rerr and (err == "") == admitted, (err, rerr)
            assert (flat is None) == (rflat is None) == (not admitted)
            if admitted:
                for k in flat:
                    assert flat[k].tobytes() == rflat[k].tobytes()
        finally:
            srv.close()
            rsrv.close()


def _drain_hash(package, codec="topk", dtype="f32"):
    """The reference's async drain of sparse blobs
    (tests/test_sparse.py:155-234) through a writer of `package`."""
    kw = dict(client_num=8, comm_count=2, aggregate_count=2,
              needed_update_count=4, learning_rate=0.05, batch_size=16,
              async_buffer=4, max_staleness=4, delta_density=0.1,
              delta_codec=codec, delta_dtype=dtype)
    rng = np.random.default_rng(12)
    blob0 = pack_pytree(_flat(_tree(rng)))
    if package == "port":
        wallets, _ = provision_wallets(8, b"sparse-async-parity")
        srv = LedgerServer(ProtocolConfig(**kw), blob0, device="cpu")
        Client = CoordinatorClient
    else:
        wallets, _ = ref_provision_wallets(8, b"sparse-async-parity")
        srv = ref_ls.LedgerServer(RefConfig(**kw), blob0,
                                  ledger_backend="python")
        Client = ref_ls.CoordinatorClient
    srv.start()
    cl = Client(srv.host, srv.port)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        committee = set(cl.request("committee")["committee"])
        trainers = [w for w in wallets if w.address not in committee]
        comm_ws = [w for w in wallets if w.address in committee]

        def aupload(i, w, base):
            blob = pack_sparse(_flat(_tree(np.random.default_rng(400 + i),
                                           0.1)), 0.1, dtype, codec)
            d = hashlib.sha256(blob).digest()
            payload = d + struct.pack("<qd", 10 + i, 1.0)
            return cl.request("aupload", addr=w.address, blob=blob,
                              hash=d.hex(), n=10 + i, cost=1.0,
                              base_epoch=base,
                              tag=_sign(w, "aupload", base, payload))

        for i, w in enumerate(trainers[:3]):
            assert aupload(i, w, 0)["ok"]
        pairs = [(u["aseq"], 0.5 + 0.1 * u["aseq"])
                 for u in cl.request("aupdates")["updates"]]
        w = comm_ws[0]
        assert cl.request("ascores", addr=w.address,
                          pairs=[[a, s] for a, s in pairs],
                          tag=w.sign(_op_bytes(
                              "ascores", w.address, 0,
                              ascores_sign_payload(pairs))).hex())["ok"]
        r = aupload(3, trainers[3], 0)
        assert r["ok"] and r["epoch"] == 1, r
        return cl.request("model")["hash"]
    finally:
        cl.close()
        srv.close()


@pytest.mark.parametrize("codec,dtype", [("topk", "f32"), ("sketch", "f16")])
def test_async_drain_of_sparse_blobs_equals_the_reference_writers(
        monkeypatch, codec, dtype):
    monkeypatch.setenv("BFLC_MESH_AGG_LEGACY", "1")
    monkeypatch.delenv("BFLC_MESH_AGG_MIN", raising=False)
    legacy = _drain_hash("port", codec, dtype)
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    assert legacy == _drain_hash("port", codec, dtype) == \
        _drain_hash("ref", codec, dtype)


# ---------------------------------------------------------- validators
def _op_and_blob(good=True, codec="topk"):
    t = _flat(_tree(np.random.default_rng(5), 0.1))
    flat = unpack_pytree(pack_sparse(t, 0.05, "f32", codec))
    if not good:
        suffix = TOPK_SUFFIX if codec == "topk" else "#sketch"
        key = [k for k in flat if k.endswith(suffix)][0]
        rec = flat[key].copy()
        rec[-1] = 10 ** 7
        flat = dict(flat)
        flat[key] = rec
    blob = pack_entries(flat)
    return encode_upload_op("0xabc", hashlib.sha256(blob).digest(), 10,
                            1.0, 0), blob


@pytest.mark.parametrize("codec", ["topk", "sketch"])
def test_check_sparse_upload_op_verdicts_equal_the_references(codec):
    op, blob = _op_and_blob(True, codec)
    bop, bblob = _op_and_blob(False, codec)
    other = pack_pytree(_flat(_tree(np.random.default_rng(6))))
    cases = [(op, {"blob": blob.hex()}), (bop, {"blob": bblob.hex()}),
             (op, {}), (op, None), (op, {"blob": "zz"}),
             (op, {"blob": other.hex()}), (op[:20], {"blob": blob.hex()}),
             (encode_register_op("0xabc"), {})]
    verdicts = [check_sparse_upload_op(o, a) for o, a in cases]
    assert verdicts == [ref_bft.check_sparse_upload_op(o, a)
                        for o, a in cases]
    assert verdicts[0] == "" and "densify" in verdicts[1]
    assert "without blob evidence" in verdicts[2]
    assert "payload hash" in verdicts[5] and verdicts[7] == ""


def test_validator_refuses_a_malformed_blob_and_a_dense_one_ignores():
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=4, delta_density=0.05)
    node = ValidatorNode(cfg, Wallet.from_seed(b"sparse-vtest"), 0,
                         require_auth=False)
    dense = ValidatorNode(ProtocolConfig(), Wallet.from_seed(b"dense-vt"),
                          0, require_auth=False)
    try:
        op, blob = _op_and_blob(good=False)
        r = node._validate({"i": 0, "op": op.hex(),
                            "auth": {"blob": blob.hex()}})
        assert not r["ok"] and r["status"] == "SPARSE", r
        r2 = node._validate({"i": 0, "op": op.hex()})
        assert not r2["ok"] and r2["status"] == "SPARSE", r2
        assert node.ledger.log_size() == 0
        gop, gblob = _op_and_blob(good=True)
        r3 = node._validate({"i": 0, "op": gop.hex(),
                             "auth": {"blob": gblob.hex()}})
        assert r3.get("status") != "SPARSE", r3
        assert node._sparse and not dense._sparse
        # the dense quorum never decodes the evidence
        r4 = dense._validate({"i": 0, "op": op.hex(),
                              "auth": {"blob": blob.hex()}})
        assert r4.get("status") != "SPARSE", r4
    finally:
        node.close()
        dense.close()


# --------------------------------------------- one signed mixed stream
SETTINGS = {
    "sync_topk_i8": dict(client_num=8, comm_count=2, aggregate_count=2,
                         needed_update_count=4, learning_rate=0.05,
                         batch_size=16, reduce_blocks=2,
                         delta_density=0.05, delta_dtype="i8",
                         delta_codec="topk"),
    "async_sketch_f16": dict(client_num=8, comm_count=2, aggregate_count=2,
                             needed_update_count=4, learning_rate=0.05,
                             batch_size=16, async_buffer=3, max_staleness=4,
                             async_reseat_every=2, reduce_blocks=2,
                             delta_density=0.1, delta_dtype="f16",
                             delta_codec="sketch"),
}


def _validators(kinds, kw, seed):
    vws, vkeys = provision_validators(len(kinds), seed)
    rws, _ = ref_bft.provision_validators(len(kinds), seed)
    nodes = [ValidatorNode(ProtocolConfig(**kw), vws[i], i,
                           validator_keys=vkeys)
             if kind == "port" else
             ref_bft.ValidatorNode(RefConfig(**kw), rws[i], i,
                                   validator_keys=vkeys)
             for i, kind in enumerate(kinds)]
    for v in nodes:
        v.start()
    return nodes, [(v.host, v.port) for v in nodes], vkeys


class _Encoders:
    """One `_DeltaEncoder` a wallet, of the client's package."""

    def __init__(self, client, kw):
        self.client, self.kw, self.encs = client, kw, {}

    def encode(self, addr, seed, base):
        tree = _tree(np.random.default_rng(seed), 0.1)
        if addr not in self.encs:
            self.encs[addr] = (
                pr._DeltaEncoder(ProtocolConfig(**self.kw))
                if self.client == "port" else
                ref_pr._DeltaEncoder(RefConfig(**self.kw),
                                     {k: np.zeros_like(v)
                                      for k, v in tree.items()}))
        enc = self.encs[addr]
        assert enc.armed
        return enc.encode(_flat(tree) if self.client == "port" else tree,
                          base_epoch=base)


def _stream(setting, writer, kinds=(), client="port"):
    """Register 8 wallets, then 3 rounds (sync) or drains (async) of
    signed uploads encoded by the clients' error-feedback encoders;
    returns the writer's info, the model hash, the validators' heads and
    the largest upload blob."""
    kw = SETTINGS[setting]
    seed = b"sparse-stream-" + setting.encode()
    wallets, directory = provision_wallets(8, seed)
    nodes, eps, vkeys = _validators(list(kinds), kw, seed) if kinds else \
        ([], None, None)
    bft = dict(bft_validators=eps, bft_keys=vkeys, bft_timeout_s=8.0) \
        if kinds else {}
    blob0 = pack_pytree(_flat(_tree(np.random.default_rng(1))))
    if writer == "port":
        srv = LedgerServer(ProtocolConfig(**kw), blob0, directory=directory,
                           stall_timeout_s=120.0, device="cpu", **bft)
    else:
        srv = ref_ls.LedgerServer(
            RefConfig(**kw), blob0,
            directory=ref_provision_wallets(8, seed)[1],
            stall_timeout_s=120.0, ledger_backend="python", **bft)
    srv.start()
    Client = FailoverClient if client == "port" else ref_fo.FailoverClient
    cl = Client([(srv.host, srv.port)], timeout_s=20.0, bft_keys=vkeys)
    encs = _Encoders(client, kw)
    sizes = []

    def upload(method, w, seed_, epoch):
        blob = encs.encode(w.address, seed_, epoch)
        sizes.append(len(blob))
        d = hashlib.sha256(blob).digest()
        n, cost = 10 + seed_ % 7, 0.5 + 0.125 * (seed_ % 5)
        base = {"base_epoch": epoch} if method == "aupload" else \
            {"epoch": epoch}
        return cl.request(method, addr=w.address, blob=blob, hash=d.hex(),
                          n=n, cost=cost,
                          tag=_sign(w, method, epoch,
                                    d + struct.pack("<qd", n, cost)),
                          **base)

    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        by_addr = {w.address: w for w in wallets}
        for rnd in range(3):
            ep = cl.request("info")["epoch"]
            committee = cl.request("committee")["committee"]
            trainers = [w for w in wallets if w.address not in committee]
            if "async_buffer" in kw:
                for j in range(3):
                    w = trainers[(rnd + j) % len(trainers)]
                    if j == 2:
                        au = cl.request("aupdates")["updates"]
                        for c, addr in enumerate(committee):
                            pairs = [(u["aseq"], 0.25 * (c + 1) + 0.5 * k)
                                     for k, u in enumerate(au)]
                            r = cl.request(
                                "ascores", addr=addr,
                                pairs=[[a, s] for a, s in pairs],
                                tag=by_addr[addr].sign(_op_bytes(
                                    "ascores", addr, 0,
                                    ascores_sign_payload(pairs))).hex())
                            assert r["ok"], r
                    r = upload("aupload", w, 10 * rnd + j, ep)
                    assert r["ok"], r
            else:
                for j, w in enumerate(trainers[:kw["needed_update_count"]]):
                    assert upload("upload", w, 10 * rnd + j, ep)["ok"]
                for c, addr in enumerate(committee):
                    row = [0.5 + 0.1 * c + 0.05 * k
                           for k in range(kw["needed_update_count"])]
                    r = cl.request("scores", addr=addr, epoch=ep,
                                   scores=row,
                                   tag=_sign(by_addr[addr], "scores", ep,
                                             struct.pack(f"<{len(row)}d",
                                                         *row)))
                    assert r["ok"], r
            assert cl.request("info")["epoch"] == ep + 1
        info = cl.request("info")
        model = cl.request("model", meta=1)
        return (info, model.get("hash"),
                [v.ledger.log_head().hex() for v in nodes], max(sizes))
    finally:
        cl.close()
        srv.close()
        for v in nodes:
            v.close()


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_mixed_fleets_certify_one_codec_stream_both_ways(monkeypatch,
                                                         b5_leg, setting):
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    plain, plain_model, _, size = _stream(setting, "port")
    dense = len(pack_pytree(_flat(_tree(np.random.default_rng(1)))))
    assert size < dense / 2
    for writer, kinds, client in (
            ("port", ("port", "ref", "port", "ref"), "ref"),
            ("ref", ("ref", "port", "ref", "port"), "port")):
        info, model, heads, _ = _stream(setting, writer, kinds, client)
        assert info["certified_size"] == info["log_size"], info
        assert heads == [info["log_head"]] * 4
        assert (info["log_size"], info["log_head"], model) == \
            (plain["log_size"], plain["log_head"], plain_model)
        assert info["committee"] == plain["committee"]


# ------------------------------------ snapshot GC and BFLCWAL2, sparse
GC_CFG = dict(client_num=6, comm_count=2, aggregate_count=2,
              needed_update_count=3, learning_rate=0.05, batch_size=16,
              delta_density=0.05, delta_dtype="i8")
ADDRS = [f"0x{i:040x}" for i in range(6)]


def _gc_writer(package, tmp_path):
    blob0 = pack_pytree(_flat(_tree(np.random.default_rng(2))))
    kw = dict(require_auth=False, stall_timeout_s=3600.0,
              snapshot_interval=2,
              snapshot_dir=str(tmp_path / f"snaps-{package}"),
              wal_path=str(tmp_path / f"{package}.wal"))
    if package == "port":
        srv = LedgerServer(ProtocolConfig(**GC_CFG), blob0, device="cpu",
                           **kw)
    else:
        srv = ref_ls.LedgerServer(RefConfig(**GC_CFG), blob0,
                                  ledger_backend="python", **kw)
    return srv


def _gc_rounds(srv, rounds):
    """`rounds` sparse rounds straight through the writer's dispatch;
    the auth evidence of every upload op after each round."""
    for a in ADDRS:
        assert srv._dispatch("register", {"addr": a})["ok"]
    kept = []
    for _ in range(rounds):
        ep = srv.ledger.epoch
        committee = srv._dispatch("committee", {})["committee"]
        trainers = sorted(a for a in ADDRS if a not in committee)
        for i, a in enumerate(trainers[:3]):
            blob = pack_sparse(_flat(_tree(np.random.default_rng(
                [ep, i]), 0.1)), 0.05, "i8")
            r = srv._dispatch("upload", {
                "addr": a, "blob": blob, "n": 10 + i, "cost": 1.0,
                "hash": hashlib.sha256(blob).hexdigest(), "epoch": ep})
            assert r["ok"], r
        for a in committee:
            assert srv._dispatch("scores", {"addr": a, "epoch": ep,
                                            "scores": [0.5, 0.6, 0.7]})["ok"]
        assert srv.ledger.epoch == ep + 1
        kept.append(sorted(p for p, a in srv._op_auth.items()
                           if "blob" in a))
    return kept


def test_snapshot_gc_and_wal_on_a_sparse_chain_equal_the_references(
        tmp_path):
    port, ref = _gc_writer("port", tmp_path), _gc_writer("ref", tmp_path)
    try:
        kept = _gc_rounds(port, 5)
        rkept = _gc_rounds(ref, 5)
        for srv in (port, ref):
            srv._maybe_finalize_snapshot()
        assert kept == rkept
        # the blob evidence survives its commit (the reference's
        # retention) ...
        assert len(kept[0]) == 3 and len(kept[1]) == 6
        # ... and goes with the op auth below the GC base
        assert port.ledger.log_base == ref.ledger.log_base > 0
        assert sorted(port._op_auth) == sorted(ref._op_auth)
        assert min(p for p in port._op_auth) >= port.ledger.log_base
        for p, a in port._op_auth.items():
            assert a.get("blob") == ref._op_auth[p].get("blob"), p
        assert port.ledger.log_head() == ref.ledger.log_head()
        assert port.ledger.encode_state() == ref.ledger.encode_state()
        assert port._model_blob == ref._model_blob
    finally:
        port.close()
        ref.close()
    with open(tmp_path / "port.wal", "rb") as f:
        wal = f.read()
    with open(tmp_path / "ref.wal", "rb") as f:
        assert wal == f.read() and wal.startswith(b"BFLCWAL2")


# ------------------------------------------------------------ processes
FLEET_PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
                   needed_update_count=3, learning_rate=0.05, batch_size=16)


def _shards(rows):
    xtr, ytr, xte, yte = load_occupancy()
    return (iid_shards(xtr[:rows], ytr[:rows], FLEET_PROTO["client_num"]),
            (xte[:500], yte[:500]))


def test_port_client_processes_against_the_reference_writer(monkeypatch):
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    codec = dict(delta_density=0.05, delta_dtype="i8")
    cfg = ProtocolConfig(**FLEET_PROTO, **codec)
    shards, _ = _shards(6 * 250)
    init = pack_pytree(make_softmax_regression().init_params(0))
    srv = ref_ls.LedgerServer(RefConfig(**FLEET_PROTO, **codec), init,
                              stall_timeout_s=60.0, require_auth=True,
                              ledger_backend="python")
    srv.start()
    ctx = mp.get_context("spawn")
    report_q = ctx.Queue()
    procs = [ctx.Process(target=pr._client_proc, args=pr.client_args(
        [(srv.host, srv.port)], b"sparse-mixed-fleet-01", i,
        "make_softmax_regression", {}, sx, sy, 2, dict(vars(cfg)), 3, None,
        "cpu", report_q), daemon=True) for i, (sx, sy) in enumerate(shards)]
    try:
        for p in procs:
            p.start()
        reports = [report_q.get(timeout=120) for _ in procs]
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
        ops = [srv.ledger.log_op(i) for i in range(srv.ledger.log_size())]
        auths = [srv._op_auth[i] for i, op in enumerate(ops)
                 if op[0] == 2]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        srv.close()
    assert srv.ledger.epoch >= 3
    replica = make_ledger(cfg)
    for op in ops:
        assert replica.apply_op(op) == LedgerStatus.OK
    assert replica.log_head() == srv.ledger.log_head()
    # every upload rode sparse, with its blob in the evidence, and the
    # blob decodes through the reference's chain
    assert len(auths) >= 9 and all("blob" in a for a in auths)
    for a in auths:
        flat = ref_ser.unpack_pytree(bytes.fromhex(a["blob"]))
        assert any(k.endswith(TOPK_SUFFIX) for k in flat)
        assert any(k.endswith("#qscale") for k in flat)
        ref_ser.densify_entries(ref_ser.dequantize_entries(flat))
    for rep in reports:
        assert rep["foreign_modules"] == [], rep


def test_sketch_async_fleet_with_validators_certifies_on_the_cpu(
        monkeypatch):
    """`chip_smoke.py`'s `sketch_async_drill` on the CPU: the reference
    process test's geometry, async (K 3, staleness 20), count-sketch at
    density 0.5 in f16 with error feedback, 4 validators at 2 blocks."""
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    monkeypatch.setenv("BFLC_PROC_TRACE", "1")
    cfg = ProtocolConfig(**FLEET_PROTO, async_buffer=3, max_staleness=20,
                         reduce_blocks=2, delta_codec="sketch",
                         delta_density=0.5, delta_dtype="f16")
    shards, test = _shards(6 * 250)
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, test, cfg, rounds=4,
        device="cpu", bft_validators=4, stall_timeout_s=30.0,
        timeout_s=240.0)
    assert res.rounds_completed >= 4
    assert res.certified_size == res.ledger_log_size
    assert res.replica_report["head"] == res.ledger_log_head
    replies = {}
    for c in res.client_counts.values():
        for status, n in c["aupload"].items():
            replies[status] = replies.get(status, 0) + n
    assert replies.get("OK", 0) >= 12 and "SPARSE" not in replies
    assert all(not r["torch_imported"]
               for r in res.validator_reports.values())
    assert [m["leg"] for m in res.writer_merges] == \
        ["blocked"] * len(res.writer_merges)
    costs = res.final_info["perf"]["costs"]
    assert costs["admit.decode_n"] >= 12
    assert res.best_accuracy() > 0.5
