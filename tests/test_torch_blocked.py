"""REDUCTION SPEC v2's block geometry in the port, against the reference.

- The block bounds and the genome's checks equal the reference's, and
  `BFLC_BLOCKED_LEGACY=1` pins one block.
- The port's writer merge at B = 2 and 8 (host leg, and the mesh leg on
  the CPU: kernel B5's plain version) commits the reference's scripted
  round's golden model hash bit for bit.
- The commit op: at B = 2 the port's 52-byte op equals the reference's,
  the v1 op is unchanged, a lying geometry claim is refused before any
  state changes, and a port validator therefore refuses to co-sign it.
- Fault C7: a reference writer's blocked chain replays through a port
  replica and a port standby, the heads equal at every op; a port writer
  with a blocked genome is certified by reference validators.
- Fault C8: the op-stream frames of the port's writer equal the
  reference writer's byte for byte, with and without
  `BFLC_CONTROL_PLANE_LEGACY=1` (no piggybacked blob under the switch),
  and the switch pins the certification window to one op.
All on the CPU.
"""

import hashlib
import json
import os
import pathlib
import struct
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from bflc_demo_tpu.comm import bft as ref_bft
from bflc_demo_tpu.comm import identity as ref_id
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger.base import reduce_blocks as ref_reduce_blocks
from bflc_demo_tpu.meshagg import spec as ref_spec
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm.bft import (ValidatorClient, ValidatorNode,
                                          provision_validators)
from bflc_demo_tpu_torch.comm.failover import (FailoverClient, Standby,
                                               WriterDead)
from bflc_demo_tpu_torch.comm.identity import _op_bytes, provision_wallets
from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                     LedgerServer, replicate)
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.ledger.base import reduce_blocks
from bflc_demo_tpu_torch.ledger.pyledger import _BLOCKS_MAGIC
from bflc_demo_tpu_torch.meshagg import spec
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_entries

REPO = pathlib.Path(__file__).resolve().parents[1]
# the committed model hash of the reference's scripted config-1-shaped
# sync round (tests/test_meshagg.py GOLDEN_SYNC_MODEL), any block count
GOLDEN_SYNC_MODEL = ("cc8d5f5257a2dc49be71fe88ce91f039"
                     "a8779af406cd58ba187933a731bf463f")


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


# ------------------------------------------------------ bounds and genome
def test_block_bounds_are_the_references():
    for p in (1, 5, 42, 97, 4096):
        for blocks in (1, 2, 3, 7, p):
            if blocks <= p:
                assert spec.block_bounds(p, blocks) == \
                    ref_spec.block_bounds(p, blocks)
    assert spec.block_bounds(0, 1) == ref_spec.block_bounds(0, 1)
    for p, blocks in ((42, 43), (10, 0), (10, -1)):
        with pytest.raises(ValueError):
            spec.block_bounds(p, blocks)


@pytest.mark.parametrize("blocks,ok", [(1, True), (2, True), (65536, True),
                                       (0, False), (-3, False),
                                       (65537, False)])
def test_genome_checks_are_the_references(blocks, ok):
    for Config in (ProtocolConfig, RefConfig):
        if ok:
            assert Config(reduce_blocks=blocks).validate()
        else:
            with pytest.raises(ValueError, match="reduce_blocks"):
                Config(reduce_blocks=blocks).validate()


def test_legacy_env_pins_v1(monkeypatch):
    cfg, ref_cfg = ProtocolConfig(reduce_blocks=8), RefConfig(reduce_blocks=8)
    assert reduce_blocks(cfg) == ref_reduce_blocks(ref_cfg) == 8
    assert make_ledger(cfg).reduce_blocks == 8
    monkeypatch.setenv("BFLC_BLOCKED_LEGACY", "1")
    assert reduce_blocks(cfg) == ref_reduce_blocks(ref_cfg) == 1
    # the pinned v1 chain: native under auto, as in the reference
    assert make_ledger(cfg).backend == "native"
    assert make_ledger(cfg, backend="python").reduce_blocks == 1


def test_native_backend_refused_by_name():
    # the reference's refusal: the native ledger has no geometry claim
    with pytest.raises(ValueError, match="python ledger backend"):
        make_ledger(ProtocolConfig(reduce_blocks=2), backend="native")


def test_env_and_flag_reach_the_genome(monkeypatch):
    from bflc_demo_tpu.utils import flags as ref_flags
    from bflc_demo_tpu_torch.__main__ import _parser
    from bflc_demo_tpu_torch.utils import flags
    monkeypatch.setenv("BFLC_REDUCE_BLOCKS", "4")
    assert flags.protocol_from_env().reduce_blocks == \
        ref_flags.protocol_from_env().reduce_blocks == 4
    monkeypatch.delenv("BFLC_REDUCE_BLOCKS")
    cfg = flags.parse_protocol(_parser().parse_args(["--reduce-blocks",
                                                     "8"]))
    _, ref_cfg = ref_flags.parse_args(["--reduce-blocks", "8"])
    assert cfg == ProtocolConfig(reduce_blocks=8)
    assert ref_cfg.reduce_blocks == 8


# ----------------------------------------- the writer's merge, golden hash
def _tree(rng, scale=1.0):
    return {"['W1']": (rng.standard_normal((16, 8)) * scale
                       ).astype(np.float32),
            "['b1']": (rng.standard_normal((8,)) * scale
                       ).astype(np.float32),
            "['W2']": (rng.standard_normal((8, 3)) * scale
                       ).astype(np.float32)}


def _sync_round_model_hash(**cfg_overrides):
    """The reference's scripted sync round (tests/test_meshagg.py
    `_sync_round_model_hash`) against the port's writer on the CPU."""
    cfg = ProtocolConfig(client_num=20, comm_count=4, aggregate_count=6,
                         needed_update_count=10, learning_rate=0.05,
                         batch_size=16, **cfg_overrides).validate()
    blob0 = pack_entries(_tree(np.random.default_rng(11)))
    wallets, _ = provision_wallets(20, b"meshagg-parity-seed")
    srv = LedgerServer(cfg, blob0, device="cpu")
    srv.start()
    cl = CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
    try:
        for w in wallets:
            assert cl.request("register", addr=w.address,
                              pubkey=w.public_bytes.hex(),
                              tag=_sign(w, "register", 0, b""))["ok"]
        committee = set(cl.request("committee")["committee"])
        trainers = [w for w in wallets if w.address not in committee]
        for i, w in enumerate(trainers[:10]):
            blob = pack_entries(_tree(np.random.default_rng(100 + i), 0.1))
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
        commit = srv.ledger.log_op(srv.ledger.log_size() - 1)
        return cl.request("model")["hash"], commit, srv.merge_log[-1]
    finally:
        cl.close()
        srv.close()


@pytest.mark.parametrize("blocks", [2, 8])
@pytest.mark.parametrize("leg", ["host", "mesh"])
def test_blocked_writer_merge_commits_the_golden_hash(monkeypatch, blocks,
                                                      leg):
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY", raising=False)
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1" if leg == "mesh" else "64")
    got, commit, merge = _sync_round_model_hash(reduce_blocks=blocks)
    assert got == GOLDEN_SYNC_MODEL
    # the engine labels its mesh leg at two blocks or more "blocked"
    assert merge["leg"] == ("blocked" if leg == "mesh" else "host")
    assert merge["blocks"] == blocks
    assert len(commit) == 53
    assert struct.unpack("<q", commit[45:])[0] == blocks


def test_legacy_env_pins_the_v1_wire(monkeypatch):
    monkeypatch.setenv("BFLC_BLOCKED_LEGACY", "1")
    got, commit, merge = _sync_round_model_hash(reduce_blocks=2)
    assert got == GOLDEN_SYNC_MODEL
    assert len(commit) == 41 and merge["blocks"] == 1


# ----------------------------------------------------------- the commit op
def _addr(i):
    return f"0x{i:040x}"


def _committed(make, cfg):
    led = make(cfg, backend="python")
    for i in range(cfg.client_num):
        led.register_node(_addr(i))
    for i in range(cfg.comm_count, cfg.client_num):
        led.upload_local_update(
            _addr(i), hashlib.sha256(f"p{i}@0".encode()).digest(),
            300 + i, 1.5, 0)
    rng = np.random.default_rng(42)
    for c in led.committee():
        led.upload_scores(c, 0, list(rng.random(
            cfg.needed_update_count).astype(np.float32)))
    assert led.commit_model(hashlib.sha256(b"m1").digest(), 0) == \
        LedgerStatus.OK
    return led


@pytest.mark.parametrize("blocks", [1, 2])
def test_commit_op_equals_the_references(blocks):
    port = _committed(make_ledger, ProtocolConfig(reduce_blocks=blocks))
    ref = _committed(ref_make_ledger, RefConfig(reduce_blocks=blocks))
    op = port.log_op(port.log_size() - 1)
    assert op == ref.log_op(ref.log_size() - 1)
    assert port.log_head() == ref.log_head()
    if blocks == 1:
        assert len(op) == 41                # v1: unchanged
    else:
        assert len(op[1:]) == 52 and op[41:45] == _BLOCKS_MAGIC
        assert struct.unpack("<q", op[45:])[0] == 2


def _replay(cfg, src, upto):
    # the python ledger's refusals (a native v1 replica accepts a v2
    # commit, C19: tests/test_torch_native_ledger.py)
    led = make_ledger(cfg, backend="python")
    for j in range(upto):
        assert led.apply_op(src.log_op(j)) == LedgerStatus.OK, j
    return led


def test_lying_claim_refused_before_state_changes():
    cfg2 = ProtocolConfig(reduce_blocks=2)
    w = _committed(make_ledger, cfg2)
    op = w.log_op(w.log_size() - 1)
    lie = op[:41] + _BLOCKS_MAGIC + struct.pack("<q", 8)
    r = _replay(cfg2, w, w.log_size() - 1)
    head, epoch = r.log_head(), r.epoch
    assert r.validate_op(lie) == LedgerStatus.BAD_ARG
    assert r.log_head() == head and r.epoch == epoch
    assert r.apply_op(lie) == LedgerStatus.BAD_ARG
    assert r.apply_op(op[:41] + b"XY") == LedgerStatus.BAD_ARG
    assert r.log_head() == head and r.epoch == epoch
    # v1 and v2 replicas refuse each other's commit
    assert _replay(ProtocolConfig(), w, w.log_size() - 1).apply_op(op) == \
        LedgerStatus.BAD_ARG
    w1 = _committed(make_ledger, ProtocolConfig())
    assert _replay(cfg2, w1, w1.log_size() - 1).apply_op(
        w1.log_op(w1.log_size() - 1)) == LedgerStatus.BAD_ARG
    assert r.apply_op(op) == LedgerStatus.OK
    assert r.log_head() == w.log_head()


def test_validate_op_leaves_the_wal_untouched(tmp_path):
    w = _committed(make_ledger, ProtocolConfig(reduce_blocks=2))
    r = _replay(ProtocolConfig(reduce_blocks=2), w, w.log_size() - 1)
    path = str(tmp_path / "wal")
    assert r.attach_wal(path)
    before = open(path, "rb").read()
    assert r.validate_op(w.log_op(w.log_size() - 1)) == LedgerStatus.OK
    assert open(path, "rb").read() == before
    assert r.log_size() == w.log_size() - 1


def test_port_validator_refuses_to_cosign_a_lying_claim():
    cfg2 = ProtocolConfig(reduce_blocks=2)
    w = _committed(make_ledger, cfg2)
    op = w.log_op(w.log_size() - 1)
    lie = op[:41] + _BLOCKS_MAGIC + struct.pack("<q", 8)
    vw, vk = provision_validators(1, b"blk-lie")
    node = ValidatorNode(cfg2, vw[0], 0, require_auth=False)
    node.start()
    vc = ValidatorClient((node.host, node.port), timeout_s=10.0)
    try:
        n = w.log_size() - 1
        r = vc.request("bft_vote_batch", i=0,
                       ops=[w.log_op(j).hex() for j in range(n)],
                       auths=[None] * n)
        assert len(r["votes"]) == n and r["stopped"] is None, r
        r = vc.request("bft_validate", i=n, op=lie.hex())
        assert not r["ok"] and r["status"] == "BAD_ARG", r
        assert node.ledger.log_size() == n
        r = vc.request("bft_validate", i=n, op=op.hex())
        assert r["ok"], r
        assert node.ledger.log_head() == w.log_head()
    finally:
        vc.close()
        node.close()


# ------------------------------------------------------------- fault C7
PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16,
             reduce_blocks=2)


def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _drive(client, wallets, sign, epochs=(0, 1)):
    for w in wallets:
        r = client.request("register", addr=w.address,
                           pubkey=w.public_bytes.hex(),
                           tag=sign(w, "register", 0, b""))
        assert r["ok"], r
    for epoch in epochs:
        committee = set(client.request("committee")["committee"])
        trainers = [w for w in wallets if w.address not in committee]
        for i, w in enumerate(trainers[:3]):
            blob = pack_entries({"['W']": np.full((5, 2), 0.1 * (i + 1)
                                                  + epoch, np.float32),
                                 "['b']": np.zeros((2,), np.float32)})
            d = hashlib.sha256(blob).digest()
            payload = d + struct.pack("<qd", 10 + i, 1.0)
            r = client.request("upload", addr=w.address, blob=blob,
                               hash=d.hex(), n=10 + i, cost=1.0,
                               epoch=epoch,
                               tag=sign(w, "upload", epoch, payload))
            assert r["ok"], r
        for j, w in enumerate([w for w in wallets
                               if w.address in committee]):
            scores = [0.5 + 0.01 * (j + u) for u in range(3)]
            payload = struct.pack("<3d", *scores)
            r = client.request("scores", addr=w.address, epoch=epoch,
                               scores=scores,
                               tag=sign(w, "scores", epoch, payload))
            assert r["ok"] or r["status"] == "WRONG_EPOCH", r


def _ref_sign(w, kind, epoch, payload):
    return w.sign(ref_id._op_bytes(kind, w.address, epoch, payload)).hex()


def test_c7_port_replica_and_standby_follow_a_reference_blocked_chain():
    """A reference writer at reduce_blocks=2 commits two rounds (52-byte
    commit ops); a port standby follows it live and a port replica
    replays it after, and both hold the writer's head at every op."""
    srv = ref_ls.LedgerServer(RefConfig(**PROTO), _init_blob(),
                              stall_timeout_s=60.0, ledger_backend="python")
    srv.start()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a wallet-less standby
        sb = Standby(ProtocolConfig(**PROTO),
                     [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                     heartbeat_s=0.3, stall_timeout_s=60.0, device="cpu")
    sb.endpoints[1] = (sb.host, sb.port)
    def follow():
        try:
            sb._follow((srv.host, srv.port))
        except WriterDead:
            pass                        # the writer closed at the end

    follower = threading.Thread(target=follow, daemon=True)
    follower.start()
    wallets, _ = ref_id.provision_wallets(6, b"blk-c7")
    client = ref_ls.CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
    try:
        _drive(client, wallets, _ref_sign)
        n = srv.ledger.log_size()
        commits = [srv.ledger.log_op(j) for j in range(n)
                   if srv.ledger.log_op(j)[0] == 4]
        assert len(commits) == 2 and all(len(op) == 53 for op in commits)
        replica = replicate(srv.host, srv.port, ProtocolConfig(**PROTO),
                            until_ops=n, timeout_s=30.0)
        deadline = time.monotonic() + 30.0
        while sb.ledger.log_size() < n:
            assert time.monotonic() < deadline, "standby lagging"
            time.sleep(0.05)
        for j in range(1, n + 1):
            want = ref_ls.chain_head_at(srv.ledger, j)
            assert replica.head_at(j) == want, j
            assert sb.ledger.head_at(j) == want, j
        assert sb.ledger.epoch == replica.epoch == 2
    finally:
        client.close()
        sb.stop()
        srv.close()
        follower.join(timeout=10)


def test_port_blocked_writer_certified_by_reference_validators():
    cfg = ProtocolConfig(**PROTO)
    vw, vkeys = ref_bft.provision_validators(4, b"blk-bft")
    nodes = [ref_bft.ValidatorNode(RefConfig(**PROTO), w, i,
                                   validator_keys=vkeys)
             for i, w in enumerate(vw)]
    for v in nodes:
        v.start()
    wallets, directory = provision_wallets(6, b"blk-bft")
    srv = LedgerServer(cfg, _init_blob(), directory=directory,
                       stall_timeout_s=60.0, device="cpu",
                       bft_validators=[(v.host, v.port) for v in nodes],
                       bft_keys=vkeys, bft_timeout_s=8.0)
    srv.start()
    client = FailoverClient([(srv.host, srv.port)], timeout_s=30.0,
                            bft_keys=vkeys)
    try:
        _drive(client, wallets, _sign)
        info = client.request("info")
        assert info["epoch"] == 2
        assert info["certified_size"] == info["log_size"]
        assert [m["blocks"] for m in srv.merge_log] == [2, 2]
        for v in nodes:
            assert v.ledger.log_head().hex() == info["log_head"]
    finally:
        client.close()
        srv.close()
        for v in nodes:
            v.close()


# ------------------------------------------------------------- fault C8
_FRAMES = r'''
import hashlib, json, os, socket, struct, sys
import numpy as np
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm import ledger_service as port_ls
from bflc_demo_tpu_torch.comm.wire import recv_exact, send_msg
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_entries

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
init = pack_entries({"['W']": np.zeros((5, 2), np.float32),
                     "['b']": np.zeros((2,), np.float32)})
servers = {
    "port": port_ls.LedgerServer(ProtocolConfig(**PROTO), init,
                                 require_auth=False, stall_timeout_s=60.0,
                                 device="cpu"),
    "ref": ref_ls.LedgerServer(RefConfig(**PROTO), init,
                               require_auth=False, stall_timeout_s=60.0,
                               ledger_backend="python")}
out = {"legacy": bool(os.environ.get("BFLC_CONTROL_PLANE_LEGACY"))}
for side, srv in servers.items():
    srv.start()
    c = port_ls.CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
    addrs = [f"0x{i:040x}" for i in range(6)]
    for a in addrs:
        assert c.request("register", addr=a)["ok"]
    committee = set(c.request("committee")["committee"])
    trainers = [a for a in addrs if a not in committee]
    for i, a in enumerate(trainers[:3]):
        blob = pack_entries({"['W']": np.full((5, 2), 0.5 + i, np.float32),
                             "['b']": np.zeros((2,), np.float32)})
        r = c.request("upload", addr=a, blob=blob,
                      hash=hashlib.sha256(blob).hexdigest(), n=10 + i,
                      cost=1.0, epoch=0)
        assert r["ok"], r
    for j, a in enumerate(sorted(committee)):
        assert c.request("scores", addr=a, epoch=0,
                         scores=[0.5, 0.6 + j, 0.7])["ok"]
    n = c.request("info")["log_size"]
    sub = socket.create_connection((srv.host, srv.port), timeout=30.0)
    send_msg(sub, {"method": "subscribe", "from": 0})
    frames = []
    for _ in range(n):
        head = recv_exact(sub, 4)
        frames.append((head + recv_exact(sub, struct.unpack(">I", head)[0])
                       ).hex())
    out[side] = {"frames": frames, "log_size": n,
                 "cert_batch": getattr(srv, "_cert_batch", None)}
    sub.close()
    c.close()
    srv.close()
print(json.dumps(out))
'''


@pytest.mark.parametrize("legacy", [False, True])
def test_c8_op_stream_frames_equal_the_reference_writers(legacy):
    env = {k: v for k, v in os.environ.items()
           if k != "BFLC_CONTROL_PLANE_LEGACY"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    if legacy:
        env["BFLC_CONTROL_PLANE_LEGACY"] = "1"
    run = subprocess.run([sys.executable, "-c", _FRAMES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["legacy"] is legacy
    port, ref = out["port"], out["ref"]
    assert port["log_size"] == ref["log_size"] == 12
    for i, (a, b) in enumerate(zip(port["frames"], ref["frames"])):
        assert a == b, (i, a[:200], b[:200])
    assert port["cert_batch"] == ref["cert_batch"] == (1 if legacy else 128)
    # the stream starts after the commit, whose merge dropped the
    # round's upload blobs: the commit's model blob is the one that
    # rides, and under the switch none does
    blobs = sum(b"blob" in bytes.fromhex(f) for f in port["frames"])
    assert blobs == (0 if legacy else 1)
