"""The port's native C++ ledger against both packages' python ledgers.

The native ledger (`bflc_demo_tpu_torch/ledger/bindings.py` over the
port's copy of the C++ in `ledger/src/`) is built here with the port's
own step (`g++` into `build/native_ledger/`).  A test that needs it
fails, never skips, when `g++` is present and the build fails; it skips
only where there is no C++ compiler.  The reference is called with
`backend="python"` only, so nothing here builds into the reference's
tree: its `PyLedger` is byte-identical to its native ledger by its own
tests.

The reference's native scenarios on the port's `NativeLedger`, each held
byte for byte against the port's and the reference's `PyLedger`:
`tests/test_ledger.py::TestNativePythonEquivalence` (SHA-256, a full
session, cross replay), `tests/test_wal.py`'s native cases (written and
replayed, attached mid-stream, a torn record, the files byte for byte),
`tests/test_snapshot.py`'s (state bytes and digests at several phases,
the snapshot op re-derived, a lying digest refused, the chain with a
snapshot op), `tests/test_bft.py::test_native_backend_agrees` and
`tests/test_async.py`'s refusal (with blocked and adaptive genomes).
Then `make_ledger`'s `auto` gates, the tool's `inspect`/`verify`/`head`
on a native WAL against the reference tool's, and mixed fleets in
threads both ways: a native writer with python standbys and validators,
and a python writer with a native standby and native validators, which
certify the same op stream and promote across backends.  C19: a native
v1 replica applies a blocked writer's commit with another head, where
the python ledgers refuse it.
"""

import dataclasses
import hashlib
import json
import shutil
import struct
import threading
import time

import numpy as np
import pytest

from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger import tool as ref_tool
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm.bft import ValidatorNode, provision_validators
from bflc_demo_tpu_torch.comm.failover import FailoverClient, Standby
from bflc_demo_tpu_torch.comm.identity import (Wallet, _op_bytes,
                                               provision_wallets)
from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
from bflc_demo_tpu_torch.ledger import (LedgerStatus, PyLedger, bindings,
                                        clone_prefix, make_ledger)
from bflc_demo_tpu_torch.ledger import tool
from bflc_demo_tpu_torch.ledger.snapshot import (make_snapshot_op,
                                                 parse_snapshot_op)
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_entries

GENOME = ProtocolConfig()                    # the reference genome
PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)
REF_CFG = RefConfig(**PROTO)
ADDRS = [f"0x{i:040x}" for i in range(CFG.client_num)]


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """Build the library once; a failed build with g++ present fails."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler here: the native ledger cannot build")
    info = bindings.build_library()
    assert bindings.native_available(), bindings.load_error()
    return info


def _three(cfg=CFG):
    """(port native, port python, reference python) at one genome."""
    ref = RefConfig(**dataclasses.asdict(cfg))
    return (make_ledger(cfg, backend="native"),
            make_ledger(cfg, backend="python"),
            ref_make_ledger(ref, backend="python"))


def _addr(i):
    return f"0x{i:040x}"


def _fill(led, n):
    for i in range(n):
        led.register_node(_addr(i))


def _session(led, cfg, rng_seed=7, epochs=3):
    """The reference's full session: registration, uploads by every
    trainer, committee score rows, commits."""
    rng = np.random.default_rng(rng_seed)
    _fill(led, cfg.client_num)
    for ep in range(epochs):
        scores = rng.random((cfg.comm_count, cfg.needed_update_count)) \
            .astype(np.float32)
        comm = led.committee()
        for i in range(cfg.client_num):
            a = _addr(i)
            if a not in comm:
                led.upload_local_update(a, hashlib.sha256(
                    f"{ep}-{i}".encode()).digest(), 100 + i, 0.5 + i, ep)
        for ci, c in enumerate(comm):
            led.upload_scores(c, ep, list(scores[ci]))
        led.commit_model(bytes([ep] * 32), ep)


def _ops(led):
    return [led.log_op(i) for i in range(led.log_size())]


# ------------------------------------------------------------- the build
def test_build_is_content_addressed_and_atomic(native_built):
    path = bindings.library_path()
    assert path.exists() and path.parent.name == "native_ledger"
    assert path.name.startswith("libbflc_ledger_")
    # a second build finds the library; nothing half-written is left
    assert bindings.build_library() == {"path": str(path), "seconds": 0.0}
    assert not list(path.parent.glob("*.tmp"))


# ------------------------------------ tests/test_ledger.py equivalence
def test_sha256_matches_hashlib():
    for payload in [b"", b"abc", b"x" * 1000, bytes(range(256)) * 5]:
        assert bindings.sha256_native(payload) == \
            hashlib.sha256(payload).digest()


@pytest.mark.parametrize("cfg", [GENOME, CFG], ids=["genome", "six"])
def test_full_session_identical(cfg):
    nat, py, ref = _three(cfg)
    for led in (nat, py, ref):
        _session(led, cfg)
    assert nat.backend == "native" and py.backend == "python"
    assert nat.epoch == py.epoch == ref.epoch == 3
    assert nat.committee() == py.committee() == ref.committee()
    assert nat.last_global_loss == py.last_global_loss \
        == ref.last_global_loss
    assert _ops(nat) == _ops(py) == _ops(ref)
    assert nat.log_head() == py.log_head() == ref.log_head()
    assert nat.encode_state() == py.encode_state() == ref.encode_state()
    assert nat.state_digest() == py.state_digest() == ref.state_digest()
    assert nat.verify_log() and py.verify_log()
    assert nat.pending() is None and nat.log_base == 0
    for k in (0, 5, nat.log_size()):
        assert nat.head_at(k) == py.head_at(k)


def test_cross_replay_both_ways():
    nat, py, ref = _three()
    _session(nat, CFG, epochs=1)
    for replica in (py, ref):
        for op in _ops(nat):
            assert replica.apply_op(op) == LedgerStatus.OK
        assert replica.log_head() == nat.log_head()
    back = make_ledger(CFG, backend="native")
    for op in _ops(ref):
        assert back.apply_op(op) == LedgerStatus.OK
    assert back.log_head() == ref.log_head()
    assert back.state_digest() == ref.state_digest()
    # clone_prefix on a native source keeps its backend
    half = clone_prefix(nat, 9, CFG, backend="native")
    assert half.backend == "native" and half.log_head() == nat.head_at(9)


# ------------------------------------------------ tests/test_wal.py
def _traffic(led, epochs=2):
    for i in range(CFG.client_num):
        led.register_node(f"0x{i:03x}")
    for ep in range(epochs):
        senders = [i for i in range(CFG.client_num)
                   if led.query_state(f"0x{i:03x}")[0] == "trainer"][:3]
        for i in senders:
            led.upload_local_update(f"0x{i:03x}", bytes([i, ep]) * 16,
                                    100 + i, 1.0, ep)
        for c in led.committee():
            led.upload_scores(c, ep, [0.5, 0.7, 0.6])
        led.commit_model(bytes([ep]) * 32, ep)


@pytest.mark.parametrize("case", ["replay", "mid_stream", "torn"])
def test_native_wal_cases(tmp_path, case):
    path = str(tmp_path / "led.wal")
    led = make_ledger(CFG, backend="native")
    if case == "mid_stream":
        for i in range(CFG.client_num):
            led.register_node(f"0x{i:03x}")
        assert led.attach_wal(path)
        led.upload_local_update("0x002", b"\1" * 32, 100, 1.0, 0)
    else:
        assert led.attach_wal(path)
        _traffic(led, epochs=2 if case == "replay" else 1)
    led.detach_wal()
    full = led.log_size()
    if case == "torn":
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-5])
    for backend in ("native", "python"):
        fresh = make_ledger(CFG, backend=backend)
        applied = fresh.replay_wal(path)
        assert applied == (full - 1 if case == "torn" else full)
        assert fresh.verify_log()
        if case != "torn":
            assert fresh.log_head() == led.log_head()
            assert fresh.committee() == led.committee()
    ref = ref_make_ledger(REF_CFG, backend="python")
    assert ref.replay_wal(path) == (full - 1 if case == "torn" else full)


def test_wal_files_identical_to_both_python_ledgers(tmp_path):
    leds = _three()
    paths = [str(tmp_path / f"{i}.wal") for i in range(3)]
    for led, p in zip(leds, paths):
        assert led.attach_wal(p)
        _traffic(led)
        led.detach_wal()
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0][:8] == b"BFLCWAL1"
    assert blobs[0] == blobs[1] == blobs[2]
    with pytest.raises(ValueError, match="not a bflc WAL"):
        open(paths[0] + ".bad", "wb").write(b"garbage")
        make_ledger(CFG, backend="native").replay_wal(paths[0] + ".bad")


# -------------------------------------------- tests/test_snapshot.py
def _drive_round(led):
    ep = led.epoch
    committee = led.committee()
    got = 0
    for a in ADDRS:
        if a in committee:
            continue
        h = hashlib.sha256(f"{ep}|{a}".encode()).digest()
        if led.upload_local_update(a, h, 10, 1.0, ep) == LedgerStatus.OK:
            got += 1
        if got >= CFG.needed_update_count:
            break
    for a in committee:
        assert led.upload_scores(a, ep, [0.5, 0.6, 0.7]) == LedgerStatus.OK
    assert led.commit_model(hashlib.sha256(f"model{ep}".encode()).digest(),
                            ep) == LedgerStatus.OK


def test_state_bytes_agree_at_every_phase():
    leds = _three()
    phases = []
    for led in leds:
        seen = []
        for a in ADDRS:
            led.register_node(a)
            seen.append(led.encode_state())
        ep = led.epoch
        trainers = [a for a in ADDRS if a not in led.committee()]
        led.upload_local_update(trainers[0], b"\3" * 32, 10, 1.0, ep)
        seen.append(led.encode_state())       # mid-round
        _drive_round(led)
        seen.append(led.encode_state())       # post-commit
        seen.append(led.state_digest())
        phases.append(seen)
    assert phases[0] == phases[1] == phases[2]


def test_snapshot_op_rederived_and_lies_refused():
    nat, py, ref = _three()
    for led in (nat, py, ref):
        for a in ADDRS:
            led.register_node(a)
        _drive_round(led)
    op = make_snapshot_op(nat)
    assert op == make_snapshot_op(py)
    bad = bytearray(op)
    bad[-1] ^= 0xFF                           # corrupt the state digest
    assert nat.apply_op(bytes(bad)) == LedgerStatus.BAD_ARG
    bad = bytearray(op)
    struct.pack_into("<q", bad, 1, nat.epoch + 3)
    assert nat.apply_op(bytes(bad)) == LedgerStatus.BAD_ARG
    for led in (nat, py, ref):
        assert led.apply_op(op) == LedgerStatus.OK
    ep, digest = parse_snapshot_op(op)
    assert ep == nat.epoch and digest == nat.state_digest()
    assert nat.log_head() == py.log_head() == ref.log_head()
    # the native ledger applies snapshot ops but never compacts
    assert nat.log_base == 0 and nat.log_size() == py.log_size()


# ------------------------------------ tests/test_bft.py, test_async.py
def test_native_backend_agrees():
    py, nat = (make_ledger(CFG, backend=b) for b in ("python", "native"))
    ref = ref_make_ledger(REF_CFG, backend="python")
    scratch = make_ledger(CFG, backend="python")
    ops = []
    for i in range(3):
        scratch.register_node(f"0x{i:040x}")
        ops.append(scratch.log_op(i))
    for led in (py, nat, ref):
        for op in ops[:2]:
            assert led.apply_op(op) == LedgerStatus.OK
    for op in (ops[2], ops[0], b"\xff", b""):
        assert py.validate_op(op) == nat.validate_op(op) \
            == ref.validate_op(op)
    assert py.log_head() == nat.log_head() == ref.log_head()
    assert nat.log_size() == 2                # the probe never applied


@pytest.mark.parametrize("knob", [dict(async_buffer=3),
                                  dict(reduce_blocks=2),
                                  dict(delta_density=0.1, adapt_every=2)],
                         ids=["async", "blocked", "adaptive"])
def test_native_refused_where_the_reference_refuses_it(knob):
    cfg = dataclasses.replace(CFG, **knob)
    with pytest.raises(ValueError, match="python ledger backend"):
        make_ledger(cfg, backend="native")
    for backend in ("auto", "python"):
        led = make_ledger(cfg, backend=backend)
        assert isinstance(led, PyLedger) and led.backend == "python"


def test_auto_is_native_and_legacy_pins_follow(monkeypatch):
    assert make_ledger(CFG).backend == "native"
    assert make_ledger(GENOME, backend="auto").backend == "native"
    monkeypatch.setenv("BFLC_ASYNC_LEGACY", "1")
    assert make_ledger(dataclasses.replace(CFG, async_buffer=3)) \
        .backend == "native"


def test_native_without_a_library_raises(monkeypatch):
    monkeypatch.setattr(bindings, "_LIB", None)
    monkeypatch.setattr(bindings, "_LOAD_ERROR", "RuntimeError: no g++")
    with pytest.raises(RuntimeError, match="could not be built or loaded"):
        make_ledger(CFG, backend="native")
    # auto falls back to the python ledger, as the reference's does
    assert make_ledger(CFG).backend == "python"


# ------------------------------------------------------------ the tool
def _native_wal(tmp_path):
    path = str(tmp_path / "run.wal")
    led = make_ledger(CFG, backend="native")
    assert led.attach_wal(path)
    _session(led, CFG, epochs=2)
    led.detach_wal()
    return path, led


def test_tool_on_a_native_wal_matches_the_references(tmp_path, capsys):
    path, led = _native_wal(tmp_path)
    geometry = ["--client-num", "6", "--comm-count", "2",
                "--aggregate-count", "2", "--needed-update-count", "3"]
    outs = {}
    for name, main in (("port", tool.main), ("ref", ref_tool.main)):
        assert main(["inspect", path, "--json"]) == 0
        inspect = capsys.readouterr().out
        assert main(["verify", path, "--json", *geometry]) == 0
        verify = json.loads(capsys.readouterr().out)
        outs[name] = (inspect, verify)
    assert outs["port"] == outs["ref"]
    recs = [json.loads(x) for x in outs["port"][0].splitlines()]
    assert len(recs) == led.log_size() and recs[-1]["op"] == "commit"
    assert outs["port"][1]["log_head"] == led.log_head().hex()
    assert outs["port"][1]["chain_verified"] is True
    for backend in ("native", "python", "auto"):
        assert tool.main(["head", path, "--backend", backend,
                          *geometry]) == 0
        assert capsys.readouterr().out.strip() == led.log_head().hex()
    assert [i for i, _ in tool.iter_wal_ops(path)] == \
        list(range(led.log_size()))
    assert tool.wal_base(path) == 0


# ------------------------------------------------------- mixed fleets
def _init_blob():
    return pack_entries({"['W']": np.zeros((5, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


def _register_all(client, wallets):
    for w in wallets:
        r = client.request("register", addr=w.address,
                           pubkey=w.public_bytes.hex(),
                           tag=_sign(w, "register", 0, b""))
        assert r["ok"] or r["status"] in ("ALREADY_REGISTERED",
                                          "DUPLICATE"), r


def _fleet_round(client, wallets, epoch):
    committee = set(client.request("committee")["committee"])
    trainers = [w for w in wallets if w.address not in committee]
    for i, w in enumerate(trainers[:CFG.needed_update_count]):
        blob = pack_entries({"['W']": np.full((5, 2), 0.1 * (i + 1) + epoch,
                                              np.float32),
                             "['b']": np.zeros((2,), np.float32)})
        digest = hashlib.sha256(blob).digest()
        payload = digest + struct.pack("<qd", 10 + i, 1.0)
        r = client.request("upload", addr=w.address, blob=blob.hex(),
                           hash=digest.hex(), n=10 + i, cost=1.0,
                           epoch=epoch,
                           tag=_sign(w, "upload", epoch, payload))
        assert r["ok"] or r["status"] == "DUPLICATE", r
    n_up = CFG.needed_update_count
    for j, w in enumerate([w for w in wallets if w.address in committee]):
        scores = [0.5 + 0.01 * (j + u) for u in range(n_up)]
        payload = struct.pack(f"<{n_up}d", *scores)
        r = client.request("scores", addr=w.address, epoch=epoch,
                           scores=scores,
                           tag=_sign(w, "scores", epoch, payload))
        assert r["ok"] or r["status"] in ("DUPLICATE", "WRONG_EPOCH"), r


def _await(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


@pytest.mark.parametrize("writer,follower", [("native", "python"),
                                             ("python", "native")])
def test_mixed_fleet_certifies_one_stream_and_promotes(writer, follower):
    """A writer of one backend, a standby and 4 validators of the other:
    every op certified, the follower's chain the writer's byte for byte,
    and after the writer dies the standby (the other backend) promotes
    and the fleet finishes the next round on the same chain."""
    wallets, directory = provision_wallets(CFG.client_num,
                                           f"mixed-{writer}".encode())
    sb_wallet = Wallet.from_seed(f"mixed-sb-{writer}".encode())
    skeys = {1: sb_wallet.public_bytes}
    vwallets, vkeys = provision_validators(4, f"mixed-v-{writer}".encode())
    nodes = [ValidatorNode(CFG, w, i, validator_keys=vkeys,
                           ledger_backend=follower)
             for i, w in enumerate(vwallets)]
    for v in nodes:
        v.start()
    eps = [(v.host, v.port) for v in nodes]
    srv = LedgerServer(CFG, _init_blob(), directory=directory,
                       stall_timeout_s=60.0, ledger_backend=writer,
                       standby_keys=skeys, bft_validators=eps,
                       bft_keys=vkeys, bft_timeout_s=8.0, device="cpu")
    srv.start()
    standby = Standby(CFG, [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                      heartbeat_s=0.3, stall_timeout_s=60.0,
                      ledger_backend=follower, wallet=sb_wallet,
                      standby_keys=skeys, bft_validators=eps,
                      bft_keys=vkeys, bft_timeout_s=8.0, device="cpu")
    standby.endpoints[1] = (standby.host, standby.port)
    threading.Thread(target=standby.run, daemon=True).start()
    client = FailoverClient([(srv.host, srv.port),
                             (standby.host, standby.port)], timeout_s=20.0,
                            standby_keys=skeys, bft_keys=vkeys)
    try:
        assert srv.ledger.backend == writer
        assert standby.ledger.backend == follower
        assert {v.ledger.backend for v in nodes} == {follower}
        _register_all(client, wallets)
        _fleet_round(client, wallets, epoch=0)
        info = client.request("info")
        assert info["epoch"] == 1
        assert info["certified_size"] == info["log_size"]
        size = info["log_size"]
        _await(lambda: standby.ledger.log_size() >= size, "standby lag")
        _await(lambda: all(v.ledger.log_size() >= size for v in nodes),
               "validator lag")
        want = _ops(srv.ledger)
        assert _ops(standby.ledger) == want
        for v in nodes:
            assert v.ledger.log_head() == srv.ledger.log_head()
        # the reference's python ledger replays the certified stream
        ref = ref_make_ledger(REF_CFG, backend="python")
        for op in want:
            assert ref.apply_op(op) == LedgerStatus.OK
        assert ref.log_head() == srv.ledger.log_head()

        srv.close()
        assert standby.promoted.wait(timeout=30), "no promotion"
        client.close()
        deadline = time.monotonic() + 20
        while True:
            info2 = client.request("info")
            if info2["gen"] == 1:
                break
            assert time.monotonic() < deadline, info2
            client.close()
            time.sleep(0.1)
        assert standby.server.ledger.backend == follower
        _fleet_round(client, wallets, epoch=1)
        info3 = client.request("info")
        assert info3["epoch"] == 2
        assert info3["certified_size"] == info3["log_size"]
        assert _ops(standby.server.ledger)[:size] == want
    finally:
        client.close()
        standby.stop()
        srv.close()
        for v in nodes:
            v.close()


def test_snapshotting_writer_and_standby_force_python(tmp_path):
    """The reference's gates: a writer or a standby that runs snapshots
    compacts, which needs the python ledger; `native` there raises."""
    with pytest.raises(ValueError, match="snapshot_interval"):
        LedgerServer(CFG, _init_blob(), ledger_backend="native",
                     snapshot_interval=2, snapshot_dir=str(tmp_path),
                     device="cpu")
    srv = LedgerServer(CFG, _init_blob(), snapshot_interval=2,
                       snapshot_dir=str(tmp_path), device="cpu")
    plain = LedgerServer(CFG, _init_blob(), device="cpu")
    sb = Standby(CFG, [("127.0.0.1", 1), ("127.0.0.1", 0)], 1,
                 snapshot_interval=2, snapshot_dir=str(tmp_path / "sb"),
                 device="cpu", wallet=Wallet.from_seed(b"snap-sb"))
    try:
        assert srv.ledger.backend == "python"
        assert plain.ledger.backend == "native"
        assert sb.ledger.backend == "python"
    finally:
        srv.close()
        plain.close()
        sb.stop()


def test_validators_arm_the_rederiver_only_on_python():
    """The reference arms a validator's re-derivation for the python
    backend only (`comm/bft.py:668`); `auto` now means native."""
    w = Wallet.from_seed(b"rederive-gate")
    armed = ValidatorNode(CFG, w, 0, rederive="shard", device="cpu")
    auto = ValidatorNode(CFG, w, 0, rederive="shard", device="cpu",
                         ledger_backend="auto")
    try:
        assert armed._rederiver is not None
        assert auto._rederiver is None and auto.ledger.backend == "native"
    finally:
        armed.close()
        auto.close()


def test_c19_native_v1_replica_takes_a_blocked_commit_with_another_head():
    """C19, the reference's C++ kept as it is: its OP_COMMIT parser reads
    the 41-byte v1 body and ignores a REDUCTION SPEC v2 claim tail, so a
    native v1 replica applies a blocked writer's 53-byte commit (and
    re-records it without the tail: its head leaves the writer's), where
    both packages' python ledgers refuse it (BAD_ARG).  A replica runs
    native at v1 under `auto` in both packages; every port role that
    follows a blocked chain is built at the writer's genome, so it runs
    python and refuses nothing of it."""
    cfg2, cfg1 = (dataclasses.replace(CFG, reduce_blocks=2), CFG)
    writer = make_ledger(cfg2)
    assert writer.backend == "python"
    _fill(writer, cfg2.client_num)
    _drive_round(writer)
    op = writer.log_op(writer.log_size() - 1)
    assert len(op) == 53 and op[0] == 4
    prefix = _ops(writer)[:-1]
    ref = ref_make_ledger(RefConfig(**PROTO), backend="python")
    for led in (make_ledger(cfg1, backend="native"),
                make_ledger(cfg1, backend="python"), ref):
        for o in prefix:
            assert led.apply_op(o) == LedgerStatus.OK
        st = led.apply_op(op)
        if getattr(led, "backend", "python") == "native":
            assert st == LedgerStatus.OK and led.epoch == 1
            assert led.log_op(led.log_size() - 1) == op[:41]
            assert led.log_head() != writer.log_head()
        else:
            assert st == LedgerStatus.BAD_ARG and led.epoch == 0
