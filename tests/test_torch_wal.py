"""The writer fence (opcode 8) and the write-ahead log against the
reference's python ledger.

- `promote_writer`'s op bytes equal the reference's; one op stream that
  holds promotions brings both ledgers to the same head, `generation`
  and `writer_index`, and each replays the other's ops; a fence that
  skips a generation or names a negative writer is refused by both.
- The `BFLCWAL1` journal: the port's file after an op stream is the
  reference's byte for byte (attached at genesis and mid-stream, and
  `save_wal`); each package replays the other's file to head equality;
  a torn trailing record is skipped as the reference skips it, a file
  that is not a WAL is rejected, a `BFLCWAL2` file (the compacted
  journal, `tests/test_torch_snapshot.py`) with a torn header is refused
  by both, and `compact_wal` before any GC rewrites the reference's
  `BFLCWAL1` bytes; a failed journal write detaches the WAL and the
  ledger keeps serving.
- `clone_prefix` and `decode_op` against the reference's.
All on the CPU.
"""

import hashlib
import os

import numpy as np
import pytest

from bflc_demo_tpu.ledger import clone_prefix as ref_clone_prefix
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger.tool import decode_op as ref_decode_op
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.ledger import LedgerStatus, clone_prefix, make_ledger
from bflc_demo_tpu_torch.ledger.base import decode_op, encode_promote_op
from bflc_demo_tpu_torch.protocol import ProtocolConfig

PROTO = dict(client_num=4, comm_count=2, aggregate_count=2,
             needed_update_count=2, learning_rate=0.05, batch_size=16)
ADDRS = [f"0x{i:040x}" for i in range(PROTO["client_num"])]


def _ledgers():
    # the port's python ledger (the native one: test_torch_native_ledger)
    return (make_ledger(ProtocolConfig(**PROTO), backend="python"),
            ref_make_ledger(RefConfig(**PROTO), backend="python"))


def _script(led, promote_at=(0, 9)):
    """Two rounds of registers, uploads, scores and commits, with a
    promotion after op `promote_at[k]` (genesis and mid-round)."""
    gen = [led.generation]

    def maybe_promote():
        if led.log_size() in promote_at:
            gen[0] += 1
            assert led.promote_writer(gen[0], gen[0] % 3) == 0
    maybe_promote()
    for a in ADDRS:
        assert led.register_node(a) == 0
        maybe_promote()
    for epoch in range(2):
        committee = led.committee()
        trainers = [a for a in ADDRS if a not in committee]
        for i, a in enumerate(trainers[:2]):
            digest = hashlib.sha256(f"{epoch}-{i}".encode()).digest()
            assert led.upload_local_update(a, digest, 10 + i, 0.5 + i,
                                           epoch) == 0
            maybe_promote()
        for j, a in enumerate(committee):
            assert led.upload_scores(a, epoch, [0.1 * j, 0.2 + j]) == 0
            maybe_promote()
        assert led.aggregate_ready()
        model = hashlib.sha256(f"model-{epoch}".encode()).digest()
        assert led.commit_model(model, epoch) == 0
        maybe_promote()


@pytest.mark.parametrize("gen,idx", [(1, 1), (2, 0), (7, 5)])
def test_promote_op_bytes_equal_the_references(gen, idx):
    port, ref = _ledgers()
    for led in (port, ref):
        led._generation = gen - 1      # the fence one below
        assert led.promote_writer(gen, idx) == 0
    assert port.log_op(0) == ref.log_op(0) == encode_promote_op(gen, idx)
    assert port.log_head() == ref.log_head()


@pytest.mark.parametrize("promote_at", [(0,), (0, 9), (4, 7, 16)])
def test_stream_with_promotions_reaches_the_same_head(promote_at):
    port, ref = _ledgers()
    for led in (port, ref):
        _script(led, promote_at)
    assert port.log_size() == ref.log_size()
    assert port.log_head() == ref.log_head()
    fences = sum(port.log_op(i)[0] == 8 for i in range(port.log_size()))
    assert fences == len(promote_at)
    assert (port.generation, port.writer_index) == \
        (ref.generation, ref.writer_index) == (fences, fences % 3)
    assert port.query_global_model() == ref.query_global_model()
    # each package replays the other's ops to the same head and fence
    p2, r2 = _ledgers()
    for i in range(ref.log_size()):
        assert p2.apply_op(ref.log_op(i)) == LedgerStatus.OK
        assert r2.apply_op(port.log_op(i)).name == "OK"
    assert p2.log_head() == r2.log_head() == ref.log_head()
    assert (p2.generation, p2.writer_index) == \
        (r2.generation, r2.writer_index)
    assert p2.verify_log()


@pytest.mark.parametrize("gen,idx", [(2, 1), (0, 1), (1, -1)])
def test_bad_fence_refused_by_both(gen, idx):
    port, ref = _ledgers()
    assert port.promote_writer(gen, idx) == LedgerStatus.BAD_ARG
    assert ref.promote_writer(gen, idx).name == "BAD_ARG"
    assert port.log_size() == ref.log_size() == 0
    # replayed, the malformed fence is refused too
    assert port.apply_op(encode_promote_op(gen, idx)) == LedgerStatus.BAD_ARG
    assert port.apply_op(encode_promote_op(1, 1)[:9]) == LedgerStatus.BAD_ARG


@pytest.mark.parametrize("attach_at", ["genesis", "mid-stream", "save"])
def test_wal_file_is_the_references_byte_for_byte(tmp_path, attach_at):
    port, ref = _ledgers()
    paths = {}
    for name, led in (("port", port), ("ref", ref)):
        paths[name] = str(tmp_path / f"{name}.wal")
        if attach_at == "genesis":
            assert led.attach_wal(paths[name])
        _script(led)
        if attach_at == "mid-stream":
            assert led.attach_wal(paths[name])
            led.close_round()           # NOT_READY: nothing appended
            assert led.promote_writer(led.generation + 1, 2) == 0
        if attach_at == "save":
            led.save_wal(paths[name])
        led.detach_wal()
    with open(paths["port"], "rb") as f:
        got = f.read()
    with open(paths["ref"], "rb") as f:
        want = f.read()
    assert got == want and got.startswith(b"BFLCWAL1")
    assert not os.path.exists(paths["port"] + ".tmp")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_replays_the_others_wal(tmp_path, writer):
    port, ref = _ledgers()
    src = port if writer == "port" else ref
    path = str(tmp_path / "run.wal")
    assert src.attach_wal(path)
    _script(src)
    src.detach_wal()
    for fresh in _ledgers():
        assert fresh.replay_wal(path) == src.log_size()
        assert fresh.log_head() == src.log_head()
        assert fresh.generation == src.generation == 2


def test_torn_trailing_record_is_skipped_as_the_reference_skips_it(
        tmp_path):
    port, _ = _ledgers()
    path = str(tmp_path / "torn.wal")
    port.attach_wal(path)
    _script(port)
    port.detach_wal()
    with open(path, "ab") as f:
        f.write((10 ** 6).to_bytes(8, "little") + b"\x01\x02")   # torn
    fresh, ref = _ledgers()
    assert fresh.replay_wal(path) == ref.replay_wal(path) == port.log_size()
    assert fresh.log_head() == ref.log_head() == port.log_head()


@pytest.mark.parametrize("content", [b"", b"NOTAWAL!" + b"\0" * 16, None])
def test_a_file_that_is_not_a_wal_is_rejected(tmp_path, content):
    path = str(tmp_path / "bad.wal")
    if content is not None:
        with open(path, "wb") as f:
            f.write(content)
    port, ref = _ledgers()
    for led in (port, ref):
        with pytest.raises(ValueError, match="not a bflc WAL"):
            led.replay_wal(path)


def test_wal2_and_compaction_raise_naming_snapshots(tmp_path):
    # snapshots are ported (A9.5): a BFLCWAL2 file whose snapshot state
    # does not decode is refused by both packages, and compact_wal on a
    # ledger with nothing GC'd rewrites the reference's BFLCWAL1 bytes
    path = str(tmp_path / "compact.wal")
    with open(path, "wb") as f:
        f.write(b"BFLCWAL2" + b"\0" * 48)
    port, ref = _ledgers()
    for led in (port, ref):
        with pytest.raises(ValueError, match="compacted-WAL"):
            led.replay_wal(path)
    port, ref = _ledgers()
    files = []
    for led, name in ((port, "port.wal"), (ref, "ref.wal")):
        assert not led.compact_wal()            # nothing attached
        files.append(str(tmp_path / name))
        led.attach_wal(files[-1])
        for a in ADDRS:
            led.register_node(a)
        assert led.compact_wal()
        led.register_node("0x" + "ab" * 20)
        led.detach_wal()
    blobs = [open(f, "rb").read() for f in files]
    assert blobs[0] == blobs[1] and blobs[0].startswith(b"BFLCWAL1")


def test_replay_refusing_an_op_raises(tmp_path):
    port, _ = _ledgers()
    path = str(tmp_path / "run.wal")
    port.attach_wal(path)
    _script(port)
    port.detach_wal()
    fresh, _ = _ledgers()
    fresh.register_node(ADDRS[0])       # the journal's first register
    with pytest.raises(ValueError, match="rejected op 1"):   # is now a
        fresh.replay_wal(path)                               # duplicate


def test_failed_journal_write_detaches_and_keeps_serving(tmp_path):
    class _Broken:
        def write(self, data):
            raise OSError("disk full")

        def flush(self):
            pass

        def close(self):
            pass

    port, _ = _ledgers()
    assert port.attach_wal(str(tmp_path / "run.wal"))
    port._wal = _Broken()
    assert port.register_node(ADDRS[0]) == LedgerStatus.OK
    assert port._wal is None and port._wal_path == ""
    assert port.log_size() == 1
    assert not port.attach_wal(str(tmp_path / "no" / "such" / "dir.wal"))


def test_clone_prefix_is_the_references():
    port, ref = _ledgers()
    for led in (port, ref):
        _script(led)
    for upto in (0, 3, port.log_size() - 1, port.log_size()):
        got = clone_prefix(port, upto, ProtocolConfig(**PROTO))
        want = ref_clone_prefix(ref, upto, RefConfig(**PROTO),
                                backend="python")
        assert got.log_size() == want.log_size() == upto
        assert got.log_head() == want.log_head()
        assert (got.generation, got.epoch) == (want.generation, want.epoch)


def test_decode_op_renders_every_op_as_the_reference():
    port, _ = _ledgers()
    _script(port)
    port.close_round()
    port.reseat_committee(ADDRS[:2])
    ops = [port.log_op(i) for i in range(port.log_size())]
    ops += [b"", b"\x02" + (10 ** 6).to_bytes(8, "little"), b"\x2a"]
    assert {decode_op(op)["op"] for op in ops[:-3]} >= {
        "register", "upload", "scores", "commit", "promote_writer",
        "reseat_committee"}
    for op in ops:
        assert decode_op(op) == ref_decode_op(op), op[:1]
    # the model hash a standby checks a piggybacked model blob against
    commit = next(op for op in ops if op[:1] == b"\x04")
    assert bytes.fromhex(decode_op(commit)["model_hash"]) == commit[1:33]
    assert np.isfinite(decode_op(ops[5]).get("avg_cost", 0.0))
