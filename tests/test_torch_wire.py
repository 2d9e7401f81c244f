"""The process fleet's byte-level surfaces against the reference's.

- Wire frames (`comm/wire.py`): for seeded messages — plain JSON, the
  binary variant with bytes fields, a compressible body past the
  deflate threshold — the port's frames and the reference's are equal
  byte for byte, and each side decodes the other's frames off a real
  socket pair; the framing guards (the cap, garbage, a lying manifest)
  raise WireError.
- Identity (`comm/identity.py`): `Wallet.from_seed` gives the
  reference's address, public key and signatures under either Ed25519
  backend, and each side verifies the other's signatures and refuses a
  forged one.
- Serialization (`utils/serialization.py`): on reference blobs,
  `pack_entries(unpack_pytree(b)) == b`, and `restore_pytree` and the
  decode chain give the values back; codec-layout entries decode as the
  reference decodes them, a malformed record raising its ValueError.
- The ledger's recovery ops (`ledger/pyledger.py`): close_round,
  reseat_committee and force_aggregate give the reference's op bytes,
  statuses and chained heads on the same sequence, and each side's
  `apply_op` replays the other's op log to the same head.
All bit for bit, on the CPU.
"""

import hashlib
import socket
import struct

import numpy as np
import pytest

from bflc_demo_tpu.comm import identity as ref_id
from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.comm import wire as ref_wire
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref_ser
from bflc_demo_tpu_torch.comm import identity, pure25519, wire
from bflc_demo_tpu_torch.comm.ledger_service import chain_head_at
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import serialization as ser


def _messages():
    rng = np.random.default_rng(11)
    blob = rng.standard_normal(3000).astype(np.float32).tobytes()
    return [
        {"method": "state", "addr": "0x" + "ab" * 20},
        {"method": "scores", "addr": "0x01", "epoch": 3,
         "scores": [float(v) for v in rng.random(10)], "tag": "ff" * 64},
        {"method": "upload", "addr": "0x02", "blob": blob[:200],
         "hash": hashlib.sha256(blob[:200]).hexdigest(), "n": 305,
         "cost": 0.25, "epoch": 0},
        # past the 4 KiB threshold, compressible: a ZIP1 frame
        {"ok": True, "epoch": 2, "hash": "00" * 32, "blob": bytes(20000)},
        # past the threshold, incompressible: sent raw
        {"ok": True, "blob": blob},
        {"ok": True, "ops": ["0" * 80] * 300},
    ]


@pytest.mark.parametrize("i", range(len(_messages())))
def test_frames_equal_the_reference_bytes(i):
    msg = _messages()[i]
    port_body = wire._maybe_compress(wire._encode(msg))
    ref_body = ref_wire._maybe_compress(ref_wire._encode(msg))
    assert port_body == ref_body


@pytest.mark.parametrize("i", range(len(_messages())))
def test_each_side_decodes_the_others_frames(i):
    msg = _messages()[i]
    for send, recv in ((wire.send_msg, ref_wire.recv_msg),
                       (ref_wire.send_msg, wire.recv_msg)):
        a, b = socket.socketpair()
        try:
            send(a, msg)
            assert recv(b) == msg
        finally:
            a.close()
            b.close()


def test_clean_eof_and_framing_guards():
    a, b = socket.socketpair()
    wire.send_msg(a, {"method": "x", "blob": "ab" * 100})
    assert wire.recv_msg(b) == {"method": "x", "blob": "ab" * 100}
    a.close()
    assert wire.recv_msg(b) is None
    b.close()
    for raw in (struct.pack(">I", 1 << 30),                    # over the cap
                struct.pack(">I", 4) + b"\xff\xfe\x00\x01",    # garbage
                # a manifest that claims more tail than the frame holds
                (lambda body: struct.pack(">I", len(body)) + body)(
                    b"\x00BIN1" + struct.pack(">I", 24)
                    + b'{"_bin":[["blob",999]]}' + b" " + b"xy")):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            with pytest.raises(wire.WireError):
                wire.recv_msg(b)
        finally:
            a.close()
            b.close()


def test_split_blob_parts_keeps_only_verified_parts():
    good, bad = b"alpha", b"beta"
    reply = {"parts": [[hashlib.sha256(good).hexdigest(), 5],
                       ["00" * 32, 4]], "blob": good + bad}
    assert wire.split_blob_parts(reply) == \
        ref_wire.split_blob_parts(reply) == \
        {hashlib.sha256(good).hexdigest(): good}


@pytest.mark.parametrize("seed", [b"net-master-000001", b"\x00" * 8,
                                  b"process-federation-master-0001"
                                  + struct.pack("<q", 5)])
def test_wallets_match_the_reference(seed):
    port, ref = identity.Wallet.from_seed(seed), ref_id.Wallet.from_seed(seed)
    assert port.address == ref.address
    assert port.public_bytes == ref.public_bytes
    assert identity.address_of(port.public_bytes) == \
        ref_id.address_of(ref.public_bytes)
    msg = identity._op_bytes("upload", port.address, 3, b"\x01" * 48)
    assert msg == ref_id._op_bytes("upload", ref.address, 3, b"\x01" * 48)
    sig = port.sign(msg)
    assert sig == ref.sign(msg)
    # the pure-Python backend gives the same bytes as the wheel
    sk = hashlib.sha256(b"bflc-ed25519|" + seed).digest()
    assert pure25519.ed25519_public(sk) == port.public_bytes
    assert pure25519.ed25519_sign(sk, msg) == sig
    # each side verifies the other's signature, and neither a forged
    # signature nor another key passes
    assert identity.verify_signature(ref.public_bytes, msg, ref.sign(msg))
    assert ref_id.verify_signature(port.public_bytes, msg, sig)
    forged = bytes([sig[0] ^ 1]) + sig[1:]
    assert not identity.verify_signature(port.public_bytes, msg, forged)
    assert not pure25519.ed25519_verify(port.public_bytes, msg, forged)
    other = identity.Wallet.from_seed(seed + b"x")
    assert not identity.verify_signature(other.public_bytes, msg, sig)


def test_directory_and_replay_guard_match_the_reference():
    wallets, directory = identity.provision_wallets(4, b"gas-auth-master-01")
    ref_wallets, ref_dir = ref_id.provision_wallets(4, b"gas-auth-master-01")
    assert directory.export_raw() == ref_dir.export_raw()
    w = wallets[2]
    msg = identity._op_bytes("register", w.address, 0, b"")
    assert directory.verify(w.address, msg, w.sign(msg))
    assert not directory.verify(wallets[1].address, msg, w.sign(msg))
    guard = identity.ReplayGuard()
    guard.consume(0, 0, b"t0")
    guard.consume(0, 1, b"t1")
    assert guard.seen(0, b"t0") and guard.seen(1, b"t1")
    guard.consume(1, 1, b"t2")              # epoch 0's bucket is pruned
    assert not guard.seen(0, b"t0") and guard.seen(1, b"t2")


def _reference_blobs():
    ref = ref_transformer(attention_impl="einsum", vocab_size=64,
                          seq_len=16, num_classes=2, dim=16, depth=1,
                          heads=2)
    params = ref.init_params(3)
    return [ref_ser.pack_pytree(params),
            ref_ser.pack_pytree({"W": np.arange(10, dtype=np.float32)
                                 .reshape(5, 2),
                                 "b": np.zeros(2, np.float32)}),
            ref_ser.pack_entries({"x": np.arange(6, dtype=np.int32),
                                  "y": np.ones((2, 3), np.float32)})]


@pytest.mark.parametrize("i", range(3))
def test_blob_round_trip_on_reference_blobs(i):
    blob = _reference_blobs()[i]
    flat = ser.unpack_pytree(blob)
    ref_flat = ref_ser.unpack_pytree(blob)
    assert list(flat) == list(ref_flat)
    for k in flat:
        assert flat[k].dtype == ref_flat[k].dtype
        assert flat[k].tobytes() == ref_flat[k].tobytes()
    assert ser.pack_entries(flat) == blob
    # the decode chain is the identity on a dense blob's entries (a new
    # mapping of the same arrays, as the reference's)
    dec = ser.densify_entries(ser.dequantize_entries(flat))
    assert list(dec) == list(flat)
    assert all(dec[k] is flat[k] for k in flat)
    assert ser.pack_entries(dec) == blob


def test_restore_pytree_gives_the_model_its_values():
    blob = _reference_blobs()[0]
    model = make_transformer_classifier(vocab_size=64, seq_len=16,
                                        num_classes=2, dim=16, depth=1,
                                        heads=2)
    template = model.init_params(0)
    params = ser.restore_pytree(template, ser.unpack_pytree(blob))
    assert list(params) == list(template)
    assert ser.pack_pytree(params) == blob
    with pytest.raises(KeyError):
        ser.restore_pytree({**template, "['extra']": template["['head']"
                                                              "['b']"]},
                           ser.unpack_pytree(blob))


def test_codec_layouts_raise_naming_the_item():
    """The codecs are ported (ROADMAP A9 item 7): an f16 leaf and an i8
    leaf with its scale decode as the reference's do, and a malformed
    `#topk` record (3 indices for 2 values) raises the reference's
    ValueError."""
    for flat in ({"['W']": np.arange(3, dtype=np.float16)},
                 {"['W']": np.arange(-1, 2, dtype=np.int8),
                  "['W']#qscale": np.full((), 0.5, np.float32)}):
        got = ser.densify_entries(ser.dequantize_entries(flat))
        want = ref_ser.densify_entries(ref_ser.dequantize_entries(flat))
        assert list(got) == list(want) == ["['W']"]
        assert got["['W']"].dtype == np.float32
        assert got["['W']"].tobytes() == want["['W']"].tobytes()
    bad = {"['W']": np.zeros(2, np.float32),
           "['W']#topk": np.zeros(4, np.uint32)}
    with pytest.raises(ValueError) as want:
        ref_ser.densify_entries(ref_ser.dequantize_entries(bad))
    with pytest.raises(ValueError, match="3 indices for 2 values") as got:
        ser.densify_entries(ser.dequantize_entries(bad))
    assert str(got.value) == str(want.value)


CFG = dict(client_num=6, comm_count=2, aggregate_count=2,
           needed_update_count=3, learning_rate=0.05, batch_size=16)


def _drive(led, addrs):
    """A sequence through every recovery op; the statuses in order."""
    out = [led.register_node(a) for a in addrs]
    out.append(led.close_round())                 # no updates: NOT_READY
    committee = led.committee()
    trainers = [a for a in addrs if a not in committee]
    h = [hashlib.sha256(bytes([i])).digest() for i in range(8)]
    out += [led.upload_local_update(trainers[0], h[0], 50, 0.5, 0),
            led.upload_local_update(trainers[1], h[1], 60, 0.25, 0)]
    out.append(led.close_round())                 # 2 of 3: closes
    out.append(led.upload_local_update(trainers[2], h[2], 70, 0.1, 0))
    out.append(led.reseat_committee([trainers[3], addrs[0]]))
    out.append(led.reseat_committee(["0xnobody"]))   # BAD_ARG
    out.append(led.upload_scores(trainers[3], 0, [0.9, 0.1]))
    out.append(led.force_aggregate())             # fires with one row
    out.append(led.force_aggregate())             # pending: NOT_READY
    out.append(led.commit_model(h[3], 0))
    # round 1: the committee dies, reseat, and force the row present
    c1 = led.committee()
    t1 = [a for a in addrs if a not in c1]
    out += [led.upload_local_update(t, h[4 + j], 40, 0.3, 1)
            for j, t in enumerate(t1[:3])]
    out.append(led.reseat_committee(t1[3:4]))
    out.append(led.upload_scores(t1[3], 1, [0.2, 0.8, 0.5]))
    out.append(led.commit_model(h[7], 1))
    return [LedgerStatus(int(s)).name for s in out]


def test_recovery_ops_give_the_reference_ops_and_heads():
    addrs = [f"0x{i:040x}" for i in range(6)]
    port, ref = make_ledger(ProtocolConfig(**CFG)), \
        ref_make_ledger(RefConfig(**CFG), backend="python")
    assert _drive(port, addrs) == _drive(ref, addrs)
    assert port.log_size() == ref.log_size()
    for i in range(ref.log_size()):
        assert port.log_op(i) == ref.log_op(i)
    assert port.log_head() == ref.log_head()
    assert chain_head_at(port, port.log_size()) == port.log_head()
    assert chain_head_at(port, 3) == ref_ls.chain_head_at(ref, 3)
    assert port.verify_log() and port.epoch == ref.epoch == 2
    assert port.round_closed == ref.round_closed
    assert port.num_registered == ref.num_registered
    assert {o[0] for o in (port.log_op(i) for i in range(port.log_size()))} \
        >= {1, 2, 3, 4, 5, 6, 7}
    # each side replays the other's op log to the same head
    again = make_ledger(ProtocolConfig(**CFG))
    ref_again = ref_make_ledger(RefConfig(**CFG), backend="python")
    for i in range(ref.log_size()):
        assert again.apply_op(ref.log_op(i)) == LedgerStatus.OK
        assert ref_again.apply_op(port.log_op(i)) == LedgerStatus.OK
    assert again.log_head() == ref_again.log_head() == ref.log_head()
    # a malformed or unported opcode is refused, not applied
    for op in (b"", bytes([8]) + bytes(16), bytes([9]) + bytes(40),
               bytes([5]) + struct.pack("<q", 99), bytes([1]) + bytes(3)):
        assert again.apply_op(op) == LedgerStatus.BAD_ARG
    assert again.log_head() == ref.log_head()


def test_make_ledger_backends():
    assert make_ledger(ProtocolConfig(**CFG), backend="python").epoch == -999
    # the native ledger (once refused here) and auto, which gives it
    for backend in ("native", "auto"):
        led = make_ledger(ProtocolConfig(**CFG), backend=backend)
        assert led.backend == "native" and led.epoch == -999
    with pytest.raises(ValueError):
        make_ledger(ProtocolConfig(**CFG), backend="rocksdb")
