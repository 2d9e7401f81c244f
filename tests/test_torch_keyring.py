"""The HMAC keyring, the authenticated ledger and the wallets' X25519
half: the port's `comm/identity.py` against the reference's.

Byte for byte: every tag (`KeyRing.mac` and the `sign_*` helpers, HMAC
and Ed25519), every X25519 public key and pair secret, under the
`cryptography` wheel and the pure-Python backend alike.  Then the
reference's `tests/test_identity.py` scenarios on the port's classes:
the keyring, a wrong key, tag binding, replay, a retry after a transient
rejection, the threaded runtime with a keyring, wallets signing only for
their own address, the `PublicDirectory` variant and a full
authenticated round; and tags crossing packages (a port tag verifies at
the reference's authenticated ledger and back).
"""

import struct

import numpy as np
import pytest

from bflc_demo_tpu.comm import identity as ref_identity
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.protocol import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm import identity
from bflc_demo_tpu_torch.comm.identity import (AuthenticatedLedger, KeyRing,
                                               _op_bytes, provision_wallets,
                                               sign_register, sign_scores,
                                               sign_upload)
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig

GEOMETRY = dict(client_num=6, comm_count=2, aggregate_count=2,
                needed_update_count=3)
CFG = ProtocolConfig(**GEOMETRY)
MASTER = b"master-seed-0123456789abcdef"


def addr(i):
    return f"0x{i:03x}"


@pytest.fixture
def auth_led():
    keys = KeyRing(MASTER)
    return AuthenticatedLedger(make_ledger(CFG, backend="python"), keys), keys


# ------------------------------------------------------- byte for byte
@pytest.mark.parametrize("kind", ["register", "upload", "scores"])
def test_keyring_tags_equal_the_reference(kind):
    port, ref = KeyRing(MASTER), ref_identity.KeyRing(MASTER)
    assert port.secret_for("0x001") == ref.secret_for("0x001")
    args = {"register": ("0x00a",),
            "upload": ("0x00b", b"\3" * 32, 137, 0.625, 4),
            "scores": ("0x00c", 7, [0.5, 0.25, 1.0])}[kind]
    sign = {"register": (sign_register, ref_identity.sign_register),
            "upload": (sign_upload, ref_identity.sign_upload),
            "scores": (sign_scores, ref_identity.sign_scores)}[kind]
    assert sign[0](port, *args) == sign[1](ref, *args)
    assert len(sign[0](port, *args)) == 32


def test_wallet_dh_halves_and_pair_secrets_equal_the_reference():
    port, _ = provision_wallets(4, b"dh-master-seed-000001")
    ref, _ = ref_identity.provision_wallets(4, b"dh-master-seed-000001")
    for p, r in zip(port, ref):
        assert p.dh_public_bytes == r.dh_public_bytes
        assert p.public_bytes == r.public_bytes and p.address == r.address
    for i in range(4):
        for j in range(4):
            if i != j:
                for ctx in (b"", b"round7", struct.pack("<q", 3)):
                    assert port[i].pair_secret(
                        port[j].dh_public_bytes, context=ctx) == \
                        ref[i].pair_secret(ref[j].dh_public_bytes,
                                           context=ctx)


def test_both_backends_give_the_same_dh_bytes(monkeypatch):
    w = identity.Wallet.from_seed(b"backend-a")
    v = identity.Wallet.from_seed(b"backend-b")
    want = (w.dh_public_bytes, w.pair_secret(v.dh_public_bytes, b"ctx"))
    monkeypatch.setattr(identity, "ED25519_BACKEND", "pure-python")
    w2 = identity.Wallet.from_seed(b"backend-a")
    v2 = identity.Wallet.from_seed(b"backend-b")
    assert (w2.dh_public_bytes,
            w2.pair_secret(v2.dh_public_bytes, b"ctx")) == want


def test_wallet_mac_tags_equal_the_reference():
    port, _ = provision_wallets(2, b"ed-master-seed-000001")
    ref, _ = ref_identity.provision_wallets(2, b"ed-master-seed-000001")
    ob = _op_bytes("upload", port[0].address, 0, b"\1" * 32)
    assert port[0].mac(port[0].address, ob) == ref[0].mac(ref[0].address, ob)


# --------------------------------------- the reference's scenarios
def test_keyring_deterministic_distinct():
    k = KeyRing(MASTER)
    assert k.secret_for("0x001") == k.secret_for("0x001")
    assert k.secret_for("0x001") != k.secret_for("0x002")
    with pytest.raises(ValueError):
        KeyRing(b"short")


def test_valid_round_trip(auth_led):
    led, keys = auth_led
    for i in range(CFG.client_num):
        assert led.register_node(addr(i), sign_register(keys, addr(i))) \
            == LedgerStatus.OK
    assert led.epoch == 0
    st = led.upload_local_update(
        addr(3), b"\1" * 32, 100, 1.5, 0,
        sign_upload(keys, addr(3), b"\1" * 32, 100, 1.5, 0))
    assert st == LedgerStatus.OK


def test_wrong_key_rejected(auth_led):
    led, _ = auth_led
    impostor = KeyRing(b"some-other-master-seed-xxxxx")
    st = led.register_node(addr(0), sign_register(impostor, addr(0)))
    assert st == LedgerStatus.BAD_ARG
    assert led.num_registered == 0


def test_tag_bound_to_content(auth_led):
    led, keys = auth_led
    for i in range(CFG.client_num):
        led.register_node(addr(i), sign_register(keys, addr(i)))
    tag = sign_upload(keys, addr(3), b"\1" * 32, 100, 1.5, 0)
    assert led.upload_local_update(addr(3), b"\2" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.BAD_ARG
    assert led.upload_local_update(addr(3), b"\1" * 32, 100, 1.5, 1,
                                   tag) == LedgerStatus.BAD_ARG
    assert led.upload_local_update(addr(4), b"\1" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.BAD_ARG
    assert led.update_count == 0


def test_replay_rejected(auth_led):
    led, keys = auth_led
    for i in range(CFG.client_num):
        led.register_node(addr(i), sign_register(keys, addr(i)))
    tag = sign_upload(keys, addr(3), b"\1" * 32, 100, 1.5, 0)
    assert led.upload_local_update(addr(3), b"\1" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.OK
    assert led.upload_local_update(addr(3), b"\1" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.DUPLICATE


def test_retry_after_transient_rejection_allowed(auth_led):
    """A tag is consumed only once the op is accepted: scores refused as
    NOT_READY may be resent with the same tag after close_round."""
    led, keys = auth_led
    for i in range(CFG.client_num):
        led.register_node(addr(i), sign_register(keys, addr(i)))
    for i in (2, 3):
        h = bytes([i]) * 32
        led.upload_local_update(addr(i), h, 100, 1.0, 0,
                                sign_upload(keys, addr(i), h, 100, 1.0, 0))
    comm = led.committee()[0]
    scores = [0.5, 0.7]
    tag = sign_scores(keys, comm, 0, scores)
    assert led.upload_scores(comm, 0, scores, tag) == LedgerStatus.NOT_READY
    assert led.close_round() == LedgerStatus.OK
    assert led.upload_scores(comm, 0, scores, tag) == LedgerStatus.OK


@pytest.mark.parametrize("backend", ["python", "native"])
def test_threaded_runtime_authenticated(backend):
    """The threaded runtime with a keyring: every client op carries a tag
    through the locked boundary, the run commits its rounds, and an
    op with a wrong tag at its ledger is refused."""
    from bflc_demo_tpu_torch.client.threaded import ThreadedFederation
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:2000], ytr[:2000], CFG.client_num)
    keys = KeyRing(b"threaded-master-seed-123456")
    fed = ThreadedFederation(make_softmax_regression(), shards,
                             (xte[:500], yte[:500]), CFG,
                             ledger_backend=backend, keyring=keys,
                             device="cpu")
    res = fed.run(rounds=2, timeout_s=120)
    assert res.rounds_completed == 2 and res.ledger.verify_log()
    assert not fed.client_errors
    node = fed.nodes[0]
    assert node.keyring is keys
    body = (b"\5" * 32, 10, 1.0, fed.ledger.epoch)
    assert fed.ledger.upload_local_update(
        node.address, *body,
        sign_upload(KeyRing(b"not-the-fleet-master-seed-1"), node.address,
                    *body)) == LedgerStatus.BAD_ARG


def test_wallet_sign_verify_and_forgery():
    wallets, directory = provision_wallets(3, b"ed-master-seed-000001")
    w = wallets[0]
    ob = _op_bytes("upload", w.address, 0, b"\1" * 32)
    tag = w.mac(w.address, ob)
    assert directory.verify(w.address, ob, tag)
    assert not directory.verify(w.address, ob + b"x", tag)
    assert not directory.verify(wallets[1].address, ob, tag)
    assert not directory.verify(w.address, ob, b"\0" * 64)
    assert w.address == identity.address_of(w.public_bytes)
    with pytest.raises(ValueError):
        w.mac(wallets[1].address, ob)


def test_pair_secret_agreement():
    wallets, _ = provision_wallets(3, b"dh-master-seed-000001")
    a, b, c = wallets
    s_ab = a.pair_secret(b.dh_public_bytes, context=b"round7")
    assert s_ab == b.pair_secret(a.dh_public_bytes, context=b"round7")
    assert s_ab != a.pair_secret(c.dh_public_bytes, context=b"round7")
    assert s_ab != a.pair_secret(b.dh_public_bytes, context=b"round8")


def test_authenticated_ledger_with_directory():
    wallets, directory = provision_wallets(CFG.client_num,
                                           b"dir-master-seed-000001")
    led = AuthenticatedLedger(make_ledger(CFG, backend="python"), directory)
    for w in wallets:
        assert led.register_node(w.address, sign_register(w, w.address)) \
            == LedgerStatus.OK
    assert led.epoch == 0
    w = wallets[3]
    tag = sign_upload(w, w.address, b"\1" * 32, 100, 1.5, 0)
    assert led.upload_local_update(w.address, b"\1" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.OK
    assert led.upload_local_update(w.address, b"\1" * 32, 100, 1.5, 0,
                                   tag) == LedgerStatus.DUPLICATE
    forged = wallets[4].sign(_op_bytes(
        "upload", w.address, 0, b"\2" * 32 + struct.pack("<qd", 50, 1.0)))
    assert led.upload_local_update(w.address, b"\2" * 32, 50, 1.0, 0,
                                   forged) == LedgerStatus.BAD_ARG


def test_full_authenticated_round(auth_led):
    led, keys = auth_led
    for i in range(CFG.client_num):
        led.register_node(addr(i), sign_register(keys, addr(i)))
    for i in (2, 3, 4):
        h = bytes([i]) * 32
        assert led.upload_local_update(
            addr(i), h, 100 + i, 1.0, 0,
            sign_upload(keys, addr(i), h, 100 + i, 1.0, 0)) \
            == LedgerStatus.OK
    rng = np.random.default_rng(0)
    for c in led.committee():
        scores = [float(s) for s in rng.random(3)]
        assert led.upload_scores(c, 0, scores,
                                 sign_scores(keys, c, 0, scores)) \
            == LedgerStatus.OK
    assert led.aggregate_ready()
    # the writer's own ops pass through unauthenticated
    assert led.commit_model(b"\x09" * 32, 0) == LedgerStatus.OK
    assert led.epoch == 1 and led.verify_log()


# ----------------------------------------------------- across packages
@pytest.mark.parametrize("direction", ["port_tags_at_reference",
                                       "reference_tags_at_port"])
def test_tags_cross_packages(direction):
    """A round signed by one package's keyring is accepted, op for op, by
    the other package's authenticated ledger, and the two ledgers' chains
    are the same bytes."""
    port_keys, ref_keys = KeyRing(MASTER), ref_identity.KeyRing(MASTER)
    port_led = AuthenticatedLedger(make_ledger(CFG, backend="python"),
                                   port_keys)
    ref_led = ref_identity.AuthenticatedLedger(
        ref_make_ledger(RefConfig(**GEOMETRY), backend="python"), ref_keys)
    signer = (identity if direction == "port_tags_at_reference"
              else ref_identity)
    keys = port_keys if signer is identity else ref_keys
    for led in (port_led, ref_led):
        for i in range(CFG.client_num):
            assert int(led.register_node(
                addr(i), signer.sign_register(keys, addr(i)))) == 0
        for i in (2, 3, 4):
            h = bytes([i]) * 32
            assert int(led.upload_local_update(
                addr(i), h, 100, 1.0, 0,
                signer.sign_upload(keys, addr(i), h, 100, 1.0, 0))) == 0
        for c in sorted(led.committee()):
            assert int(led.upload_scores(
                c, 0, [0.5, 0.25, 0.75],
                signer.sign_scores(keys, c, 0, [0.5, 0.25, 0.75]))) == 0
    assert port_led.log_head() == ref_led.log_head()
