"""Async committee re-election (`async_reseat_every`) in the port,
against the reference, on the CPU.

The non-chaos classes of the reference's `tests/test_reseat.py` case for
case on the port's ledger: the reseat rule (every R-th drain reseats
from the drained window's median-score ranking, topped up from the
incumbents), its determinism across shuffled arrivals, replicas,
snapshot-restored standbys and a WAL rejoin mid-window, the lying
writer's seating refused, and the byte pins of R = 0 (the reference's
golden digests) and `BFLC_ASYNC_LEGACY`.  Each scripted run also goes
through the reference's ledger: the same heads, state bytes and
committees, and the extended opcode-12 bodies decode alike.
"""

import dataclasses
import hashlib
import random
import struct

import pytest

from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger.tool import decode_op as ref_decode_op
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.ledger import (LedgerStatus, async_enabled,
                                        make_ledger)
from bflc_demo_tpu_torch.ledger.base import OP_ACOMMIT, _put_str, decode_op
from bflc_demo_tpu_torch.ledger.snapshot import decode_state, restore_snapshot
from bflc_demo_tpu_torch.protocol import ProtocolConfig

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16,
             async_buffer=3, max_staleness=4, async_reseat_every=2)
RCFG = ProtocolConfig(**PROTO).validate()


def _h(tag) -> bytes:
    return hashlib.sha256(repr(tag).encode()).digest()


def _led(cfg=RCFG, maker=make_ledger):
    led = maker(cfg)
    for i in range(cfg.client_num):
        assert led.register_node(f"c{i}") == LedgerStatus.OK
    return led


def _drain(led, senders, scores=None, scorer=None):
    """One buffered round: fill from `senders`, optionally score every
    live entry, drain all of them."""
    ep = led.epoch
    for j, s in enumerate(senders):
        assert led.async_upload(s, _h((ep, s)), 10 + j, 1.0,
                                ep) == LedgerStatus.OK
    if scores is not None:
        who = scorer or led.committee()[0]
        live = [e.aseq for e in led.async_buffer_view()]
        assert led.async_scores(who, list(zip(live, scores))) == \
            LedgerStatus.OK
    assert led.async_commit(_h(("m", ep)), ep,
                            len(senders)) == LedgerStatus.OK


def _replay(led, cfg=RCFG, maker=make_ledger):
    replica = maker(cfg)
    for i in range(led.log_size()):
        assert replica.apply_op(led.log_op(i)) == LedgerStatus.OK
    return replica


def _same_as_reference(led, cfg=RCFG):
    """The reference's ledger replays the port's chain to its head,
    state bytes and committee; every op decodes alike."""
    ref = _replay(led, RefConfig(**dataclasses.asdict(cfg)),
                  ref_make_ledger)
    assert ref.log_head() == led.log_head()
    assert ref.encode_state() == led.encode_state()
    assert ref.committee() == led.committee()
    for i in range(led.log_size()):
        assert decode_op(led.log_op(i)) == ref_decode_op(led.log_op(i))


class TestReseatRule:
    def test_due_schedule_and_seating_from_window(self):
        led = _led()
        genesis_committee = led.committee()
        assert not led.async_reseat_due()
        _drain(led, ["c0", "c1", "c2"], [0.5, 0.5, 0.5])
        assert led.committee() == genesis_committee
        assert led.async_reseat_due()
        ep = led.epoch
        for j, s in enumerate(["c3", "c4", "c5"]):
            assert led.async_upload(s, _h((ep, s)), 10 + j, 1.0,
                                    ep) == LedgerStatus.OK
        live = [e.aseq for e in led.async_buffer_view()]
        assert led.async_scores(
            led.committee()[0],
            list(zip(live, [0.1, 0.9, 0.6]))) == LedgerStatus.OK
        assert led.derive_async_seats(3) == ["c4", "c5"]
        assert led.async_commit(_h(("m", ep)), ep, 3) == LedgerStatus.OK
        assert set(led.committee()) == {"c4", "c5"}
        assert not led.async_reseat_due()
        _same_as_reference(led)

    def test_unscored_window_tops_up_from_incumbents(self):
        led = _led()
        _drain(led, ["c0", "c1", "c2"])
        ep = led.epoch
        assert led.async_reseat_due()
        for s in ["c3", "c4"]:
            assert led.async_upload(s, _h((ep, s)), 10, 1.0,
                                    ep) == LedgerStatus.OK
        derived = led.derive_async_seats(2)
        assert len(derived) == RCFG.comm_count
        assert derived == ["c3", "c4"]              # aseq order at 0.0
        assert led.async_commit(_h(("m", ep)), ep, 2) == LedgerStatus.OK
        assert set(led.committee()) == set(derived)
        _same_as_reference(led)


class TestReseatDeterminismProperty:
    """Every role derives the identical seating: full-chain replicas,
    snapshot-restored standbys joining mid-window and the writer, across
    randomized arrival orders and scorings."""

    @pytest.mark.parametrize("seed", range(4))
    def test_shuffled_arrivals_replica_and_snapshot_agree(self, seed):
        rng = random.Random(seed)
        led = _led()
        mid, mid_pos = None, 0
        for r in range(6):
            senders = rng.sample([f"c{i}" for i in range(6)], 3)
            scores = [round(rng.random(), 3) for _ in senders]
            scorer = rng.choice(led.committee())
            _drain(led, senders, scores, scorer)
            if r == 2:
                mid_pos = led.log_size()
                mid = restore_snapshot(led.encode_state(), RCFG, mid_pos,
                                       led.log_head())
                assert mid.async_reseat_due() == led.async_reseat_due()
        replica = _replay(led)
        assert replica.log_head() == led.log_head()
        assert replica.state_digest() == led.state_digest()
        assert replica.committee() == led.committee()
        for i in range(mid_pos, led.log_size()):
            assert mid.apply_op(led.log_op(i)) == LedgerStatus.OK
        assert mid.log_head() == led.log_head()
        assert mid.state_digest() == led.state_digest()
        assert mid.committee() == led.committee()
        _same_as_reference(led)

    def test_crash_rejoin_mid_window_via_wal(self, tmp_path):
        """A writer crash between the (R-1)-th and R-th drain: the WAL
        replay restores the drain counter, so the rejoined ledger reseats
        on the drain the dead one would have; the reference replays the
        same journal to the same head."""
        path = str(tmp_path / "reseat.wal")
        led = _led()
        assert led.attach_wal(path)
        _drain(led, ["c0", "c1", "c2"], [0.5, 0.4, 0.3])
        due_before = led.async_reseat_due()
        assert due_before
        led.detach_wal()
        risen = make_ledger(RCFG)
        assert risen.replay_wal(path) > 0
        assert risen.log_head() == led.log_head()
        assert risen.async_reseat_due() == due_before
        ref_risen = ref_make_ledger(RefConfig(**PROTO))
        assert ref_risen.replay_wal(path) == risen.log_size()
        assert ref_risen.log_head() == risen.log_head()
        _drain(risen, ["c3", "c4", "c5"], [0.2, 0.9, 0.1])
        _drain(led, ["c3", "c4", "c5"], [0.2, 0.9, 0.1])
        assert risen.committee() == led.committee()
        assert set(risen.committee()) == {"c3", "c4"}
        assert risen.log_head() == led.log_head()
        assert risen.state_digest() == led.state_digest()


class TestLyingWriterRefused:
    """A seating in an extended opcode-12 body is re-derived by every
    replica; disagreement is BAD_ARG, in both packages."""

    def _at_due_drain(self):
        led = _led()
        _drain(led, ["c0", "c1", "c2"], [0.5, 0.4, 0.3])
        replica = _replay(led)
        ref = _replay(led, RefConfig(**PROTO), ref_make_ledger)
        ep = led.epoch
        for j, s in enumerate(["c3", "c4", "c5"]):
            for node in (led, replica, ref):
                assert node.async_upload(s, _h((ep, s)), 10 + j, 1.0,
                                         ep) == LedgerStatus.OK
        assert led.async_reseat_due() and replica.async_reseat_due()
        return led, replica, ref, ep

    @staticmethod
    def _acommit_op(mh, ep, k, seats):
        op = bytearray([OP_ACOMMIT])
        op += mh + struct.pack("<qq", ep, k)
        if seats is not None:
            op += struct.pack("<q", len(seats))
            for a in seats:
                _put_str(op, a)
        return bytes(op)

    def test_forged_seating_refused_then_honest_one_lands(self):
        led, replica, ref, ep = self._at_due_drain()
        honest = led.derive_async_seats(3)
        lie = ["c0", "c1"]
        assert lie != honest
        before = replica.state_digest()
        for node in (replica, ref):
            assert node.apply_op(self._acommit_op(
                _h(("m", ep)), ep, 3, lie)) == LedgerStatus.BAD_ARG
            assert node.apply_op(self._acommit_op(
                _h(("m", ep)), ep, 3, None)) == LedgerStatus.BAD_ARG
        assert replica.state_digest() == before
        assert led.async_commit(_h(("m", ep)), ep, 3) == LedgerStatus.OK
        op = led.log_op(led.log_size() - 1)
        assert op == self._acommit_op(_h(("m", ep)), ep, 3, honest)
        for node in (replica, ref):
            assert node.apply_op(op) == LedgerStatus.OK
        assert replica.committee() == led.committee() == honest
        assert ref.log_head() == led.log_head()

    def test_seating_on_a_non_due_drain_refused(self):
        led = _led()
        ep = led.epoch
        for j, s in enumerate(["c0", "c1", "c2"]):
            assert led.async_upload(s, _h((ep, s)), 10 + j, 1.0,
                                    ep) == LedgerStatus.OK
        assert not led.async_reseat_due()
        assert led.apply_op(self._acommit_op(
            _h(("m", ep)), ep, 3, ["c0", "c1"])) == LedgerStatus.BAD_ARG

    def test_malformed_extension_refused(self):
        led, replica, ref, ep = self._at_due_drain()
        good = self._acommit_op(_h(("m", ep)), ep, 3,
                                led.derive_async_seats(3))
        zero = self._acommit_op(_h(("m", ep)), ep, 3, [])
        for node in (replica, ref):
            assert node.apply_op(good + b"\x00") == LedgerStatus.BAD_ARG
            assert node.apply_op(zero) == LedgerStatus.BAD_ARG


class TestLegacyBytePins:
    """R = 0 (the default) and BFLC_ASYNC_LEGACY=1 keep the pre-reseat
    bytes: no drain-counter tail in the state, the reference's golden
    chain and state digests."""

    GOLDEN_R0_HEAD = ("af0cf91c0e7ac131616a4a9c95f07985"
                      "6c5e14e34c30838be89c64f37ab5d714")
    GOLDEN_R0_STATE = ("eaf08845ece8b23bdbf8040973f53250"
                       "206eaf99c886c5cdb19df6345601a324")

    @staticmethod
    def _scripted_r0():
        cfg = dataclasses.replace(RCFG, async_reseat_every=0).validate()
        led = make_ledger(cfg)
        for i in range(cfg.client_num):
            assert led.register_node(f"c{i}") == LedgerStatus.OK
        scorer = led.committee()[0]
        for ep in range(2):
            for j, s in enumerate(["c0", "c1", "c2"]):
                assert led.async_upload(s, _h((ep, s)), 10 + j, 1.0,
                                        ep) == LedgerStatus.OK
            live = [e.aseq for e in led.async_buffer_view()]
            assert led.async_scores(
                scorer, list(zip(live, [0.2, 0.9, 0.5]))) == LedgerStatus.OK
            assert led.async_commit(_h(("m", ep)), ep, 3) == LedgerStatus.OK
        return led

    def test_r0_twin_runs_byte_identical_and_pinned(self):
        a, b = self._scripted_r0(), self._scripted_r0()
        assert a.log_head() == b.log_head()
        assert a.encode_state() == b.encode_state()
        assert a.log_head().hex() == self.GOLDEN_R0_HEAD
        assert hashlib.sha256(
            a.encode_state()).hexdigest() == self.GOLDEN_R0_STATE
        assert decode_state(a.encode_state())["async_acommits"] is None
        assert not a.async_reseat_due()

    def test_r_positive_state_carries_and_restores_the_counter(self):
        led = _led()
        _drain(led, ["c0", "c1", "c2"], [0.5, 0.4, 0.3])
        assert decode_state(led.encode_state())["async_acommits"] == 1
        r = restore_snapshot(led.encode_state(), RCFG, led.log_size(),
                             led.log_head())
        assert led.async_reseat_due()
        assert r.async_reseat_due()
        assert r.encode_state() == led.encode_state()

    def test_async_legacy_env_disables_the_reseat_family(self, monkeypatch):
        monkeypatch.setenv("BFLC_ASYNC_LEGACY", "1")
        assert not async_enabled(RCFG)
        assert make_ledger(RCFG).backend == "native"
        led = make_ledger(RCFG, backend="python")
        assert led.async_buffer == 0 and led.async_reseat_every == 0

    def test_reseat_requires_async_buffer(self):
        for cfg in (RCFG, RefConfig(**PROTO)):
            with pytest.raises(ValueError, match="async_reseat_every"):
                dataclasses.replace(cfg, async_buffer=0,
                                    async_reseat_every=2).validate()
