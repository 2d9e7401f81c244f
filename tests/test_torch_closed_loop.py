"""The closed compression loop in the port (`control/loop.py`, opcode 13
in `ledger/`, the `GNM1` snapshot tail, the writer's proposal and the
clients' effective density), held against the reference's on the CPU.

- Bit for bit: `decide`, `score_disagreement` and `model_telemetry` over
  seeded inputs (the f32 bits); `encode_genome_op` and its replay round
  trip; the genome's checks (`adapt_every`, `density_floor`); the
  encoder's density override (the port's `_DeltaEncoder` against the
  reference's); the `GNM1` state tail, encoded and restored.
- The reference's closed-loop drill (`tests/test_closed_loop.py`) on
  the writers of both packages from the same script: the chains are
  byte-identical op for op, the density moves with no refusal, a fresh
  replica of either package replays the other's chain (opcode 13
  included) to the same head and knobs, and `BFLC_ADAPT_LEGACY=1` pins
  the static knobs.  An async drill (FedBuff drains, staleness moving)
  through both writers gives one chain too.
- A lying writer's genome op (a wrong output, a wrong input) is refused
  by a port validator, the honest op signed; opcode 13 refuses on a
  static chain.
- The CLI: `--runtime processes --bft-validators 4 --rederive shard
  --adapt-every 2 --density-floor 0.01` on a sparse genome runs on the
  CPU (it exited 2 before), puts genome ops on a fully certified chain
  and every validator re-derives every commit; `--rederive` without
  validators exits 2, as in the reference.
"""

import dataclasses
import hashlib
import json
import struct
import subprocess
import sys

import numpy as np
import pytest

import bflc_demo_tpu.comm.ledger_service as ref_ls
import bflc_demo_tpu.control.loop as ref_loop
import bflc_demo_tpu.ledger.snapshot as ref_snap
import bflc_demo_tpu.utils.serialization as ref_ser
import bflc_demo_tpu_torch.comm.ledger_service as ls
import bflc_demo_tpu_torch.control.loop as loop
import bflc_demo_tpu_torch.ledger.snapshot as snap
import bflc_demo_tpu_torch.utils.codecs as ser
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.ledger.base import encode_genome_op as ref_genome_op
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.ledger.base import (OP_GENOME, adapt_enabled,
                                             decode_op, encode_genome_op)
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

DRILL_KW = dict(client_num=8, comm_count=2, aggregate_count=4,
                needed_update_count=4, delta_density=0.08,
                density_floor=0.01)


# -------------------------------------------------------- the rule's bits
@pytest.mark.parametrize("seed", range(6))
def test_rule_functions_are_the_references_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        k, m = int(rng.integers(0, 7)), int(rng.integers(0, 6))
        rows = (rng.standard_normal((m, k)) * 10.0 **
                float(rng.integers(-3, 2))).tolist()
        if m > 1 and rng.integers(0, 5) == 0:
            rows[-1] = rows[-1][:-1]            # ragged
        a, b = loop.score_disagreement(rows), \
            ref_loop.score_disagreement(rows)
        assert a.tobytes() == b.tobytes()
        dens = float(np.float32(rng.uniform(0.01, 1.0)))
        stale = int(rng.integers(0, 40))
        tele = [float(v) for v in rng.standard_normal(3) * 0.3]
        if rng.integers(0, 6) == 0:
            tele[int(rng.integers(0, 3))] = float(
                rng.choice([np.inf, -np.inf, np.nan]))
        kw = dict(density_floor=0.01, density_cap=float(
            max(dens, 0.05)), staleness_cap=int(rng.integers(0, 30)))
        got = loop.decide(dens, stale, *tele, **kw)
        want = ref_loop.decide(dens, stale, *tele, **kw)
        assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    shapes = {"/w": (int(rng.integers(1, 40)), 3), "/b": (5,),
              "/i": (2,)}
    old = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    new = {k: (v + rng.standard_normal(v.shape).astype(np.float32)
               * np.float32(0.01)) for k, v in old.items()}
    old["/i"] = new["/i"] = np.arange(2, dtype=np.int32)
    for got, want in zip(loop.model_telemetry(old, new),
                         ref_loop.model_telemetry(old, new)):
        assert got.tobytes() == want.tobytes()


def test_genome_op_bytes_replay_and_render():
    rng = np.random.default_rng(1)
    for _ in range(20):
        args = (int(rng.integers(0, 100)), float(rng.uniform(0, 1)),
                int(rng.integers(0, 30)), float(rng.standard_normal()),
                float(rng.standard_normal()), float(rng.uniform(0, 1)))
        op = encode_genome_op(*args)
        assert op == ref_genome_op(*args) and op[0] == OP_GENOME == 13
        ep = struct.unpack_from("<q", op, 1)[0]
        nd, = struct.unpack_from("<f", op, 9)
        ns, = struct.unpack_from("<q", op, 13)
        un, dr, di = struct.unpack_from("<fff", op, 21)
        assert encode_genome_op(ep, nd, ns, un, dr, di) == op
        d = decode_op(op)
        assert d["op"] == "genome_update" and d["epoch"] == args[0]
        assert d["staleness"] == args[2] and d["bytes"] == 33


@pytest.mark.parametrize("kw", [
    dict(adapt_every=2), dict(adapt_every=-1, delta_density=0.5),
    dict(density_floor=0.0), dict(density_floor=1.5),
    dict(adapt_every=2, delta_density=0.05, density_floor=0.1),
    dict(adapt_every=2, delta_density=0.05, density_floor=0.01)])
def test_genome_checks_are_the_references(kw):
    def outcome(cls):
        try:
            cls(**kw).validate()
            return "ok"
        except ValueError as e:
            return str(e)
    assert outcome(ProtocolConfig) == outcome(RefConfig)


def test_legacy_pin_and_a_static_chain_refuse_the_loop(monkeypatch):
    cfg = ProtocolConfig(delta_density=0.05, adapt_every=2)
    assert adapt_enabled(cfg)
    led = make_ledger(ProtocolConfig(delta_density=0.05))
    assert led.apply_op(encode_genome_op(1, 0.025, 0, 1.0, 0.0, 0.01)) \
        == LedgerStatus.BAD_ARG
    monkeypatch.setenv("BFLC_ADAPT_LEGACY", "1")
    assert not adapt_enabled(cfg)
    # the pinned static chain: native under auto, as in the reference
    assert make_ledger(cfg).backend == "native"
    assert make_ledger(cfg, backend="python").adapt_every == 0


def test_encoder_density_override_is_the_references(monkeypatch):
    """The served effective density changes the blob's geometry, the
    port's encoder byte for byte the reference's (error feedback armed,
    i8 on a top-k genome)."""
    from bflc_demo_tpu.client.process_runtime import \
        _DeltaEncoder as RefEncoder
    from bflc_demo_tpu_torch.client.process_runtime import _DeltaEncoder
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    kw = dict(delta_density=0.08, delta_dtype="i8")
    rng = np.random.default_rng(7)
    tree = {"W": np.zeros(4000, np.float32), "b": np.zeros(8, np.float32)}
    port, ref = _DeltaEncoder(ProtocolConfig(**kw)), \
        RefEncoder(RefConfig(**kw), tree)
    sizes = []
    for ep, dens in enumerate((0.08, 0.02, 0.02, None)):
        d = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tree.items()}
        got = port.encode({f"['{k}']": v for k, v in d.items()},
                          base_epoch=ep, density=dens)
        assert got == ref.encode(d, base_epoch=ep, density=dens)
        sizes.append(len(got))
    assert sizes[1] < sizes[0]


# ------------------------------------------------------------- the drill
def _drill(package, adapt_every=1, rounds=4, dim=240, seed=11,
           async_buffer=0):
    """The reference's scripted closed-loop federation over a writer's
    `_dispatch` (no sockets, no auth): clients encode at the served
    effective density each round.  Sync, or async with `async_buffer`
    K: K auploads a version drain, the committee scoring the first K-1
    entries first.  Returns (server, densities)."""
    kw = dict(DRILL_KW, adapt_every=adapt_every)
    if async_buffer:
        kw.update(async_buffer=async_buffer, max_staleness=8)
    if package == "port":
        server = ls.LedgerServer(
            ProtocolConfig(**kw),
            ser.pack_pytree({"['W']": np.zeros(dim, np.float32)}),
            require_auth=False, stall_timeout_s=3600.0, device="cpu")
        pack = lambda d, e: ser.pack_sparse({"['W']": d}, e)   # noqa
    else:
        server = ref_ls.LedgerServer(
            RefConfig(**kw),
            ref_ser.pack_pytree({"W": np.zeros(dim, np.float32)}),
            require_auth=False, stall_timeout_s=3600.0,
            ledger_backend="python")
        pack = lambda d, e: ref_ser.pack_sparse({"W": d}, e)   # noqa
    cfg = server.cfg
    base = np.random.default_rng(seed).standard_normal(dim).astype(
        np.float32)
    addrs = [f"c{i:02d}" for i in range(cfg.client_num)]
    for a in addrs:
        assert server._dispatch("register", {"addr": a})["ok"]
    densities = []
    for _ in range(rounds):
        ep = server.ledger.epoch
        st = server._dispatch("state", {"addr": addrs[0]})
        eff = st.get("eff_density", cfg.delta_density)
        densities.append((ep, eff))
        committee = server._dispatch("committee", {})["committee"]
        trainers = sorted(a for a in addrs if a not in committee)
        n_up = async_buffer or cfg.needed_update_count
        for j, a in enumerate(trainers[:n_up]):
            d = (base + 0.3 * np.random.default_rng(
                [addrs.index(a), ep, seed]).standard_normal(dim)
                 ).astype(np.float32)
            blob = pack(d, eff)
            h = hashlib.sha256(blob).hexdigest()
            if not async_buffer:
                r = server._dispatch("upload", {
                    "addr": a, "blob": blob, "hash": h, "n": 10,
                    "cost": 1.0, "epoch": ep})
                assert r["ok"], (a, ep, r)
                continue
            if j == n_up - 1:
                # the committee scores the buffered entries first
                ups = server._dispatch("aupdates", {})["updates"]
                for c, m in enumerate(committee):
                    pairs = [[u["aseq"], 0.9 - 0.1 * c - 0.01 * i]
                             for i, u in enumerate(ups)]
                    assert server._dispatch("ascores", {
                        "addr": m, "pairs": pairs})["ok"]
            r = server._dispatch("aupload", {
                "addr": a, "blob": blob, "hash": h, "n": 10, "cost": 1.0,
                "base_epoch": ep})
            assert r["ok"], (a, ep, r)
        if not async_buffer:
            row = [1.0 - 0.05 * j for j in range(cfg.needed_update_count)]
            for a in committee:
                r = server._dispatch("scores", {"addr": a, "epoch": ep,
                                                "scores": row})
                assert r["ok"], (a, ep, r)
        assert server.ledger.epoch == ep + 1
    return server, densities


@pytest.mark.parametrize("async_buffer", [0, 3])
def test_drill_chains_are_the_references_and_replay_across_packages(
        async_buffer):
    port, pd = _drill("port", async_buffer=async_buffer)
    ref, rd = _drill("reference", async_buffer=async_buffer)
    try:
        assert pd == rd
        pl, rl = port.ledger, ref.ledger
        assert pl.log_size() == rl.log_size()
        assert [pl.log_op(j) for j in range(pl.log_size())] == \
            [rl.log_op(j) for j in range(rl.log_size())]
        assert pl.log_head() == rl.log_head()
        genomes = [pl.log_op(j) for j in range(pl.log_size())
                   if pl.log_op(j)[0] == OP_GENOME]
        assert len(genomes) >= 2
        assert len({e for _, e in pd}) >= 2 and min(e for _, e in pd) \
            < DRILL_KW["delta_density"]
        if async_buffer:
            # the first step from the zero model is unhealthy (drift):
            # the staleness bound halves, then recovers
            assert {struct.unpack_from("<q", op, 13)[0]
                    for op in genomes} >= {4, 8}
        # a fresh replica of either package replays the other's chain
        for src, fresh in ((rl, make_ledger(port.cfg)),
                           (pl, ref_make_ledger(ref.cfg,
                                                backend="python"))):
            for j in range(src.log_size()):
                assert fresh.apply_op(src.log_op(j)) == LedgerStatus.OK
            assert fresh.log_head() == src.log_head()
            assert (fresh.effective_density, fresh.effective_staleness,
                    fresh.genome_epoch) == (src.effective_density,
                                            src.effective_staleness,
                                            src.genome_epoch)
        # the next state poll and `info` serve the post-commit knob
        st = port._dispatch("state", {"addr": "c00"})
        assert st["eff_density"] == pl.effective_density
        info = port._dispatch("info", {})
        assert info["genome_epoch"] == pl.genome_epoch == rl.genome_epoch
        assert [g["new_density"] for g in port.genome_log] == \
            [struct.unpack_from("<f", op, 9)[0] for op in genomes]
    finally:
        port.close()
        ref.close()


def test_adapt_legacy_pins_static_knobs(monkeypatch):
    monkeypatch.setenv("BFLC_ADAPT_LEGACY", "1")
    server, densities = _drill("port", rounds=3)
    try:
        assert all(e == pytest.approx(0.08) for _, e in densities)
        assert all(server.ledger.log_op(j)[0] != OP_GENOME
                   for j in range(server.ledger.log_size()))
    finally:
        server.close()


def test_lying_writer_genome_op_refused_by_a_port_validator():
    from bflc_demo_tpu_torch.comm.bft import ValidatorNode
    from bflc_demo_tpu_torch.comm.identity import Wallet
    server, _ = _drill("port")
    node = None
    try:
        led = server.ledger
        node = ValidatorNode(server.cfg, Wallet.from_seed(b"cl-vtest"), 0,
                             require_auth=False)
        gpos = next(j for j in range(led.log_size())
                    if led.log_op(j)[0] == OP_GENOME)
        for j in range(gpos):
            op = led.log_op(j)
            auth = {}
            if op[0] == 2:
                (slen,) = struct.unpack_from("<q", op, 1)
                h = op[1 + 8 + slen:1 + 8 + slen + 32]
                auth = {"blob": server._op_auth[j]["blob"]}
                assert hashlib.sha256(bytes.fromhex(auth["blob"])) \
                    .digest() == h
            r = node._validate({"i": j, "op": op.hex(), "auth": auth})
            assert r["ok"], (j, r)
        op = led.log_op(gpos)
        ep = struct.unpack_from("<q", op, 1)[0]
        nd, = struct.unpack_from("<f", op, 9)
        ns, = struct.unpack_from("<q", op, 13)
        un, dr, di = struct.unpack_from("<fff", op, 21)
        for lie in (encode_genome_op(ep, nd * 2.0, ns, un, dr, di),
                    encode_genome_op(ep, nd, ns, un, dr, di + 0.5)):
            r = node._validate({"i": gpos, "op": lie.hex()})
            assert not r["ok"] and r["status"] == "BAD_ARG", r
        assert node._validate({"i": gpos, "op": op.hex()})["ok"]
    finally:
        if node is not None:
            node.close()
        server.close()


@pytest.mark.parametrize("async_buffer", [0, 3])
def test_snapshot_genome_tail_is_the_references(async_buffer):
    """The `GNM1` tail: the state bytes of both packages' ledgers after
    the same drill are equal, each decodes the other's, and a ledger
    restored from them continues on the same knobs."""
    port, _ = _drill("port", async_buffer=async_buffer)
    ref, _ = _drill("reference", async_buffer=async_buffer)
    try:
        pl, rl = port.ledger, ref.ledger
        state = pl.encode_state()
        assert state == rl.encode_state()
        assert b"GNM1" in state[-28:-24]
        assert snap.decode_state(state) == ref_snap.decode_state(state)
        assert snap.encode_state_dict(snap.decode_state(state)) == state
        rep = snap.restore_snapshot(state, port.cfg, pl.log_size(),
                                    pl.log_head())
        assert (rep.effective_density, rep.effective_staleness,
                rep.genome_epoch, rep.last_disagreement) == \
            (pl.effective_density, pl.effective_staleness,
             pl.genome_epoch, pl.last_disagreement)
        assert rep.encode_state() == state
    finally:
        port.close()
        ref.close()
    static = make_ledger(ProtocolConfig(delta_density=0.05))
    assert b"GNM1" not in static.encode_state()


# ---------------------------------------------------------------- the CLI
def _cli(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "bflc_demo_tpu_torch", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=timeout,
        env=dict(__import__("os").environ, BFLC_MESH_AGG_MIN="1"))


def test_cli_rederive_needs_validators_and_the_fleet():
    out = _cli(["--runtime", "processes", "--rederive", "shard"])
    assert out.returncode == 2 and "--bft-validators" in out.stderr
    out = _cli(["--rederive", "shard", "--bft-validators", "4"])
    assert out.returncode == 2 and "processes" in out.stderr


def test_cli_closed_loop_with_rederive_runs_on_the_cpu():
    """The tentpole's CLI on a sparse genome: genome ops on a certified
    chain, the density moved, 4 validators re-deriving every commit."""
    out = _cli(["--runtime", "processes", "--rounds", "4",
                "--bft-validators", "4", "--rederive", "shard",
                "--client-num", "8", "--comm-count", "2",
                "--aggregate-count", "2", "--needed-update-count", "3",
                "--learning-rate", "0.05", "--batch-size", "16",
                "--delta-density", "0.1", "--adapt-every", "2",
                "--density-floor", "0.01"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    fleet = res["fleet"]
    assert res["rounds"] >= 4
    assert fleet["certified_size"] == res["ledger_log_size"]
    assert len(fleet["genomes"]) >= 1
    assert fleet["genomes"][0]["epoch"] == 2
    reports = fleet["validator_reports"]
    assert len(reports) == 4
    for rep in reports.values():
        assert rep["torch_imported"]
        st = rep["rederive"]
        assert st["ok"] >= 4 and st["refused"] == 0 \
            and st["skipped"] == 0, st
