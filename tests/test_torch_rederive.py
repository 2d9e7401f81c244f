"""The validator re-derivation plane in the port (`bflc_demo_tpu_torch/
rederive/`), held against the reference's `bflc_demo_tpu/rederive/` on
the CPU.

- Bit for bit: the shard map (`shard_coverage`, `leaf_owners`,
  `leaf_shard`, `shard_map`) for every validator count, epoch and key
  list drawn; the mode resolution; `crosscheck_rl`; `derive_leaves`
  (zero substitution on the host leg and on B5's plain version) and
  `rederive_model_flat` against the reference's; the checker's rederive
  leg (`meshagg/check.py`) against the reference tool's writer hashes.
- The reference's drills (`tests/test_rederive.py`) on the port's
  in-thread writer and validators, armed `shard` on the CPU engine: a
  lying writer is refused on a sync commit and on an async drain even
  with one colluding validator; an honest commit's hash armed equals the
  legacy pin's and the reference writer's; a NaN delta certifies under
  the pin and is refused armed; withheld evidence is a counted skip that
  still certifies; the five cell cases give the reference's verdicts;
  the quorum arithmetic.
- Mixed fleets both ways: port validators armed under a reference
  writer, and reference validators armed under a port writer, certify
  the same op stream to the same model hash.
- An armed CPU fleet (`run_federated_processes(..., rederive="shard")`):
  every validator re-derives every commit, none refuses or skips, each
  imported torch; a disarmed validator imports none.
"""

import hashlib
import struct
import sys
import time
from unittest import mock

import numpy as np
import pytest

import bflc_demo_tpu.comm.bft as ref_bft
import bflc_demo_tpu.comm.ledger_service as ref_ls
import bflc_demo_tpu.rederive as ref_rd
import bflc_demo_tpu.rederive.core as ref_core
import bflc_demo_tpu.rederive.shards as ref_shards
import bflc_demo_tpu_torch.comm.bft as bft
import bflc_demo_tpu_torch.comm.ledger_service as ls
import bflc_demo_tpu_torch.rederive as rd
import bflc_demo_tpu_torch.rederive.core as core
import bflc_demo_tpu_torch.rederive.shards as shards
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.comm.identity import (Wallet, _op_bytes,
                                               provision_wallets)
from bflc_demo_tpu_torch.protocol.constants import (ProtocolConfig,
                                                    bft_fault_tolerance,
                                                    bft_quorum)
from bflc_demo_tpu_torch.utils.codecs import (pack_entries, pack_pytree,
                                              unpack_pytree)

CFG_KW = dict(client_num=6, comm_count=2, aggregate_count=2,
              needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**CFG_KW)
N_VALIDATORS = 4        # the reference geometry: f=1, quorum 3


def _init_blob():
    return pack_pytree({"W": np.zeros((5, 2), np.float32),
                        "b": np.zeros((2,), np.float32)})


def _delta_tree(v):
    return {"W": np.full((5, 2), v, np.float32),
            "b": np.full((2,), v * 0.1, np.float32)}


def _sign(w, kind, epoch, payload):
    return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()


def _corrupting_pack(entries):
    """A self-consistent wrong model: the hash matches the corrupted
    blob, so only re-derivation can catch it."""
    e = dict(entries)
    k = sorted(e)[0]
    a = np.array(e[k], np.float32).copy()
    a.flat[0] += np.float32(0.25)
    e[k] = a
    return pack_entries(e)


# --------------------------------------------------- shard map and modes
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 10, 13])
def test_shard_map_is_the_references(n):
    rng = np.random.default_rng(n)
    assert shards.shard_coverage(n) == ref_shards.shard_coverage(n)
    for _ in range(6):
        keys = sorted(f"/leaf{j}" for j in
                      range(int(rng.integers(1, 40))))
        epoch = int(rng.integers(0, 1000))
        assert shards.shard_map(keys, n, epoch) == \
            ref_shards.shard_map(keys, n, epoch)
        for j in range(len(keys)):
            assert shards.leaf_owners(j, n, epoch) == \
                ref_shards.leaf_owners(j, n, epoch)
        count = {k: 0 for k in keys}
        for shard in shards.shard_map(keys, n, epoch).values():
            for k in shard:
                count[k] += 1
        if n > 1:
            assert set(count.values()) == {shards.shard_coverage(n)}
    with pytest.raises(ValueError):
        shards.shard_coverage(0)


def test_mode_resolution_is_the_references(monkeypatch):
    monkeypatch.delenv("BFLC_REDERIVE_LEGACY", raising=False)
    assert rd.REDERIVE_MODES == ref_rd.REDERIVE_MODES
    for value in (None, "off", "shard", "FULL", " full ", "bogus"):
        if value is None:
            monkeypatch.delenv("BFLC_REDERIVE", raising=False)
        else:
            monkeypatch.setenv("BFLC_REDERIVE", value)
        for legacy in ("", "1"):
            monkeypatch.setenv("BFLC_REDERIVE_LEGACY", legacy)
            assert (rd.rederive_mode(), rd.rederive_armed()) == \
                (ref_rd.rederive_mode(), ref_rd.rederive_armed())


def test_crosscheck_rl_is_the_references():
    rng = np.random.default_rng(3)
    for _ in range(20):
        rls = {v: {f"/k{j}": ("%016x" % int(rng.integers(0, 3)))
                   for j in range(int(rng.integers(0, 6)))}
               for v in range(int(rng.integers(0, 5)))}
        assert core.crosscheck_rl(rls) == ref_core.crosscheck_rl(rls)


# ------------------------------------------------- the validator's merge
@pytest.mark.parametrize("mesh_leg", [False, True])
def test_derive_leaves_zero_substitution_is_the_references(monkeypatch,
                                                            mesh_leg):
    """Unselected slots never need their blobs: one zeros row stands in,
    byte for byte the reference's derive_leaves, on the host leg and on
    B5's plain version."""
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1" if mesh_leg else "64")
    engine = MeshAggEngine("cpu")
    rng = np.random.default_rng(5)
    g = {"/a": rng.standard_normal((4, 3)).astype(np.float32),
         "/b": rng.standard_normal((7,)).astype(np.float32),
         "/c": rng.standard_normal((2, 2)).astype(np.float32)}
    flats = [{k: rng.standard_normal(np.asarray(v).shape)
              .astype(np.float32) for k, v in g.items()}
             for _ in range(5)]
    flats[3]["/a"][0, 0] = np.float32(-0.0)
    weights = [3.0, 5.0, 2.0, 9.0, 4.0]
    selected = [1, 3]
    want = engine.aggregate_flat(g, flats, weights, selected, 0.1)
    masked = [f if i in selected else None for i, f in enumerate(flats)]
    for keys in (sorted(g), ["/b"], ["/a", "/c"]):
        for blocks in (1, 2, 8):
            got = core.derive_leaves(g, masked, weights, selected, 0.1,
                                     keys, blocks=blocks, engine=engine)
            ref = ref_core.derive_leaves(g, masked, weights, selected, 0.1,
                                         keys, blocks=blocks)
            assert sorted(got) == sorted(keys)
            for k in keys:
                assert got[k].tobytes() == np.asarray(want[k]).tobytes() \
                    == np.asarray(ref[k]).tobytes()
    assert engine.calls.get("mesh" if mesh_leg else "host", 0) > 0


def _ref_writer_hashes(kind, trials, seed, max_n):
    """The reference tool's writer hash per trial, by its own functions
    on the same seed (the tool itself reports only mismatches)."""
    sys.path.insert(0, "tools")
    import check_reduction_spec as tool

    from bflc_demo_tpu.meshagg.engine import ENGINE
    from bflc_demo_tpu.utils.serialization import (densify_entries,
                                                   dequantize_entries,
                                                   pack_entries as rpack,
                                                   quantize_entries,
                                                   unpack_pytree as runpack)
    rng = np.random.default_rng(seed)
    out = []
    with np.errstate(over="ignore", invalid="ignore"):
        for _t in range(trials):
            g, _, weights, selected, lr, quant, density, codec = \
                tool._scenario(rng, max_n)
            shapes = {k: np.asarray(v).shape for k, v in g.items()}
            if kind == "transition":
                d_pre = (1.0, 0.1)[int(rng.integers(0, 2))]
                d_post = (0.1, 0.05, 0.01)[int(rng.integers(0, 3))]
                c_pre = ("topk", "sketch")[int(rng.integers(0, 2))]
                c_post = ("topk", "sketch")[int(rng.integers(0, 2))]
                cut = int(rng.integers(0, len(weights) + 1))
            blobs = []
            for i in range(len(weights)):
                flat = {k: (rng.standard_normal(shp)
                            * 10.0 ** float(rng.integers(-6, 6))
                            ).astype(np.float32)
                        for k, shp in shapes.items()}
                if kind == "transition":
                    density, codec = ((d_pre, c_pre) if i < cut
                                      else (d_post, c_post))
                blobs.append(rpack(quantize_entries(
                    tool._sparse_image(flat, density, codec), quant)))
            decoded = [densify_entries(dequantize_entries(runpack(b)))
                       for b in blobs]
            w_out = ENGINE.aggregate_flat(g, decoded, weights, selected, lr)
            out.append(hashlib.sha256(rpack(w_out)).hexdigest())
            if kind == "rederive":
                rng.integers(0, 50)         # the trial's shard epoch
    return out


@pytest.mark.parametrize("kind", ["rederive", "transition"])
def test_check_legs_hold_against_the_reference_tool(monkeypatch, kind):
    """`meshagg/check.py`'s two new legs: no mismatch on B5's plain
    version, and each trial's committed hash is the reference tool's on
    the same seed (whose own leg reports no mismatch either)."""
    from bflc_demo_tpu_torch.meshagg import check
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    sys.path.insert(0, "tools")
    import check_reduction_spec as tool
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    engine = MeshAggEngine("cpu")
    if kind == "rederive":
        out = check.run_rederive_differential(engine, trials=4, seed=3,
                                              max_n=10)
        ref = tool.run_rederive_differential(trials=4, seed=3, max_n=10)
    else:
        out = check.run_density_transition_differential(
            engine, trials=4, seed=5, max_n=10)
        ref = tool.run_density_transition_differential(trials=4, seed=5,
                                                       max_n=10)
    assert out["mismatches"] == [] and ref["mismatches"] == []
    assert out["hashes"] == _ref_writer_hashes(kind, 4, out["seed"], 10)
    assert engine.calls.get("mesh", 0) + engine.calls.get("blocked", 0) > 0


def test_rederive_model_flat_is_the_references():
    rng = np.random.default_rng(9)
    g = {"/w": rng.standard_normal((6, 4)).astype(np.float32),
         "/v": rng.standard_normal((3,)).astype(np.float32)}
    blobs = [pack_entries({k: rng.standard_normal(v.shape)
                           .astype(np.float32) for k, v in g.items()})
             for _ in range(4)]
    for selected in ([0], [1, 2], [0, 1, 2, 3]):
        got = core.rederive_model_flat(pack_entries(g), blobs,
                                       [1.0, 2.0, 3.0, 4.0], selected, 0.3)
        ref = ref_core.rederive_model_flat(pack_entries(g), blobs,
                                           [1.0, 2.0, 3.0, 4.0], selected,
                                           0.3)
        assert pack_entries(got) == pack_entries(ref)


# ------------------------------------------------------------ the drills
class _Fleet:
    """An in-thread writer of `writer` ("port"/"reference") with
    validators of the given packages and modes (the reference's drill
    harness): real sockets, every validator on the CPU."""

    def __init__(self, modes, cfg_kw=None, bft_timeout_s=1.5,
                 seed=b"rd-01", writer="port", packages=None):
        cfg_kw = dict(CFG_KW, **(cfg_kw or {}))
        packages = packages or ["port"] * len(modes)
        self.init = _init_blob()
        vwallets, self.vkeys = bft.provision_validators(len(modes), seed)
        self.nodes = []
        for i, w in enumerate(vwallets):
            if packages[i] == "port":
                node = bft.ValidatorNode(
                    ProtocolConfig(**cfg_kw), w, i,
                    validator_keys=self.vkeys,
                    initial_model_blob=self.init, rederive=modes[i],
                    device="cpu")
            else:
                rw = ref_bft.provision_validators(len(modes), seed)[0][i]
                node = ref_bft.ValidatorNode(
                    RefConfig(**cfg_kw), rw, i, validator_keys=self.vkeys,
                    initial_model_blob=self.init, rederive=modes[i])
            node.start()
            self.nodes.append(node)
        eps = [(v.host, v.port) for v in self.nodes]
        if writer == "port":
            self.server = ls.LedgerServer(
                ProtocolConfig(**cfg_kw), self.init, bft_validators=eps,
                bft_keys=self.vkeys, bft_timeout_s=bft_timeout_s,
                device="cpu")
            self.client_cls = ls.CoordinatorClient
        else:
            self.server = ref_ls.LedgerServer(
                RefConfig(**cfg_kw), self.init, bft_validators=eps,
                bft_keys=self.vkeys, bft_timeout_s=bft_timeout_s,
                ledger_backend="python")
            self.client_cls = ref_ls.CoordinatorClient
        self.server.start()
        self.client = self.client_cls(self.server.host, self.server.port)
        self.cfg = ProtocolConfig(**cfg_kw)
        self.wallets, _ = provision_wallets(self.cfg.client_num,
                                            seed + b"-clients")

    def register_all(self):
        for w in self.wallets:
            r = self.client.request(
                "register", addr=w.address, pubkey=w.public_bytes.hex(),
                tag=_sign(w, "register", 0, b""))
            assert r["ok"] or r["status"] in ("ALREADY_REGISTERED",
                                              "DUPLICATE"), r

    def drive_round(self, epoch, delta_of=None, scores_of=None):
        """One sync round; returns the last scores reply (it carries
        the commit's certification)."""
        committee = set(self.client.request("committee")["committee"])
        trainers = [w for w in self.wallets if w.address not in committee]
        nu = self.cfg.needed_update_count
        for i, w in enumerate(trainers[:nu]):
            tree = (delta_of(i) if delta_of is not None
                    else _delta_tree(0.1 * (i + 1) + epoch))
            blob = pack_pytree(tree)
            d = hashlib.sha256(blob).digest()
            payload = d + struct.pack("<qd", 10 + i, 1.0)
            r = self.client.request(
                "upload", addr=w.address, blob=blob, hash=d.hex(),
                n=10 + i, cost=1.0, epoch=epoch,
                tag=_sign(w, "upload", epoch, payload))
            assert r["ok"] or r["status"] == "DUPLICATE", r
        last = None
        for j, w in enumerate([w for w in self.wallets
                               if w.address in committee]):
            row = (scores_of(j) if scores_of is not None
                   else [0.5 + 0.01 * (j + u) for u in range(nu)])
            payload = struct.pack(f"<{nu}d", *row)
            last = self.client.request(
                "scores", addr=w.address, epoch=epoch, scores=row,
                tag=_sign(w, "scores", epoch, payload))
        return last

    def model_hash(self):
        return self.client.request("model", meta=1)["hash"]

    def stats(self):
        return [v._rederiver.stats for v in self.nodes
                if v._rederiver is not None]

    def close(self):
        self.client.close()
        self.server.close()
        for v in self.nodes:
            v.close()


@pytest.fixture
def b5_leg(monkeypatch):
    """Every merge, the validators' too, on the engine's kernel leg (B5's
    plain version on the CPU), as the fleet legs pin it on the card."""
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY", raising=False)
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")


def test_sync_lie_fails_even_with_a_colluding_validator(monkeypatch,
                                                        b5_leg):
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    fleet = _Fleet(["off", "shard", "shard", "shard"])
    try:
        fleet.register_all()
        with mock.patch.object(ls, "pack_entries", _corrupting_pack):
            last = fleet.drive_round(0)
        assert last["status"] == "CERT_TIMEOUT", last
        info = fleet.client.request("info")
        assert info["certified_size"] < info["log_size"]
        refusals = sum(s["refused"] for s in fleet.stats())
        assert refusals >= bft_fault_tolerance(N_VALIDATORS) + 1
        assert all(s["refusals"].get("mismatch", 0) == s["refused"]
                   for s in fleet.stats())
    finally:
        fleet.close()


def test_async_drain_lie_fails_certification(monkeypatch, b5_leg):
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    fleet = _Fleet(["shard"] * 4, cfg_kw=dict(async_buffer=3,
                                              max_staleness=5),
                   seed=b"rd-async")
    try:
        fleet.register_all()
        last = None
        with mock.patch.object(ls, "pack_entries", _corrupting_pack):
            for i, w in enumerate(fleet.wallets[:3]):
                blob = pack_pytree(_delta_tree(0.1 * (i + 1)))
                d = hashlib.sha256(blob).digest()
                payload = d + struct.pack("<qd", 10 + i, 1.0)
                last = fleet.client.request(
                    "aupload", addr=w.address, blob=blob, hash=d.hex(),
                    n=10 + i, cost=1.0, base_epoch=0,
                    tag=_sign(w, "aupload", 0, payload))
        assert last["status"] == "CERT_TIMEOUT", last
        assert sum(s["refused"] for s in fleet.stats()) >= 2
    finally:
        fleet.close()


def test_honest_hash_armed_equals_the_legacy_pin_and_the_references(
        monkeypatch, b5_leg):
    """Byte-identical committed hashes armed, under the legacy pin and
    on the reference's writer; the armed validators re-derived every
    commit (no skip) and their digest vectors agreed."""
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    monkeypatch.delenv("BFLC_REDERIVE_LEGACY", raising=False)
    hashes = {}
    armed = _Fleet(["shard"] * 4, seed=b"rd-gold")
    try:
        armed.register_all()
        for ep in range(2):
            assert armed.drive_round(ep)["ok"]
        hashes["armed"] = armed.model_hash()
        for s in armed.stats():
            assert s["ok"] == 2 and s["refused"] == 0 \
                and s["skipped"] == 0, s
        assert armed.server._bft.crosscheck["disagree"] == 0
        assert armed.server._bft.crosscheck["ok"] >= 1
    finally:
        armed.close()
    monkeypatch.setenv("BFLC_REDERIVE_LEGACY", "1")
    for name, writer in (("legacy", "port"), ("reference", "reference")):
        fleet = _Fleet(["shard"] * 4, seed=b"rd-gold", writer=writer)
        try:
            fleet.register_all()
            for ep in range(2):
                assert fleet.drive_round(ep)["ok"]
            hashes[name] = fleet.model_hash()
            assert all(v._rederiver is None for v in fleet.nodes)
        finally:
            fleet.close()
    assert hashes["armed"] == hashes["legacy"] == hashes["reference"]


def test_poisoned_nan_delta_refused_when_armed(monkeypatch, b5_leg):
    def nan_delta(i):
        t = _delta_tree(0.1 * (i + 1))
        if i == 0:
            t["W"] = t["W"].copy()
            t["W"][0, 0] = np.float32("nan")
        return t

    def winning_scores(_j):
        return [1.0, 0.5, 0.4]          # slot 0 (the NaN) selected

    monkeypatch.setenv("BFLC_REDERIVE_LEGACY", "1")
    legacy = _Fleet(["shard"] * 4, seed=b"rd-nan")
    try:
        legacy.register_all()
        assert legacy.drive_round(0, delta_of=nan_delta,
                                  scores_of=winning_scores)["ok"]
        assert legacy.client.request("info")["epoch"] == 1
    finally:
        legacy.close()
    monkeypatch.delenv("BFLC_REDERIVE_LEGACY", raising=False)
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    armed = _Fleet(["shard"] * 4, seed=b"rd-nan")
    try:
        armed.register_all()
        last = armed.drive_round(0, delta_of=nan_delta,
                                 scores_of=winning_scores)
        assert last["status"] == "CERT_TIMEOUT", last
        st = armed.stats()
        assert sum(s["refused"] for s in st) >= 2
        assert sum(s["refusals"].get("nonfinite", 0) for s in st) >= 2
    finally:
        armed.close()


def test_withheld_evidence_is_a_counted_skip_that_certifies(monkeypatch,
                                                            b5_leg):
    monkeypatch.delenv("BFLC_REDERIVE", raising=False)   # writer disarmed
    fleet = _Fleet(["shard"] * 4, seed=b"rd-degrade")
    try:
        fleet.register_all()
        t0 = time.monotonic()
        assert fleet.drive_round(0)["ok"]
        assert time.monotonic() - t0 < 10.0
        assert fleet.client.request("info")["epoch"] == 1
        for s in fleet.stats():
            assert s["skipped"] >= 1 and s["refused"] == 0, s
            assert s["skips"] == {"claimed_model_unavailable": 1}, s
    finally:
        fleet.close()


@pytest.mark.parametrize("writer,validators", [
    ("reference", ["port", "port", "reference", "reference"]),
    ("port", ["reference", "reference", "port", "port"])])
def test_mixed_fleets_certify_the_same_stream(monkeypatch, writer,
                                              validators):
    """Armed validators of both packages under a writer of either: every
    op certifies, every armed validator re-derived both commits (the
    port's per-leaf digests agree with the reference's), and the model
    hash is the plain port run's."""
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    fleet = _Fleet(["shard"] * 4, seed=b"rd-mixed", writer=writer,
                   packages=validators)
    try:
        fleet.register_all()
        for ep in range(2):
            assert fleet.drive_round(ep)["ok"]
        info = fleet.client.request("info")
        deadline = time.monotonic() + 10
        while info["certified_size"] != info["log_size"] and \
                time.monotonic() < deadline:
            time.sleep(0.05)
            info = fleet.client.request("info")
        assert info["certified_size"] == info["log_size"]
        for s in fleet.stats():
            assert s["ok"] == 2 and s["refused"] == 0 \
                and s["skipped"] == 0, s
        got = fleet.model_hash()
    finally:
        fleet.close()
    monkeypatch.setenv("BFLC_REDERIVE_LEGACY", "1")
    plain = _Fleet(["off"] * 4, seed=b"rd-mixed")
    try:
        plain.register_all()
        for ep in range(2):
            assert plain.drive_round(ep)["ok"]
        assert plain.model_hash() == got
    finally:
        plain.close()


# --------------------------------------------------------- the cell tier
def _cell_scenario(package, tamper=False, break_tag=False):
    """The reference's cell scenario (`tests/test_rederive.py:420-483`)
    built from the same seeds, checked by a `Rederiver` of `package`
    with a stub fetcher."""
    from bflc_demo_tpu_torch.hier.partial import (cell_evidence_digest,
                                                  cell_partial,
                                                  partial_blob)
    from bflc_demo_tpu_torch.ledger.base import encode_upload_op
    from bflc_demo_tpu_torch.meshagg.engine import engine_for
    rng = np.random.default_rng(11)
    members = [Wallet.from_seed(b"cell-m|%d" % i) for i in range(3)]
    cepoch, cell_index = 2, 1
    listing, blobs, admitted = [], {}, []
    for i, w in enumerate(members):
        tree = {"W": rng.standard_normal((5, 2)).astype(np.float32),
                "b": rng.standard_normal((2,)).astype(np.float32)}
        blob = pack_pytree(tree)
        h = hashlib.sha256(blob).digest()
        n, cost = 10 + i, 1.0 + 0.1 * i
        tag = _sign(w, "upload", cepoch, h + struct.pack("<qd", n, cost))
        listing.append([w.address, h.hex(), n, cost, tag,
                        w.public_bytes.hex()])
        blobs[h.hex()] = blob
        admitted.append((w.address, unpack_pytree(blob), n, cost))
    medians, selected = [0.9, 0.8, 0.7], [0, 1, 2]
    digest = cell_evidence_digest(
        cepoch, cell_index,
        [(s, bytes.fromhex(h), n, c) for s, h, n, c, _t, _p in listing],
        medians, selected)
    partial, n_clients, cost = cell_partial(admitted,
                                            engine=engine_for("cpu"))
    if tamper:
        partial = dict(partial)
        k0 = sorted(partial)[0]
        partial[k0] = np.asarray(partial[k0]).copy()
        partial[k0].flat[0] += np.float32(1.0)
    pblob = partial_blob(partial, cell_index, n_clients, digest)
    agg = Wallet.from_seed(b"cell-agg-1")
    op = encode_upload_op(agg.address, hashlib.sha256(pblob).digest(),
                          n_clients, cost, 7)
    ev = {"epoch": cepoch, "updates": listing, "medians": medians,
          "selected": selected, "read_ep": ["127.0.0.1", 1]}
    if break_tag:
        ev["updates"][1][4] = "00" * 64
    auth = {"blob": pblob.hex(), "cell": ev}
    registry = {agg.address: (cell_index, 8)}
    if package == "port":
        r = core.Rederiver("shard", 0, 4, CFG, cell_registry=registry,
                           device="cpu")
    else:
        r = ref_core.Rederiver("shard", 0, 4, RefConfig(**CFG_KW),
                               cell_registry=registry)

    class _Stub:
        cache = None

        def fetch(self, hashes, rs, co):
            return {h: blobs[h] for h in hashes}

        def close(self):
            pass

    r.fetcher = _Stub()
    return r, op, auth


@pytest.mark.parametrize("case", ["honest", "tampered", "bad_tag",
                                  "no_evidence", "digest_binding"])
def test_cell_cases_give_the_references_verdicts(case):
    verdicts = {}
    for package in ("port", "reference"):
        r, op, auth = _cell_scenario(package, tamper=case == "tampered",
                                     break_tag=case == "bad_tag")
        if case == "no_evidence":
            auth = {"blob": auth["blob"]}
        if case == "digest_binding":
            auth["cell"]["medians"] = [0.1, 0.1, 0.1]
        verdicts[package] = (r.check_cell(op, auth), r.stats["cell_ok"],
                             r.stats["cell_skipped"])
    assert verdicts["port"] == verdicts["reference"]
    err = verdicts["port"][0]
    want = {"honest": "", "tampered": "not the deterministic FedAvg",
            "bad_tag": "tag unverifiable", "no_evidence": "",
            "digest_binding": "#cellmeta digest"}[case]
    assert want in err and (err == "") == (want == "")


def test_quorum_arithmetic_is_the_references():
    for n in (4, 7, 10, 13):
        f, q, c = (bft_fault_tolerance(n), bft_quorum(n),
                   shards.shard_coverage(n))
        assert (c - f) >= f + 1 and n - (c - f) < q
        assert c == ref_shards.shard_coverage(n)


def test_disarmed_validator_imports_no_torch():
    """A validator process with the plane off never imports torch (the
    import scan runs in a fresh interpreter)."""
    import subprocess
    code = ("import sys\n"
            "from bflc_demo_tpu_torch.comm.bft import ValidatorNode\n"
            "from bflc_demo_tpu_torch.comm.identity import Wallet\n"
            "from bflc_demo_tpu_torch.protocol.constants import "
            "ProtocolConfig\n"
            "v = ValidatorNode(ProtocolConfig(), Wallet.from_seed(b'v'), 0,"
            " rederive='off')\n"
            "v.close()\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "False"


# -------------------------------------------------------- an armed fleet
def test_armed_cpu_fleet_rederives_every_commit(monkeypatch):
    """The deployment shape: OS-process clients, a standby and 4
    validators armed `shard` on the CPU: every validator re-derived
    every commit, refusing and skipping none, and imported torch; its
    engine took the kernel leg (B5's plain version here, which counts no
    launch) once a commit at least."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    cfg = ProtocolConfig(client_num=4, comm_count=2, aggregate_count=2,
                         needed_update_count=2, learning_rate=0.05,
                         batch_size=32, local_epochs=2).validate()
    xtr, ytr, xte, yte = load_occupancy()
    parts = iid_shards(np.asarray(xtr[:800]), np.asarray(ytr[:800]),
                       cfg.client_num)
    res = run_federated_processes(
        "make_softmax_regression", parts,
        (np.asarray(xte[:400]), np.asarray(yte[:400])), cfg, rounds=2,
        bft_validators=4, standbys=1, rederive="shard", timeout_s=240,
        device="cpu")
    assert res.rounds_completed >= 2
    assert res.certified_size == res.ledger_log_size
    commits = res.rounds_completed
    for v in range(4):
        rep = res.validator_reports[f"validator-{v}"]
        assert rep["torch_imported"]
        st = rep["rederive"]
        assert st["mode"] == "shard"
        assert st["ok"] >= commits and st["refused"] == 0 \
            and st["skipped"] == 0, st
        assert rep["engine"]["calls"]["mesh"] >= commits
        assert f"validator-{v}" in res.kernel_launches
    assert res.final_accuracy > 0.5


def test_armed_hier_fleet_rederives_every_cell_partial(monkeypatch):
    """The cell leg end to end: 2 cells under a root with 4 validators
    armed `shard` on the CPU, the aggregators shipping member-signed
    evidence: every validator re-derived every cell partial and every
    root commit, refusing and skipping none."""
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, learning_rate=0.05,
                         batch_size=16).validate()
    xtr, ytr, xte, yte = load_occupancy()
    parts = iid_shards(np.asarray(xtr[:900]), np.asarray(ytr[:900]), 6)
    res = run_federated_hier(
        "make_softmax_regression", parts,
        (np.asarray(xte[:300]), np.asarray(yte[:300])), cfg, rounds=2,
        cells=3, bft_validators=4, rederive="shard", timeout_s=240,
        device="cpu")
    assert res.rounds_completed >= 2
    assert res.certified_size == res.ledger_log_size
    uploads = sum(o["op"] == "upload" for o in res.root_ops)
    for v in range(4):
        st = res.validator_reports[f"validator-{v}"]["rederive"]
        assert st["cell_ok"] >= uploads and st["ok"] >= 2, st
        assert not (st["refused"] or st["skipped"] or st["cell_refused"]
                    or st["cell_skipped"]), st
