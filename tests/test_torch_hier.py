"""Hierarchical cells in the port (`bflc_demo_tpu_torch/hier/`), held
against the reference's `bflc_demo_tpu/hier/` on the CPU.

The 23 fast scenarios of the reference's `tests/test_hier.py`, each run
through both packages from the same numpy seeds:

- `TestCellPlan`: the plans, the tier genomes (field by field, the
  closed loop's fields included) and the refusals are equal;
- `TestPartialDeterminism`: the partial's bytes, the evidence digest
  and the blob are the reference's, byte for byte, under every arrival
  order; the degenerate sets raise in both;
- `TestCellMeta`: the `#cellmeta` bytes, the split and the op-level
  registry check (`check_cell_upload_op`) give the reference's values
  and reasons;
- `TestRootAdmission`: a root (a `LedgerServer` with the cell registry
  and four `ValidatorNode`s holding it) of each package takes the same
  signed requests: the honest cell op certifies under both and its op
  hash is the same, every refusal carries the same status and reason,
  and a validator refuses an inflated count with `CELL` in both.

Also: `hier/partial.py` and `hier/cells.py` import no torch, and the
port's `cell_partial` sums on the engine it is given (B5's plain version
on a CPU engine) with the host leg's bytes.
"""

import dataclasses
import hashlib
import itertools
import struct
import sys
import types

import numpy as np
import pytest

import bflc_demo_tpu.comm.bft as ref_bft
import bflc_demo_tpu.comm.identity as ref_identity
import bflc_demo_tpu.comm.ledger_service as ref_ls
import bflc_demo_tpu.hier.cells as ref_cells
import bflc_demo_tpu.hier.partial as ref_partial
import bflc_demo_tpu.ledger.base as ref_base
import bflc_demo_tpu.protocol.constants as ref_constants
import bflc_demo_tpu.utils.serialization as ref_ser
import bflc_demo_tpu_torch.comm.bft as bft
import bflc_demo_tpu_torch.comm.identity as identity
import bflc_demo_tpu_torch.comm.ledger_service as ls
import bflc_demo_tpu_torch.hier.cells as cells
import bflc_demo_tpu_torch.hier.partial as partial
import bflc_demo_tpu_torch.ledger.base as base
import bflc_demo_tpu_torch.protocol.constants as constants
import bflc_demo_tpu_torch.utils.codecs as ser

PKG = {
    "port": types.SimpleNamespace(
        cells=cells, partial=partial, ser=ser, bft=bft, identity=identity,
        ls=ls, base=base, Config=constants.ProtocolConfig,
        server_kw={"device": "cpu"}),
    "reference": types.SimpleNamespace(
        cells=ref_cells, partial=ref_partial, ser=ref_ser, bft=ref_bft,
        identity=ref_identity, ls=ref_ls, base=ref_base,
        Config=ref_constants.ProtocolConfig, server_kw={}),
}
BOTH = ("port", "reference")


def _outcome(fn):
    """('ok', value) or ('raise', exception type name)."""
    try:
        return ("ok", fn())
    except Exception as e:                      # noqa: BLE001
        return ("raise", type(e).__name__)


def _same(fn):
    """fn(pkg namespace) through both packages: the outcomes are equal;
    returns the port's."""
    got = _outcome(lambda: fn(PKG["port"]))
    want = _outcome(lambda: fn(PKG["reference"]))
    assert got == want, (got, want)
    return got


def _genome(c) -> dict:
    """The genome's fields (the port carries all of the reference's)."""
    return {f.name: getattr(c, f.name)
            for f in dataclasses.fields(constants.ProtocolConfig)}


class TestCellPlan:
    def test_deterministic_and_covering(self):
        def run(p):
            a = p.cells.plan_cells(20, cells=4)
            assert a == p.cells.plan_cells(20, cells=4)
            flat = [i for m in a.members for i in m]
            assert sorted(flat) == list(range(20))
            assert all(len(m) == 5 for m in a.members)
            return (a.members, a.n_cells, a.cell_of(0), a.cell_of(19),
                    a.sibling_of(3))
        assert _same(run) == ("ok", (tuple(tuple(range(5 * c, 5 * c + 5))
                                           for c in range(4)),
                                     4, 0, 3, 0))

    def test_remainder_spread(self):
        assert _same(lambda p: [len(m) for m in
                                p.cells.plan_cells(10, cells=3).members]) \
            == ("ok", [4, 3, 3])

    def test_cell_size_route(self):
        def run(p):
            a = p.cells.plan_cells(20, cell_size=5)
            assert p.cells.plan_cells(20, cells=4,
                                      cell_size=5).members == a.members
            return a.n_cells, a.members
        assert _same(run)[1][0] == 4

    @pytest.mark.parametrize("kw", [dict(), dict(cells=1), dict(cells=15),
                                    dict(cells=4, cell_size=2)])
    def test_rejects_bad_geometry(self, kw):
        assert _same(lambda p: p.cells.plan_cells(20, **kw)) == \
            ("raise", "ValueError")

    def test_tier_protocols_validate(self):
        def run(p):
            base_cfg = p.Config()
            out = []
            for n_members in (2, 3, 5, 10):
                cc = p.cells.cell_protocol(base_cfg, n_members)
                assert cc.validate() is cc
                out.append(_genome(cc))
            for n_cells in (2, 3, 8, 100):
                rc = p.cells.root_protocol(base_cfg, n_cells)
                assert rc.validate() is rc
                assert rc.needed_update_count == n_cells - rc.comm_count
                out.append(_genome(rc))
            return out
        kind, genomes = _same(run)
        assert kind == "ok" and all(g["delta_dtype"] == "f32"
                                    for g in genomes[4:])

    def test_cell_seed_distinct(self):
        got = _same(lambda p: [p.cells.cell_seed(b"m", c)
                               for c in range(16)])
        assert len(set(got[1])) == 16

    def test_plan_is_frozen(self):
        def run(p):
            plan = p.cells.plan_cells(8, cells=2)
            plan.n_clients = 9
        assert _same(run)[0] == "raise"


def _keyed(d: dict) -> dict:
    """A model dict keyed as the reference's `keystr` paths (the port's
    blobs carry flat keys as given): both packages then encode the same
    canonical bytes."""
    return {f"['{k}']": v for k, v in d.items()}


def _blob(p, d: dict) -> bytes:
    return p.ser.pack_entries(_keyed(d))


def _member_delta(p, v, shape=(3, 2)):
    return p.ser.unpack_pytree(_blob(p, {
        "W": np.full(shape, v, np.float32),
        "b": np.arange(shape[1], dtype=np.float32) * v}))


class TestPartialDeterminism:
    def test_arrival_order_independence(self):
        def run(p):
            admitted = [(f"0x{i:040x}", _member_delta(p, 0.37 * (i + 1)),
                         10 + 3 * i, 1.0 + i) for i in range(4)]
            blobs = set()
            for perm in itertools.permutations(admitted):
                part, n, _ = p.partial.cell_partial(list(perm))
                ev = p.partial.cell_evidence_digest(
                    5, 2, [(a, b"\7" * 32, nn, cc)
                           for a, _, nn, cc in perm],
                    [0.5, 0.25, 0.75, 0.5], [2, 0, 1, 3])
                blobs.add(p.partial.partial_blob(part, 2, n, ev))
            assert len(blobs) == 1
            return blobs.pop()
        kind, blob = _same(run)
        assert kind == "ok" and len(blob) > 0

    def test_weighting_is_sample_weighted_fedavg(self):
        def run(p):
            a = ("0xa", _member_delta(p, 1.0), 30, 1.0)
            b = ("0xb", _member_delta(p, 2.0), 10, 3.0)
            part, n, cost = p.partial.cell_partial([a, b])
            return (n, cost, p.ser.pack_entries(part))
        kind, (n, cost, raw) = _same(run)
        assert n == 2 and cost == pytest.approx(2.0)
        part = ser.unpack_pytree(raw)
        key = [k for k in part if k.endswith("'W']")][0]
        assert np.allclose(part[key], 1.25)    # (30*1 + 10*2) / 40

    @pytest.mark.parametrize("case", ["empty", "duplicate", "zero_weight",
                                      "key_mismatch"])
    def test_rejects_degenerate_sets(self, case):
        def run(p):
            d = ("0xa", _member_delta(p, 1.0), 10, 1.0)
            sets = {"empty": [], "duplicate": [d, d],
                    "zero_weight": [("0xa", _member_delta(p, 1.0), 0, 1.0)],
                    "key_mismatch": [d, ("0xb", {"other": np.zeros(
                        2, np.float32)}, 5, 1.0)]}
            return p.partial.cell_partial(sets[case])
        assert _same(run) == ("raise", "ValueError")

    def test_evidence_digest_sensitivity(self):
        def run(p):
            rec = [("0xa", b"\1" * 32, 10, 1.0)]
            dig = p.partial.cell_evidence_digest
            return [dig(0, 0, rec, [0.5], [0]),
                    dig(0, 0, list(reversed(rec)), [0.5], [0]),
                    dig(1, 0, rec, [0.5], [0]), dig(0, 1, rec, [0.5], [0]),
                    dig(0, 0, rec, [0.6], [0])]
        kind, d = _same(run)
        assert d[1] == d[0] and len({d[0], d[2], d[3], d[4]}) == 4


class TestCellMeta:
    def test_roundtrip(self):
        def run(p):
            ev = hashlib.sha256(b"evidence").digest()
            arr = p.partial.pack_cellmeta(3, 17, ev)
            assert p.partial.unpack_cellmeta(arr) == (3, 17, ev)
            return np.asarray(arr).tobytes()
        assert _same(run)[0] == "ok"

    @pytest.mark.parametrize("case", ["garbage", "short_evidence",
                                      "zero_clients"])
    def test_rejects_garbage(self, case):
        def run(p):
            if case == "garbage":
                return p.partial.unpack_cellmeta(np.zeros(57, np.uint8))
            if case == "short_evidence":
                return p.partial.pack_cellmeta(0, 1, b"short")
            return p.partial.pack_cellmeta(0, 0, b"\0" * 32)
        assert _same(run) == ("raise", "ValueError")

    def test_split(self):
        def run(p):
            ev = b"\5" * 32
            part = _member_delta(p, 1.0)
            blob = p.partial.partial_blob(part, 1, 4, ev)
            flat = p.ser.unpack_pytree(blob)
            assert p.partial.CELLMETA_KEY in flat
            rest, meta = p.partial.split_cellmeta(flat)
            assert meta == (1, 4, ev) and rest.keys() == part.keys()
            rest2, meta2 = p.partial.split_cellmeta(part)
            assert meta2 is None and rest2.keys() == part.keys()
            # the sparse bridge: sparsified before #cellmeta joins
            sparse = p.partial.partial_blob(
                _member_delta(p, 0.5, (40, 8)), 1, 4, ev, density=0.1)
            return blob, sparse
        assert _same(run)[0] == "ok"

    def test_check_cell_upload_op(self):
        def run(p):
            op = p.base.encode_upload_op("0xagg", b"\1" * 32, 5, 1.0, 0)
            check = p.partial.check_cell_upload_op
            return [op, check(op, {"0xagg": (0, 5)}),
                    check(op, {"0xagg": (0, 4)}),
                    check(op, {"0xother": (1, 10)}),
                    check(b"\x01rest", {}), check(b"", {}),
                    check(op[:20], {"0xagg": (0, 5)})]
        kind, r = _same(run)
        assert r[1] == "" and "exceeds registered membership" in r[2]
        assert "not a registered cell aggregator" in r[3]
        assert r[4] == r[5] == ""


# ------------------------------------------------ root admission + BFT
def _model0():
    return {"W": np.zeros((5, 2), np.float32),
            "b": np.zeros((2,), np.float32)}


def _sign(p, w, kind, epoch, payload):
    return w.sign(p.identity._op_bytes(kind, w.address, epoch,
                                       payload)).hex()


class _Root:
    """A thread-served root of one package: 4 validators holding a
    4-cell registry, the server with the registry, one client."""

    def __init__(self, name: str):
        p = self.p = PKG[name]
        base_cfg = p.Config(client_num=8, comm_count=2, aggregate_count=2,
                            needed_update_count=4, learning_rate=0.05,
                            batch_size=16)
        rcfg = p.cells.root_protocol(base_cfg, 4)
        self.wallets = {c: p.identity.Wallet.from_seed(
            p.cells.cell_seed(b"hier-test", c)) for c in range(4)}
        self.registry = {w.address: (c, 2)
                         for c, w in self.wallets.items()}
        vwallets, self.vkeys = p.bft.provision_validators(
            4, b"hier-test-validators")
        self.nodes = [p.bft.ValidatorNode(rcfg, w, i,
                                          validator_keys=self.vkeys,
                                          cell_registry=self.registry)
                      for i, w in enumerate(vwallets)]
        for v in self.nodes:
            v.start()
        self.srv = p.ls.LedgerServer(
            rcfg, _blob(p, _model0()),
            cell_registry=self.registry, ledger_backend="python",
            stall_timeout_s=60.0,
            bft_validators=[(v.host, v.port) for v in self.nodes],
            bft_keys=self.vkeys, **p.server_kw)
        self.srv.start()
        self.client = p.ls.CoordinatorClient(self.srv.host, self.srv.port)

    def register_all(self):
        for w in self.wallets.values():
            self.register(w)

    def register(self, w):
        return self.client.request("register", addr=w.address,
                                   pubkey=w.public_bytes.hex(),
                                   tag=_sign(self.p, w, "register", 0, b""))

    def upload(self, w, blob, n, cost, digest=None):
        digest = digest or hashlib.sha256(blob).digest()
        payload = digest + struct.pack("<qd", n, cost)
        return self.client.request(
            "upload", addr=w.address, blob=blob, hash=digest.hex(), n=n,
            cost=cost, epoch=0, tag=_sign(self.p, w, "upload", 0, payload))

    def close(self):
        self.client.close()
        self.srv.close()
        for v in self.nodes:
            v.close()


@pytest.fixture()
def roots():
    made = {}
    try:
        for name in BOTH:
            made[name] = _Root(name)
        yield made
    finally:
        for r in made.values():
            r.close()


def _cell_op_blob(p, v=0.25, cell=0, n_clients=2, evidence=b"\0" * 32):
    adm = [(f"0xm{j}", p.ser.unpack_pytree(_blob(p, {
        "W": np.full((5, 2), v * (j + 1), np.float32),
        "b": np.zeros((2,), np.float32)})), 10, 1.0)
        for j in range(n_clients)]
    part, n, cost = p.partial.cell_partial(adm)
    return p.partial.partial_blob(part, cell, n_clients, evidence), n, cost


def _reply(r: dict):
    return r.get("ok"), r.get("status"), r.get("error")


class TestRootAdmission:
    def test_honest_cell_op_certifies_byte_compatibly(self, roots):
        """The honest cell op certifies at both roots; the certificate
        verifies under each package's client-side check, bound to the
        same op hash, and the chains agree."""
        hashes, blobs = {}, {}
        for name, root in roots.items():
            p = root.p
            for w in root.wallets.values():
                assert root.register(w)["ok"]
            committee = set(root.client.request("committee")["committee"])
            cell, trainer = next((c, w) for c, w in root.wallets.items()
                                 if w.address not in committee)
            blob, n, cost = _cell_op_blob(p, cell=cell)
            digest = hashlib.sha256(blob).digest()
            r = root.upload(trainer, blob, n, cost)
            assert r["ok"] and r.get("cert") is not None, r
            fields = dict(addr=trainer.address, hash=digest.hex(), n=n,
                          cost=cost, epoch=0)
            want = p.bft.expected_op_hash("upload", fields)
            assert p.bft.verify_certificate_sigs(r["cert"], 3, root.vkeys,
                                                 op_hash=want)
            # the other package's check accepts it too
            other = PKG["reference" if name == "port" else "port"]
            assert other.bft.verify_certificate_sigs(
                r["cert"], 3, root.vkeys,
                op_hash=other.bft.expected_op_hash("upload", fields))
            hashes[name] = (want, root.srv.ledger.log_head())
            blobs[name] = blob
        assert blobs["port"] == blobs["reference"]
        assert hashes["port"] == hashes["reference"]

    def _both(self, roots, act):
        """act(root) at both roots: equal replies; returns the port's."""
        got = {name: _reply(act(root)) for name, root in roots.items()}
        assert got["port"] == got["reference"], got
        return got["port"]

    def test_forged_hash_rejected(self, roots):
        def act(root):
            w = root.wallets[0]
            root.register(w)
            blob, n, cost = _cell_op_blob(root.p)
            return root.upload(w, blob, n, cost,
                               digest=hashlib.sha256(b"not it").digest())
        ok, status, err = self._both(roots, act)
        assert not ok and status == "BAD_ARG" and "mismatch" in err

    def test_inflated_count_rejected_at_root(self, roots):
        def act(root):
            p = root.p
            root.register_all()
            w = root.wallets[0]
            blob, _, cost = _cell_op_blob(p, n_clients=1)
            part, _ = p.partial.split_cellmeta(p.ser.unpack_pytree(blob))
            blob = p.partial.partial_blob(part, 0, 1000, b"\0" * 32)
            return root.upload(w, blob, 1000, cost)
        ok, status, err = self._both(roots, act)
        assert status == "BAD_ARG" and "exceeds registered membership" in err

    def test_meta_op_weight_mismatch_rejected(self, roots):
        def act(root):
            root.register_all()
            blob, _, cost = _cell_op_blob(root.p, n_clients=2)
            return root.upload(root.wallets[0], blob, 1, cost)
        ok, status, err = self._both(roots, act)
        assert not ok and "!= op weight" in err

    def test_missing_cellmeta_rejected(self, roots):
        def act(root):
            root.register_all()
            return root.upload(root.wallets[0], _blob(root.p, _model0()),
                               2, 1.0)
        ok, status, err = self._both(roots, act)
        assert not ok and "#cellmeta" in err

    def test_forged_cell_index_rejected(self, roots):
        def act(root):
            root.register_all()
            blob, n, cost = _cell_op_blob(root.p, cell=0)
            return root.upload(root.wallets[2], blob, n, cost)
        ok, status, err = self._both(roots, act)
        assert status == "BAD_ARG" and "!= registered cell" in err

    def test_unregistered_sender_rejected(self, roots):
        def act(root):
            root.register_all()
            rogue = root.p.identity.Wallet.from_seed(b"rogue-aggregator")
            root.register(rogue)
            blob, n, cost = _cell_op_blob(root.p)
            return root.upload(rogue, blob, n, cost)
        ok, status, err = self._both(roots, act)
        assert not ok and "not a registered cell aggregator" in err

    def test_validator_refuses_inflated_count_directly(self, roots):
        def act(root):
            w = next(iter(root.wallets.values()))
            op = root.p.base.encode_upload_op(
                w.address, b"\x09" * 2 + b"\0" * 30, 1000, 1.0, 0)
            vc = root.p.bft.ValidatorClient((root.nodes[0].host,
                                             root.nodes[0].port))
            try:
                return vc.request("bft_validate", i=0, op=op.hex(),
                                  auth={"tag": "", "n": 1000, "cost": 1.0})
            finally:
                vc.close()
        ok, status, err = self._both(roots, act)
        assert not ok and status == "CELL"


def test_hier_numpy_modules_import_no_torch():
    """`hier/partial.py` and `hier/cells.py` load without torch (the
    validators import them), checked in a fresh interpreter."""
    import subprocess
    code = ("import sys; import bflc_demo_tpu_torch.hier.partial, "
            "bflc_demo_tpu_torch.hier.cells; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(
                             __import__("pathlib").Path(
                                 __file__).resolve().parents[1]))
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("leg", ["host", "mesh", "blocked"])
def test_cell_partial_on_an_engine_matches_the_reference(leg):
    """The port's partial on a CPU engine (B5's plain version on the
    mesh legs, at 1 and 3 blocks) has the reference's host-leg bytes."""
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    rng = np.random.default_rng(7)
    def flats(p):
        return [(f"0x{i:040x}", p.ser.unpack_pytree(_blob(p, {
            "a": rng_vals[i][0], "b": rng_vals[i][1]})), 5 + i, 0.5 * i)
            for i in range(3)]
    rng_vals = [(rng.standard_normal((17, 5)).astype(np.float32),
                 rng.standard_normal((9,)).astype(np.float32))
                for _ in range(3)]
    engine = MeshAggEngine("cpu")
    engine_leg = engine.weighted_sum
    got, n, cost = partial.cell_partial(
        flats(PKG["port"]), blocks=3, engine=types.SimpleNamespace(
            weighted_sum=lambda *a, **kw: engine_leg(
                *a, **dict(kw, force_leg=leg))))
    want, n2, cost2 = ref_partial.cell_partial(flats(PKG["reference"]),
                                               blocks=3)
    assert (n, cost) == (n2, cost2)
    assert ser.pack_entries(got) == ref_ser.pack_entries(want)


# ------------------------------------------------------- mixed fleets
def _mixed_round(root_name: str, cell_name: str, density: float = 1.0):
    """One scripted round of a two-cell fleet in threads: a root of
    `root_name` (its server and 4 validators holding the registry), two
    cell aggregators of `cell_name`, 3 scripted members each (signed
    registers, fixed deltas, fixed scores).  The cells register at the
    root in index order first, so the root's committee is fixed.
    Returns (root ops, model hash, certified size, cell partial blobs
    by epoch) once the root committed epoch 0 and both cells committed
    the global model locally.  With `density` < 1 the members upload
    top-k blobs and the partials cross the sparse bridge."""
    import time

    rp, cp = PKG[root_name], PKG[cell_name]
    if cell_name == "port":
        from bflc_demo_tpu_torch.hier.aggregator import CellAggregatorServer
    else:
        from bflc_demo_tpu.hier.aggregator import CellAggregatorServer
    base_cfg = dict(client_num=6, comm_count=2, aggregate_count=2,
                    needed_update_count=2, learning_rate=0.05,
                    batch_size=16, delta_density=density)
    plan = cells.plan_cells(6, cells=2)
    model0 = _blob(rp, _model0())
    rcfg = rp.cells.root_protocol(rp.Config(**base_cfg), 2)
    agg_seeds = {c: cells.cell_seed(b"hier-mixed", c) for c in range(2)}
    registry = {identity.Wallet.from_seed(s).address: (c, 3)
                for c, s in agg_seeds.items()}
    vwallets, vkeys = rp.bft.provision_validators(4, b"hier-mixed-v")
    nodes = [rp.bft.ValidatorNode(rcfg, w, i, validator_keys=vkeys,
                                  cell_registry=registry)
             for i, w in enumerate(vwallets)]
    servers = []
    try:
        for v in nodes:
            v.start()
        root = rp.ls.LedgerServer(
            rcfg, model0, cell_registry=registry, ledger_backend="python",
            stall_timeout_s=60.0, bft_validators=[(v.host, v.port)
                                                  for v in nodes],
            bft_keys=vkeys, **rp.server_kw)
        root.start()
        servers.append(root)
        probe = ls.CoordinatorClient(root.host, root.port)
        for c in range(2):
            w = identity.Wallet.from_seed(agg_seeds[c])
            assert probe.request("register", addr=w.address,
                                 pubkey=w.public_bytes.hex(),
                                 tag=_sign(PKG["port"], w, "register", 0,
                                           b""))["ok"]
        cell_srv = []
        for c in range(2):
            ccfg = cp.cells.cell_protocol(cp.Config(**base_cfg), 3)
            srv = CellAggregatorServer(
                ccfg, _blob(cp, _model0()), c,
                cp.identity.Wallet.from_seed(agg_seeds[c]),
                [(root.host, root.port)], root_bft_keys=vkeys,
                stall_timeout_s=60.0, **cp.server_kw)
            srv.start()
            servers.append(srv)
            cell_srv.append(srv)
        rng = np.random.default_rng(11)
        for c, srv in enumerate(cell_srv):
            cc = ls.CoordinatorClient(srv.host, srv.port)
            wallets = [identity.Wallet.from_seed(b"hier-member-%d" % i)
                       for i in plan.members[c]]
            for w in wallets:
                assert cc.request("register", addr=w.address,
                                  pubkey=w.public_bytes.hex(),
                                  tag=_sign(PKG["port"], w, "register", 0,
                                            b""))["ok"]
            committee = set(cc.request("committee")["committee"])
            for w in wallets:
                if w.address in committee:
                    continue
                delta = _keyed({
                    "W": rng.standard_normal((5, 2)).astype(np.float32),
                    "b": rng.standard_normal(2).astype(np.float32)})
                blob = (ser.pack_sparse(delta, density, "f32")
                        if density < 1.0 else ser.pack_entries(delta))
                digest = hashlib.sha256(blob).digest()
                payload = digest + struct.pack("<qd", 40, 0.5)
                assert cc.request(
                    "upload", addr=w.address, blob=blob, hash=digest.hex(),
                    n=40, cost=0.5, epoch=0,
                    tag=_sign(PKG["port"], w, "upload", 0, payload))["ok"]
            for w in wallets:
                if w.address in committee:
                    scores = [0.75, 0.25]
                    payload = struct.pack("<2d", *scores)
                    assert cc.request(
                        "scores", addr=w.address, epoch=0, scores=scores,
                        tag=_sign(PKG["port"], w, "scores", 0,
                                  payload))["ok"]
            cc.close()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            info = probe.request("info")
            if info["epoch"] >= 1 and \
                    info["certified_size"] == info["log_size"] and \
                    all(s.ledger.epoch >= 1 for s in cell_srv):
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(f"mixed round incomplete: {info}")
        ops = probe.request("log_range", start=0,
                            end=info["log_size"])["ops"]
        model = probe.request("model")
        probe.close()
        return ops, model["hash"], info["certified_size"], \
            [s._model_hash for s in cell_srv]
    finally:
        for s in reversed(servers):
            s.close()
        for v in nodes:
            v.close()


@pytest.fixture(scope="module")
def pure_reference_round():
    runs = {}

    def get(density):
        if density not in runs:
            runs[density] = _mixed_round("reference", "reference", density)
        return runs[density]
    return get


@pytest.mark.parametrize("root_name,cell_name,density", [
    ("port", "reference", 1.0), ("reference", "port", 1.0),
    ("port", "port", 1.0), ("port", "reference", 0.5),
    ("reference", "port", 0.5)])
def test_mixed_fleets_certify_the_same_op_stream(root_name, cell_name,
                                                 density,
                                                 pure_reference_round):
    """A reference cell aggregator under a port root with port validators,
    a port cell under a reference root with its validators, and the port
    alone, dense and over the sparse bridge: each certifies the pure
    reference run's root op stream — the same cell-partial upload ops
    (hence partial bytes), scores and commit — and every cell ends on
    the root's model."""
    ops, model_hash, certified, cell_models = _mixed_round(
        root_name, cell_name, density)
    want_ops, want_hash, want_certified, _ = pure_reference_round(density)
    assert ops == want_ops
    assert model_hash == want_hash and certified == want_certified
    assert [bytes.fromhex(o)[0] for o in ops] == [1, 1, 2, 3, 4]
    assert all(m.hex() == model_hash for m in cell_models)


def test_hier_runtime_refuses_unported_options_naming_their_items():
    from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
    cfg = constants.ProtocolConfig(client_num=4, comm_count=1,
                                   aggregate_count=1, needed_update_count=1)
    shards = [(np.zeros((4, 5), np.float32), np.zeros(4, np.int64))] * 4
    for kw, item in ((dict(chaos_schedule=object()), "A14"),
                     (dict(chaos_dir="d"), "A14"),
                     (dict(telemetry_dir="t"), "A14"),
                     (dict(trace_sample=0.5), "A14")):
        with pytest.raises(NotImplementedError, match=item):
            run_federated_hier("make_softmax_regression", shards,
                               shards[0], cfg, cells=2, device="cpu", **kw)
    with pytest.raises(TypeError):
        run_federated_hier("make_softmax_regression", shards, shards[0],
                           cfg, cells=2, device="cpu", standbys=1)
    # the rederive plane is ported (A9 item 9); a bad mode is refused
    with pytest.raises(ValueError, match="rederive"):
        run_federated_hier("make_softmax_regression", shards, shards[0],
                           cfg, cells=2, device="cpu", rederive="bogus")


def test_cell_rederive_evidence_refused_naming_item_9(monkeypatch):
    """The cell's rederive evidence is ported (A9 item 9): an armed
    aggregator builds, with the plane armed from the environment, and
    its genome runs no closed loop of its own."""
    from bflc_demo_tpu_torch.hier.aggregator import CellAggregatorServer
    monkeypatch.setenv("BFLC_REDERIVE", "shard")
    cfg = cells.cell_protocol(constants.ProtocolConfig(
        delta_density=0.1, adapt_every=2), 5)
    assert cfg.adapt_every == 0
    srv = CellAggregatorServer(cfg, _blob(PKG["port"], _model0()), 0,
                               identity.Wallet.from_seed(b"c"), [],
                               device="cpu")
    try:
        assert srv._rederive and srv._state_knobs() == {}
        srv._root_eff_density = 0.025
        assert srv._state_knobs() == {"eff_density": 0.025}
    finally:
        srv.close()


def test_hier_merge_geometries_for_the_card():
    """The B5 geometries `chip_smoke.py` times for the hier path: a
    config-5 cell's partial (3 admitted rows, all merged) and the root's
    merge of 2 partials, at config 5's P = 535,298."""
    from bflc_demo_tpu_torch.meshagg import check
    for name, n in (("config5_cell_partial", 3), ("config5_root_merge", 2)):
        g, rows, weights, selected, lr = check.geometry_case(name)
        assert len(rows) == n and rows[0].shape == (535_298,)
        assert selected == list(range(n)) and len(weights) == n
    plan = cells.plan_cells(20, cells=4)
    cell_cfg = cells.cell_protocol(constants.ProtocolConfig(
        client_num=20, comm_count=4, aggregate_count=6,
        needed_update_count=10), 5)
    root_cfg = cells.root_protocol(constants.ProtocolConfig(
        client_num=20, comm_count=4, aggregate_count=6,
        needed_update_count=10), plan.n_cells)
    assert (cell_cfg.comm_count, cell_cfg.needed_update_count,
            cell_cfg.aggregate_count) == (2, 3, 3)
    assert (root_cfg.comm_count, root_cfg.needed_update_count,
            root_cfg.aggregate_count) == (2, 2, 2)
