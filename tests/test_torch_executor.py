"""The mesh executor, its score attestation and the candidates it exposes,
against the JAX package's, on the CPU.

Same seeded numpy inputs through both packages:
- `make_sharded_protocol_round(..., expose_candidates=True)`: the K
  uploaded deltas in ascending uploader id, bit for bit at config 1
  (the reference on a one-device mesh, as C2's tests run it) and within
  1e-6 at a narrow config 5 (float32 training in another order; 7.5e-8
  measured);
- the mesh runtime's `attest_log` at config 1: the reference's, signature
  for signature (Ed25519 is deterministic and the rows are the
  reference's bit for bit); the `None`/`True`/wallet-count rules raise
  or resolve as the reference's do;
- the reference's three in-thread scenarios (tests/test_mesh_executor.py:
  stage validation, the attested round, the tampered row that aborts)
  against both packages' executors;
- both packages' executors, with the same wallets and config-1 shards,
  over 2 attested rounds: the same op bytes, chain head and attestation
  signatures;
- mixed attestation: each package's `attest_score_row` signs against the
  other's executor; C18: the reference's thin client, reading the
  evidence through its `ReadRouter`, never attests;
- one CPU fleet over TLS (the reference test's CFG, 3 rounds) and the
  CLI: the rc 0 run and the rc 2 guards of both packages.
"""

import hashlib
import json
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu import __main__ as ref_main
from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.client import process_runtime as ref_process_runtime
from bflc_demo_tpu.comm import dataplane as ref_dataplane
from bflc_demo_tpu.comm import executor_service as ref_executor_service
from bflc_demo_tpu.comm import identity as ref_identity
from bflc_demo_tpu.comm import ledger_service as ref_ledger_service
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.parallel.fedavg import make_sharded_protocol_round \
    as ref_round
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref_serialization
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import mesh_runtime, process_runtime, staging
from bflc_demo_tpu_torch.comm import dataplane, executor_service, identity
from bflc_demo_tpu_torch.comm import ledger_service
from bflc_demo_tpu_torch.data import load_occupancy
from bflc_demo_tpu_torch.data.partition import iid_shards
from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.ops import fingerprint as fp
from bflc_demo_tpu_torch.parallel.fedavg import make_sharded_protocol_round
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import serialization

# tests/test_mesh_executor.py:17-19
CFG = dict(client_num=6, comm_count=2, aggregate_count=2,
           needed_update_count=3, learning_rate=0.05, batch_size=16)
SEED = b"attest-master-0001"
TRANSFORMER = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16,
                   depth=1, heads=2)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------ expose_candidates
def _config1_round_inputs():
    xtr, ytr, _, _ = load_occupancy()
    shards = iid_shards(xtr, ytr, 20)
    xs, ys, ns = staging.stage_padded_arrays(
        [a for a, _ in shards], [b for _, b in shards], 2)
    committee = np.zeros(20, bool)
    committee[[2, 7, 11, 19]] = True
    uploaders = np.zeros(20, bool)
    uploaders[[0, 1, 3, 5, 8, 9, 12, 14, 16, 18]] = True
    return xs, ys, ns, uploaders, committee


def _narrow_config5_inputs():
    rng = np.random.default_rng(1)
    x = rng.integers(1, 64, (130, 16)).astype(np.int32)
    x[::3, 11:] = 0
    y = (x[:, 0] > 31).astype(np.int32)
    cuts = np.cumsum([20, 24, 17, 24, 22])
    shards = list(zip(np.split(x[:129], cuts), np.split(y[:129], cuts)))
    xs, ys, ns = staging.stage_padded_arrays(
        [a for a, _ in shards], [b for _, b in shards], 2)
    return (xs, ys, ns, np.array([1, 0, 1, 0, 1, 0], bool),
            np.array([0, 1, 0, 0, 0, 1], bool))


@pytest.mark.parametrize("name", ["config1", "narrow_config5"])
def test_cand_deltas_match_reference(name):
    if name == "config1":
        ref_model, model = ref_softmax(), make_softmax_regression()
        xs, ys, ns, up, comm = _config1_round_inputs()
        geometry = dict(client_num=20, comm_count=4, aggregate_count=6,
                        needed_update_count=10, batch_size=100)
        lr, atol = 0.001, 0.0                 # bit for bit
    else:
        ref_model = ref_transformer(attention_impl="einsum", **TRANSFORMER)
        model = make_transformer_classifier(**TRANSFORMER)
        xs, ys, ns, up, comm = _narrow_config5_inputs()
        geometry = dict(client_num=6, comm_count=2, aggregate_count=2,
                        needed_update_count=3, batch_size=8)
        lr, atol = 0.05, 1e-6
    params = ref_model.init_params(0)
    want = ref_round(client_axis_mesh(1), ref_model.apply, lr=lr,
                     local_epochs=1, expose_candidates=True, **geometry)(
        params, jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(ns, jnp.int32), jnp.asarray(up), jnp.asarray(comm))
    xt = torch.as_tensor(xs).long() if xs.dtype == np.int32 \
        else torch.as_tensor(xs)
    got = make_sharded_protocol_round(
        model, lr=lr, local_epochs=1, expose_candidates=True, **geometry)(
        model.params_from_jax(params), xt, torch.as_tensor(ys),
        torch.as_tensor(ns.astype(np.int32)), up, comm)
    want_c = _keyed(want.cand_deltas)
    assert set(want_c) == set(got.cand_deltas)
    k = geometry["needed_update_count"]
    for key, v in want_c.items():
        g = got.cand_deltas[key].numpy()
        assert g.shape == v.shape and g.shape[0] == k
        if atol:
            np.testing.assert_allclose(g, v, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(v), err_msg=key)
    # ascending uploader id: candidate j is uploader j's delta, whose id
    # the round recorded
    for j, uid in enumerate(np.flatnonzero(up)):
        one = {key: v[j] for key, v in got.cand_deltas.items()}
        assert fp.fingerprint_to_bytes(fp.fingerprint_pytree(one)) == \
            fp.fingerprint_to_bytes(got.delta_fps[uid])
    # the plain round exposes nothing
    plain = make_sharded_protocol_round(model, lr=lr, local_epochs=1,
                                        **geometry)(
        model.params_from_jax(params), xt, torch.as_tensor(ys),
        torch.as_tensor(ns.astype(np.int32)), up, comm)
    assert plain.cand_deltas == ()


# -------------------------------------------- the mesh runtime's attestation
def test_mesh_attest_log_matches_reference_at_config1():
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr, ytr, 20)
    ref_wallets, _ = ref_identity.provision_wallets(20, SEED)
    wallets, _ = identity.provision_wallets(20, SEED)
    want = ref_mesh_runtime.run_federated_mesh(
        ref_softmax(), shards, (xte, yte), RefConfig(), rounds=2,
        mesh=client_axis_mesh(1), attest_wallets=ref_wallets,
        ledger_backend="python")
    got = mesh_runtime.run_federated_mesh(
        make_softmax_regression(), shards, (xte, yte), ProtocolConfig(),
        rounds=2, attest_wallets=wallets, device="cpu")
    assert len(got.attest_log) == 2
    assert all(len(sigs) == 4 for sigs in got.attest_log.values())
    assert got.attest_log == want.attest_log
    assert got.ledger.log_head() == want.ledger.log_head()


def _tiny_mesh(package: str, **kw):
    x, y = np.random.default_rng(3).standard_normal((60, 5)).astype(
        np.float32), np.arange(60) % 2
    shards = iid_shards(x, y, 6)
    if package == "port":
        return mesh_runtime.run_federated_mesh(
            make_softmax_regression(), shards, (x, y),
            ProtocolConfig(**dict(CFG, batch_size=5)), rounds=1,
            device="cpu", **kw)
    return ref_mesh_runtime.run_federated_mesh(
        ref_softmax(), shards, (x, y), RefConfig(**dict(CFG, batch_size=5)),
        rounds=1, mesh=client_axis_mesh(1), ledger_backend="python", **kw)


@pytest.mark.parametrize("case", ["true_without_wallets", "wallet_count",
                                  "false_with_wallets", "none_with_wallets"])
def test_mesh_attestation_resolution_rules_match_reference(case):
    ref_w, _ = ref_identity.provision_wallets(6, SEED)
    port_w, _ = identity.provision_wallets(6, SEED)
    kw = {"true_without_wallets": lambda w: dict(attest_scores=True),
          "wallet_count": lambda w: dict(attest_wallets=w[:3]),
          "false_with_wallets": lambda w: dict(attest_scores=False,
                                               attest_wallets=w),
          "none_with_wallets": lambda w: dict(attest_wallets=w)}[case]
    if case in ("true_without_wallets", "wallet_count"):
        match = "needs wallets" if case == "true_without_wallets" \
            else "attest wallets"
        for package, w in (("reference", ref_w), ("port", port_w)):
            with pytest.raises(ValueError, match=match):
                _tiny_mesh(package, **kw(w))
        return
    want = _tiny_mesh("reference", **kw(ref_w)).attest_log
    got = _tiny_mesh("port", **kw(port_w)).attest_log
    assert got == want
    assert (got is None) == (case == "false_with_wallets")


# ------------------------------------------------- in-thread executors
PACKAGES = {
    "port": dict(server=executor_service.MeshExecutorServer,
                 client=ledger_service.CoordinatorClient,
                 router=dataplane.ReadRouter,
                 wallets=identity.provision_wallets,
                 op_bytes=identity._op_bytes,
                 pack=serialization.pack_entries,
                 attest=process_runtime.attest_score_row,
                 model=lambda: make_softmax_regression(),
                 template=lambda m: m.init_params(0, "cpu"),
                 config=ProtocolConfig, server_kw=dict(device="cpu")),
    "reference": dict(server=ref_executor_service.MeshExecutorServer,
                      client=ref_ledger_service.CoordinatorClient,
                      router=ref_dataplane.ReadRouter,
                      wallets=ref_identity.provision_wallets,
                      op_bytes=ref_identity._op_bytes,
                      pack=ref_serialization.pack_entries,
                      attest=ref_process_runtime.attest_score_row,
                      model=lambda: ref_softmax(),
                      template=lambda m: m.init_params(0),
                      config=RefConfig,
                      server_kw=dict(ledger_backend="python")),
}


def _tampering(base):
    class TamperingExecutor(base):
        def _collect_attestations(self, epoch, addrs, uploader_ids,
                                  committee_ids, delta_fps, score_rows,
                                  cand_deltas, s_pad):
            rows = np.array(score_rows, copy=True)
            rows[committee_ids[0], uploader_ids[0]] += 0.25
            super()._collect_attestations(
                epoch, addrs, uploader_ids, committee_ids, delta_fps, rows,
                cand_deltas, s_pad)
    return TamperingExecutor


def _random_shards(wallets):
    """The reference test's ragged seeded shards, by address."""
    rng = np.random.default_rng(7)
    out = {}
    for i, w in enumerate(wallets):
        size = 40 if i == 0 else 32
        out[w.address] = (rng.standard_normal((size, 5)).astype(np.float32),
                          rng.integers(0, 2, (size,)).astype(np.int32))
    return out


def _staged(pkg: dict, cfg: dict, shards_of=_random_shards, cls=None,
            rounds: int = 1, timeout_s: float = 30.0, **server_kw):
    """An attesting executor of `pkg` started in threads, every wallet
    registered and its shard staged: (server, client, wallets, shards)."""
    wallets, directory = pkg["wallets"](cfg["client_num"], SEED)
    srv = (cls or pkg["server"])(
        pkg["config"](**cfg), "make_softmax_regression", rounds=rounds,
        attest_scores=True, attest_timeout_s=timeout_s,
        directory=directory, stall_timeout_s=600.0,
        **dict(pkg["server_kw"], **server_kw))
    srv.start()
    shards = shards_of(wallets)
    c = pkg["client"](srv.host, srv.port, timeout_s=30.0)
    for w in wallets:
        r = c.request("register", addr=w.address,
                      pubkey=w.public_bytes.hex(),
                      tag=w.sign(pkg["op_bytes"]("register", w.address, 0,
                                                 b"")).hex())
        assert r["ok"], r
    for w in wallets:
        x, y = shards[w.address]
        xb, yb = pkg["pack"]({"x": x}), pkg["pack"]({"y": y})
        payload = hashlib.sha256(xb).digest() + hashlib.sha256(yb).digest()
        r = c.request("stage", addr=w.address, x=xb.hex(), y=yb.hex(),
                      tag=w.sign(pkg["op_bytes"]("stage", w.address, 0,
                                                 payload)).hex())
        assert r["ok"], r
    return srv, c, wallets, shards


def _attest_rounds(c, signer: dict, cfg: dict, wallets, shards, rounds,
                   deadline_s: float = 90.0, router=None):
    """`signer`'s attest_score_row for every pending row until `rounds`
    rounds are done or the executor failed: (attested, refusals)."""
    model = signer["model"]()
    template = signer["template"](model)
    attested, refusals = 0, []
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        pr = c.request("progress")
        if pr.get("error") or pr["rounds_done"] >= rounds:
            break
        for w in wallets:
            pa = c.request("round_pending", addr=w.address)
            if pa.get("epoch") is None:
                continue
            x, y = shards[w.address]
            try:
                attested += bool(signer["attest"](
                    c, w, model, template, signer["config"](**cfg), x, y,
                    pa, router=router))
            except RuntimeError as exc:
                refusals.append(str(exc))
        time.sleep(0.05)
    return attested, refusals


@pytest.mark.parametrize("package", list(PACKAGES))
def test_stage_validation(package):
    """Unsigned or malformed staging is refused at the boundary."""
    pkg = PACKAGES[package]
    srv = pkg["server"](pkg["config"](**CFG), "make_softmax_regression",
                        rounds=1, require_auth=False, stall_timeout_s=600.0,
                        **pkg["server_kw"])
    srv.start()
    try:
        c = pkg["client"](srv.host, srv.port)
        addr = "0x" + "0" * 40
        xb = pkg["pack"]({"x": np.zeros((10, 5), np.float32)})
        r = c.request("stage", addr=addr, x=xb.hex(),
                      y=pkg["pack"]({"y": np.zeros((9,), np.int32)}).hex())
        assert not r["ok"] and r["status"] == "BAD_ARG"
        r = c.request("stage", addr=addr, x="zz", y="zz")
        assert not r["ok"]
        r = c.request("stage", addr=addr, x=xb.hex(),
                      y=pkg["pack"]({"y": np.zeros((10,), np.int32)}).hex())
        assert r["ok"] and r["staged"] == 1
        assert c.request("progress")["rounds_done"] == 0
        c.close()
    finally:
        srv.close()


@pytest.mark.parametrize("package", list(PACKAGES))
def test_attested_round_commits_and_logs_signatures(package):
    pkg = PACKAGES[package]
    srv, c, wallets, shards = _staged(pkg, CFG)
    try:
        attested, refusals = _attest_rounds(c, pkg, CFG, wallets, shards, 1)
        assert refusals == []
        assert c.request("progress")["rounds_done"] == 1
        assert attested == CFG["comm_count"]
        assert len(srv.attest_log[0]) == CFG["comm_count"]
    finally:
        c.close()
        srv.close()


@pytest.mark.parametrize("package", list(PACKAGES))
def test_tampered_row_refused_and_round_aborts(package):
    """The executor perturbs one committee row after computing it: that
    member's recomputation disagrees, it refuses to sign, and the round
    never reaches the ledger."""
    pkg = PACKAGES[package]
    srv, c, wallets, shards = _staged(pkg, CFG,
                                      cls=_tampering(pkg["server"]),
                                      timeout_s=4.0)
    try:
        _, refusals = _attest_rounds(c, pkg, CFG, wallets, shards, 1,
                                     deadline_s=45.0)
        err = c.request("progress").get("error") or ""
        assert "did not attest" in err, err
        assert refusals and all("does not match" in r for r in refusals)
        assert c.request("progress")["rounds_done"] == 0
        assert c.request("info")["epoch"] == 0      # nothing committed
    finally:
        c.close()
        srv.close()


def _config1_shards(wallets):
    xtr, ytr, _, _ = load_occupancy()
    return {w.address: s for w, s in zip(wallets, iid_shards(xtr, ytr, 20))}


def test_two_attested_rounds_match_reference_ops_and_head():
    """Config 1 through both executors (the reference's on a one-device
    mesh), the same wallets and shards, each attested by its own
    package's members: the same op bytes, chain head and signatures."""
    cfg = dict(client_num=20, comm_count=4, aggregate_count=6,
               needed_update_count=10, learning_rate=0.001, batch_size=100)
    logs = {}
    for package, extra in (("port", {}),
                           ("reference", dict(mesh=client_axis_mesh(1)))):
        pkg = PACKAGES[package]
        srv, c, wallets, shards = _staged(pkg, cfg, _config1_shards,
                                          rounds=2, **extra)
        try:
            attested, refusals = _attest_rounds(c, pkg, cfg, wallets,
                                                shards, 2)
            assert refusals == [] and attested == 2 * cfg["comm_count"]
            assert c.request("progress")["rounds_done"] == 2
            led = srv.ledger
            logs[package] = ([led.log_op(i) for i in range(led.log_size())],
                             led.log_head(), srv.attest_log)
        finally:
            c.close()
            srv.close()
    assert len(logs["port"][0]) == 20 + 2 * 15
    assert logs["port"] == logs["reference"]


@pytest.mark.parametrize("signer,executor", [("port", "reference"),
                                             ("reference", "port")])
def test_mixed_attestation_signs_against_the_other_package(signer,
                                                           executor):
    srv, c, wallets, shards = _staged(PACKAGES[executor], CFG)
    try:
        attested, refusals = _attest_rounds(c, PACKAGES[signer], CFG,
                                            wallets, shards, 1)
        assert refusals == [] and attested == CFG["comm_count"]
        assert c.request("progress")["rounds_done"] == 1
        assert len(srv.attest_log[0]) == CFG["comm_count"]
    finally:
        c.close()
        srv.close()


def test_c18_router_fetch_of_fingerprint_keyed_evidence():
    """C18: the executor keys the evidence by payload fingerprints, and
    the reference's `ReadRouter` checks every blob against SHA-256, so
    its thin client (which reads through one) never attests and the round
    aborts; the port's reads the evidence by its manifest and attests,
    against either package's executor."""
    ref = PACKAGES["reference"]
    srv, c, wallets, shards = _staged(ref, CFG, timeout_s=3.0)
    try:
        attested, _ = _attest_rounds(c, ref, CFG, wallets, shards, 1,
                                     deadline_s=20.0,
                                     router=ref["router"](c))
        assert attested == 0
        assert "did not attest" in (c.request("progress").get("error")
                                    or "")
    finally:
        c.close()
        srv.close()
    port = PACKAGES["port"]
    for executor in ("port", "reference"):
        srv, c, wallets, shards = _staged(PACKAGES[executor], CFG)
        try:
            attested, refusals = _attest_rounds(
                c, port, CFG, wallets, shards, 1,
                router=port["router"](c))
            assert refusals == [] and attested == CFG["comm_count"]
            assert c.request("progress")["rounds_done"] == 1
        finally:
            c.close()
            srv.close()


# --------------------------------------------------------- the fleet
def test_mesh_executor_fleet_over_tls_on_the_cpu(tmp_path):
    """The reference's TLS test (tests/test_mesh_executor.py:172-192) on
    the port: thin client processes stage over TLS and attest every
    round; the ledger audited every round; nothing outlives the run."""
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:1500], ytr[:1500], CFG["client_num"])
    res = process_runtime.run_federated_mesh_processes(
        "make_softmax_regression", shards, (xte[:500], yte[:500]),
        ProtocolConfig(**CFG), rounds=3, n_virtual_devices=3,
        timeout_s=420.0, tls_dir=str(tmp_path / "certs"), device="cpu")
    assert res.rounds_completed >= 3
    assert res.best_accuracy() > 0.80, res.accuracy_history
    assert res.ledger_log_size == CFG["client_num"] + 3 * (
        CFG["needed_update_count"] + CFG["comm_count"] + 1)
    assert sum(c["attested"] for c in res.client_counts.values()) == \
        3 * CFG["comm_count"]
    assert res.executor["rounds_done"] == 3
    assert set(res.kernel_launches) == {"executor", "sponsor"} | {
        f"thin-{i}" for i in range(CFG["client_num"])}
    assert res.client_exitcodes == [0] * CFG["client_num"]
    assert multiprocessing.active_children() == []
    assert all(m == [] for m in res.child_foreign_modules.values())


# ------------------------------------------------------------ the CLI
def test_cli_runs_config1_on_the_executor(capsys):
    assert cli(["--config", "config1", "--runtime", "executor", "--rounds",
                "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rounds"] == 2 and out["ledger_log_size"] == 20 + 2 * 15
    assert sum(c["attested"] for c in
               out["executor"]["client_counts"].values()) == 2 * 4


@pytest.mark.parametrize("argv", [
    ["--runtime", "processes", "--attest-scores"],
    ["--runtime", "processes", "--no-attest-scores"],
    ["--runtime", "host", "--attest-scores"],
    ["--attest-scores"],                      # mesh: no wallets
    ["--runtime", "executor", "--standbys", "1"],
    ["--runtime", "executor", "--bft-validators", "4"],
    ["--runtime", "executor", "--snapshot-interval", "2"],
    ["--runtime", "executor", "--rederive", "shard"],
    ["--runtime", "executor", "--error-feedback"],
    ["--runtime", "host", "--tls-dir", "certs"],
])
def test_cli_guards_exit_2_as_the_reference(argv, capsys, monkeypatch):
    monkeypatch.setenv("BFLC_COMPILE_CACHE", "0")   # no cache under HOME
    assert ref_main.main(argv) == 2
    assert cli(argv + ["--device", "cpu"]) == 2
