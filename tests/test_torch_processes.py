"""The process fleet and the threaded runtime on the CPU, against the
reference.

- Per-client training: config 1's per-client `local_train` (the step
  the fleet's clients, the host and the threaded runtimes take) against
  the reference's jitted one, every client of config 1's 20, bit for bit
  (ROADMAP C6: the per-client program divides by lr).
- The fleet (`client/process_runtime.run_federated_processes`, spawned
  processes, device "cpu") at the reference process test's protocol (6
  clients, committee 2, 3 admitted, top-2, lr 0.05, batch 16, 250-row
  occupancy shards): 4 rounds above 0.85 with 2 replicas (the card runs
  the reference's 3), each at the writer's head, and no child loaded JAX
  or the reference package.
- The crash case of the reference's process test: clients 0 and 5 die
  at epoch 1 and the writer's recovery ops carry the rounds;
  `recovered_clients == [0, 5]`.
- Port client processes against a writer in this process — the port's
  and the reference's `LedgerServer` — for 2 rounds: every committed
  model equals the reference's `_aggregate_flat` over the admitted blobs
  byte for byte, and the children never loaded JAX or the reference.
- The threaded runtime (the reference's tests/test_aux.py threaded
  cases): rounds complete, the chain verifies, and each crash case
  triggers the recovery it must (any recovery, force_aggregate, reseat).
  Thread scheduling makes the decisions racy, so these hold invariants.
Each spawning test passes a `timeout_s`, so a hang fails it.
"""

import importlib
import multiprocessing as mp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.comm import ledger_service as ref_ls
from bflc_demo_tpu.core import local_train as ref_local_train
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref_ser
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.client.threaded import ThreadedFederation
from bflc_demo_tpu_torch.comm import ledger_service
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import pack_pytree

core_lt = importlib.import_module("bflc_demo_tpu_torch.core.local_train")


@pytest.fixture(scope="module", autouse=True)
def _worker_share_of_threads():
    """This process's torch threads (the threaded runtime, the sponsor,
    the in-thread writers) at its test worker's share of the cores: with
    every core in every worker, concurrent tests starve (each spawned
    client runs one thread itself)."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
CFG = ProtocolConfig(**PROTO)


def _occupancy_shards(n_clients, per_shard=250):
    xtr, ytr, xte, yte = load_occupancy()
    return (iid_shards(xtr[: n_clients * per_shard],
                       ytr[: n_clients * per_shard], n_clients),
            (xte[:500], yte[:500]))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_config1_per_client_training_is_the_references():
    xtr, ytr, _, _ = load_occupancy()
    rng = np.random.default_rng(2)
    params = {"W": (rng.standard_normal((5, 2)) * 0.01).astype(np.float32),
              "b": (rng.standard_normal(2) * 0.01).astype(np.float32)}
    ref, model = ref_softmax(), make_softmax_regression()
    for x, y in iid_shards(xtr, ytr, 20):
        yo = one_hot(y, 2)
        want_d, want_c = ref_local_train(
            ref.apply, params, jnp.asarray(x), jnp.asarray(yo), lr=0.001,
            batch_size=100, local_epochs=1)
        got_d, got_c = core_lt.local_train(
            model, model.params_from_jax(params), torch.as_tensor(x),
            torch.as_tensor(yo), lr=0.001, batch_size=100)
        np.testing.assert_array_equal(_bits(got_d["['W']"]),
                                      _bits(want_d["W"]))
        np.testing.assert_array_equal(_bits(got_d["['b']"]),
                                      _bits(want_d["b"]))
        assert _bits(got_c) == _bits(want_c)


def _no_foreign(res):
    assert res.child_foreign_modules, "no child reported"
    for role, mods in res.child_foreign_modules.items():
        assert mods == [], (role, mods)


def test_fleet_converges_with_replicas_at_the_writer_head():
    shards, test_set = _occupancy_shards(CFG.client_num)
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, test_set, CFG, rounds=4,
        stall_timeout_s=20.0, timeout_s=150.0, replicas=2, device="cpu")
    assert res.rounds_completed >= 4
    assert res.best_accuracy() > 0.85, res.accuracy_history
    assert len(res.replica_reports) == 2
    for rep in res.replica_reports:
        assert rep["ok"] and rep["head"] == res.ledger_log_head
        assert rep["size"] == res.ledger_log_size
    assert res.replica_report["epoch"] == 4
    assert [e for e, _ in res.epoch_times] == \
        [e for e, _ in res.accuracy_history]
    assert 0 < res.spawn_s <= res.epoch_times[-1][1]
    assert res.writer_engine["calls"]["host"] >= 4    # below the min batch
    assert set(res.kernel_launches) >= {"writer", "sponsor", "client-0"}
    _no_foreign(res)


def test_fleet_recovers_from_crashed_clients():
    shards, test_set = _occupancy_shards(CFG.client_num)
    res = pr.run_federated_processes(
        "make_softmax_regression", shards, test_set, CFG, rounds=3,
        crash_at={0: 1, 5: 1}, stall_timeout_s=4.0, timeout_s=150.0,
        device="cpu")
    assert res.rounds_completed >= 3
    assert sorted(res.recovered_clients) == [0, 5]
    assert res.replica_report["ok"]
    assert res.replica_report["head"] == res.ledger_log_head


def _spy_merges(srv, merges):
    """Record each merge's inputs and the committed model blob."""
    inner = srv._aggregate_and_commit

    def spied(*args, **kw):
        pending = srv.ledger.pending()
        updates = srv.ledger.query_all_updates()
        merges.append({"global": srv._model_blob,
                       "blobs": [srv._blobs[u.payload_hash]
                                 for u in updates],
                       "weights": [u.n_samples for u in updates],
                       "selected": list(pending.selected)})
        inner(*args, **kw)
        merges[-1]["new"] = srv._model_blob
    srv._aggregate_and_commit = spied


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_port_clients_against_each_writer(writer):
    shards, _ = _occupancy_shards(CFG.client_num)
    init = pack_pytree(make_softmax_regression().init_params(0))
    if writer == "port":
        srv = ledger_service.LedgerServer(CFG, init, stall_timeout_s=20.0,
                                          device="cpu")
    else:
        srv = ref_ls.LedgerServer(RefConfig(**PROTO), init,
                                  stall_timeout_s=20.0,
                                  ledger_backend="python")
    merges = []
    _spy_merges(srv, merges)
    srv.start()
    ctx = mp.get_context("spawn")
    report_q = ctx.Queue()
    cfg_kw = dict(vars(CFG))
    procs = [ctx.Process(target=pr._client_proc, args=pr.client_args(
        [(srv.host, srv.port)], b"mixed-fleet-master-01", i,
        "make_softmax_regression", {}, sx, sy, 2, cfg_kw, 2, None, "cpu",
        report_q), daemon=True) for i, (sx, sy) in enumerate(shards)]
    try:
        for p in procs:
            p.start()
        reports = [report_q.get(timeout=150) for _ in procs]
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        srv.close()
    assert srv.ledger.epoch == 2 and len(merges) == 2
    for m in merges:
        want = ref_ls._aggregate_flat(
            ref_ser.unpack_pytree(m["global"]),
            [ref_ser.unpack_pytree(b) for b in m["blobs"]], m["weights"],
            m["selected"], PROTO["learning_rate"])
        assert ref_ser.pack_entries(want) == m["new"]
    for rep in reports:
        assert rep["foreign_modules"] == [], rep


SMALL = ProtocolConfig(client_num=8, comm_count=2, aggregate_count=2,
                       needed_update_count=3, learning_rate=0.001,
                       batch_size=50, local_epochs=1)


@pytest.fixture(scope="module")
def small_data():
    xtr, ytr, xte, yte = load_occupancy()
    return iid_shards(xtr[:2000], ytr[:2000], SMALL.client_num), \
        (xte[:500], yte[:500])


def _threaded(small_data, **kw):
    shards, test_set = small_data
    return ThreadedFederation(make_softmax_regression(), shards, test_set,
                              SMALL, device="cpu", **kw)


def test_threaded_clean_concurrent_run(small_data):
    fed = _threaded(small_data, stall_timeout_s=3.0)
    res = fed.run(rounds=3, timeout_s=120)
    assert res.rounds_completed == 3
    assert res.ledger.verify_log()
    epochs = [e for e, _ in res.loss_history]
    assert epochs == sorted(set(epochs))
    assert [e for e, _ in res.accuracy_history] == epochs


def test_threaded_trainer_crashes_recovered(small_data):
    fed = _threaded(small_data, crash_at={i: 1 for i in range(2, 7)},
                    stall_timeout_s=0.75)
    res = fed.run(rounds=3, timeout_s=180)
    assert res.rounds_completed == 3
    assert fed.recoveries, "expected at least one recovery action"
    assert res.ledger.verify_log()


def test_threaded_committee_crash_recovered(small_data):
    fed = _threaded(small_data, crash_at={1: 0}, stall_timeout_s=0.75)
    res = fed.run(rounds=2, timeout_s=180)
    assert res.rounds_completed == 2
    assert any(r.startswith("force_aggregate") for r in fed.recoveries), \
        fed.recoveries


def test_threaded_whole_committee_dead_reseated(small_data):
    fed = _threaded(small_data, crash_at={0: 0, 1: 0}, stall_timeout_s=0.75)
    res = fed.run(rounds=2, timeout_s=180)
    assert res.rounds_completed == 2
    assert any(r.startswith("reseat") for r in fed.recoveries), \
        fed.recoveries
    assert res.ledger.verify_log()


def test_unported_fleet_options_raise_naming_the_item():
    shards, test_set = _occupancy_shards(CFG.client_num)
    for kw in (dict(telemetry_dir="t"), dict(chaos_dir="d"),
               dict(trace_sample=0.5), dict(chaos_seed=7)):
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            pr.run_federated_processes("make_softmax_regression", shards,
                                       test_set, CFG, device="cpu", **kw)
    # the rederive plane is ported (A9 item 9): a mode it lacks raises
    with pytest.raises(ValueError, match="rederive"):
        pr.run_federated_processes("make_softmax_regression", shards,
                                   test_set, CFG, device="cpu",
                                   rederive="bogus")
    with pytest.raises(ValueError, match="shards"):
        pr.run_federated_processes("make_softmax_regression", shards[:3],
                                   test_set, CFG, device="cpu")
